"""DistMatrix: the 2D block-cyclic tile-stack matrix on a virtual mesh.

Counterpart of ``slate_tpu/parallel/dist.py``.  The global (m, n) matrix is
cut into nb x nb tiles; tile (i, j) belongs to grid position (i % p, j % q).
The tiles are one tensor of shape ``(mt, nt, nb, nb)`` in *cyclic order*
(``core.tiling.to_cyclic``), exactly ``slate_tpu``'s storage, where
``PartitionSpec('p', 'q')`` then hands mesh device (r, c) the contiguous
block ``tiles[r*mtl:(r+1)*mtl, c*ntl:(c+1)*ntl]``.

On one card that block structure is a *view*: :func:`local_view` reads the
stack as ``(p, q, mtl, ntl, nb, nb)`` -- device (r, c)'s local stack at
``[r, c]`` -- without copying (at n = 32768 one f32 copy is 4.3 GB).  The
mesh drivers update that view in place and the kernels take its strides.

Tile-grid padding as in ``slate_tpu``: mt and nt round up to multiples of
lcm(p, q), pad tiles are zero, and ``diag_pad_one`` puts ones on the padded
diagonal so that the factorizations act as the identity there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ..core.grid import num_tiles
from ..core.tiling import to_cyclic, to_tiles
from .mesh import VirtualMesh, mesh_shape


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclass(frozen=True)
class DistMatrix:
    """Block-cyclic distributed matrix: cyclic-ordered tile stack + metadata."""

    tiles: torch.Tensor  # (mt, nt, nb, nb) in cyclic storage order
    m: int
    n: int
    nb: int
    mesh: VirtualMesh
    diag_pad: bool = False  # True if the padded diagonal is identity (or no pad)

    @property
    def mt(self) -> int:
        return self.tiles.shape[0]

    @property
    def nt(self) -> int:
        return self.tiles.shape[1]

    @property
    def grid(self):
        return mesh_shape(self.mesh)

    @property
    def dtype(self):
        return self.tiles.dtype

    def require_diag_pad(self, who: str) -> None:
        """Factorization/solve drivers call this: a zero pad diagonal would
        NaN-poison their triangular solves."""
        if not self.diag_pad:
            raise ValueError(
                f"{who} needs an identity-padded diagonal; build the operand "
                "with from_dense(..., diag_pad_one=True)"
            )


def local_view(tiles: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """The cyclic stack as the virtual mesh's local stacks: a
    ``(p, q, mtl, ntl, nb, nb)`` view (no copy) whose ``[r, c]`` is mesh
    device (r, c)'s ``(mtl, ntl, nb, nb)`` shard."""
    mt, nt, nb, nb2 = tiles.shape
    return tiles.view(p, mt // p, q, nt // q, nb, nb2).permute(0, 2, 1, 3, 4, 5)


def padded_tiles(extent: int, nb: int, mesh: VirtualMesh) -> int:
    """Tile count along one dim after rounding up to the mesh lcm."""
    p, q = mesh_shape(mesh)
    return _round_up(max(1, num_tiles(extent, nb)), math.lcm(p, q))


def from_dense(
    a: torch.Tensor, mesh: VirtualMesh, nb: int, diag_pad_one: bool = False
) -> DistMatrix:
    """Distribute a dense (m, n) matrix over ``mesh`` block-cyclically: one
    padded copy (when the tile grid needs pad) and one permuted copy onto
    ``mesh.device``.  The caller's ``a`` is not modified."""
    a = torch.as_tensor(a, device=mesh.device)
    m, n = a.shape
    mt = padded_tiles(m, nb, mesh)
    nt = padded_tiles(n, nb, mesh)
    mp, np_ = mt * nb, nt * nb
    if (mp, np_) != (m, n):
        a = torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))
        if diag_pad_one:
            d = torch.arange(min(m, n), min(mp, np_), device=a.device)
            a[d, d] = 1
    t = to_cyclic(to_tiles(a, nb), *mesh_shape(mesh))
    if t.untyped_storage().data_ptr() == a.untyped_storage().data_ptr():
        t = t.clone()  # a 1 x 1 grid's reorder is a view: never alias the caller's a
    no_pad = mp == m and np_ == n
    return DistMatrix(tiles=t, m=m, n=n, nb=nb, mesh=mesh, diag_pad=diag_pad_one or no_pad)


def to_dense(d: DistMatrix) -> torch.Tensor:
    """Gather back to a logically-ordered dense (m, n) tensor (one copy:
    the cyclic stack viewed as ``(mtl, p, nb, ntl, q, nb)`` is the dense
    matrix)."""
    p, q = mesh_shape(d.mesh)
    mt, nt, nb, _ = d.tiles.shape
    dense = (d.tiles.view(p, mt // p, q, nt // q, nb, nb)
             .permute(1, 0, 4, 3, 2, 5).reshape(mt * nb, nt * nb))
    return dense[:d.m, :d.n]


def empty_like(d: DistMatrix, m: Optional[int] = None, n: Optional[int] = None) -> DistMatrix:
    """A zero DistMatrix of d's layout (and of shape (m, n) if given)."""
    m = d.m if m is None else m
    n = d.n if n is None else n
    mt = padded_tiles(m, d.nb, d.mesh)
    nt = padded_tiles(n, d.nb, d.mesh)
    t = torch.zeros((mt, nt, d.nb, d.nb), dtype=d.dtype, device=d.tiles.device)
    return DistMatrix(tiles=t, m=m, n=n, nb=d.nb, mesh=d.mesh)
