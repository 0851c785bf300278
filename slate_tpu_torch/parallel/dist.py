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

import numpy as np
import torch

from ..core.grid import num_tiles
from ..core.tiling import cyclic_perm, from_cyclic, from_tiles, inv_perm, to_cyclic, to_tiles
from .mesh import COL_AXIS, ROW_AXIS, VirtualMesh, mesh_shape


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


# ---------------------------------------------------------------------------
# Non-uniform block sizes (func.hh:39-203; the reference's ex13)
# ---------------------------------------------------------------------------


def _cut(sizes, ntiles: int, grid: int):
    """A dim cut into ``sizes`` and padded to ``ntiles`` tiles, cyclic over
    ``grid``: (each size's first global index, the logical tile in each
    storage slot)."""
    return (np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
            cyclic_perm(ntiles, grid).astype(np.int64))


def _slot_sources(sizes, ntiles: int, nb: int, grid: int):
    """The global index each (storage slot, in-tile index) pair of the
    ``nb``-square embedding reads, (ntiles, nb), clamped into the dim, and
    where that pair holds data."""
    off, perm = _cut(sizes, ntiles, grid)
    k = len(sizes)
    tile = np.minimum(perm, k - 1)[:, None]
    size = np.where(perm[:, None] < k, np.asarray(sizes, np.int64)[tile], 0)
    r = np.arange(nb)[None, :]
    valid = r < size
    return np.where(valid, off[tile] + r, 0), valid


def _global_slots(sizes, ntiles: int, grid: int):
    """Each global index's storage slot and in-tile index."""
    off, perm = _cut(sizes, ntiles, grid)
    tile = np.repeat(np.arange(len(sizes)), sizes)
    return inv_perm(perm)[tile], np.arange(off[-1]) - off[tile]


def from_dense_nonuniform(a: torch.Tensor, mesh: VirtualMesh, row_sizes, col_sizes) -> DistMatrix:
    """Distribute with per-index tile sizes (the reference's non-uniform
    block-size lambdas): tile (i, j) of size (row_sizes[i], col_sizes[j])
    keeps the ownership rule (i % p, j % q) and is embedded top-left into
    a max(sizes)-square tile, zero elsewhere.  The embedding is exact for
    the multiply-class ops; the factorizations take
    ``redistribute_nonuniform``'s uniform retile.  The index maps are built
    from the sizes on the host; the matrix moves by one gather on
    ``mesh.device``.  Returns nb = max(sizes) and (m, n) = the sums."""
    row_sizes = [int(x) for x in row_sizes]
    col_sizes = [int(x) for x in col_sizes]
    a = torch.as_tensor(a, device=mesh.device)
    m, n = a.shape
    if sum(row_sizes) != m or sum(col_sizes) != n:
        raise ValueError(
            f"non-uniform sizes must tile the matrix exactly: "
            f"sum(rows)={sum(row_sizes)} vs m={m}, sum(cols)={sum(col_sizes)} vs n={n}"
        )
    p, q = mesh_shape(mesh)
    nb = max(row_sizes + col_sizes)
    grid = math.lcm(p, q)
    mt = _round_up(max(1, len(row_sizes)), grid)
    nt = _round_up(max(1, len(col_sizes)), grid)
    ri, rv = _slot_sources(row_sizes, mt, nb, p)
    ci, cv = _slot_sources(col_sizes, nt, nb, q)
    dev = a.device
    rows = torch.from_numpy(ri).to(dev)[:, None, :, None]
    cols = torch.from_numpy(ci).to(dev)[None, :, None, :]
    t = a[rows, cols]
    pad = ~(torch.from_numpy(rv).to(dev)[:, None, :, None] & torch.from_numpy(cv).to(dev)[None, :, None, :])
    t.masked_fill_(pad, 0)
    return DistMatrix(tiles=t, m=m, n=n, nb=nb, mesh=mesh, diag_pad=False)


def to_dense_nonuniform(d: DistMatrix, row_sizes, col_sizes) -> torch.Tensor:
    """Gather a from_dense_nonuniform matrix back to dense (m, n): one
    gather from the cyclic stack on its device."""
    row_sizes = [int(x) for x in row_sizes]
    col_sizes = [int(x) for x in col_sizes]
    p, q = mesh_shape(d.mesh)
    rs, rr = _global_slots(row_sizes, d.mt, p)
    cs, cc = _global_slots(col_sizes, d.nt, q)
    dev = d.tiles.device
    ix = lambda v: torch.from_numpy(v).to(dev)  # noqa: E731
    return d.tiles[ix(rs)[:, None], ix(cs)[None, :], ix(rr)[:, None], ix(cc)[None, :]]


# ---------------------------------------------------------------------------
# redistribute (src/redistribute.cc): eager and the ring all-to-all
# ---------------------------------------------------------------------------

REDIST_IMPLS = ("auto", "eager", "shardmap")


def fresh_pad_diag_range(mt1: int, nt1: int, mt2: int, nt2: int):
    """Tile indices [start, stop) whose (t, t) pad tile is fresh to a tile
    grid grown from (mt1, nt1) to (mt2, nt2): a ``diag_pad`` source needs
    every one set to the identity (the from_dense(diag_pad_one=True)
    contract).  The one source of that contract for both lowerings."""
    return min(mt1, nt1), min(mt2, nt2)


def redistribute_wire_bytes(src_tiles_shape, p: int, q: int, itemsize: int) -> int:
    """Audited link bytes of the ring redistribution of a (mt, nt, nb, nb)
    cyclic stack off a (p, q) mesh: each device's source block rotates
    p (q - 1) times along the columns (q pairs a hop) and p - 1 times
    along the rows (p pairs a hop)."""
    mt, nt, nb, _ = src_tiles_shape
    block = (mt // p) * (nt // q) * nb * nb * itemsize
    return block * (p * (q - 1) * q + (p - 1) * p)


def _shardmap_coord_map(mesh1: VirtualMesh, mesh2: VirtualMesh):
    """(r1, c1) -> (r2, c2) device-identity map between two meshes, or None
    when ``mesh2`` is not a re-arrangement of exactly ``mesh1``'s devices
    (the shardmap eligibility test)."""
    d1, d2 = mesh1.devices, mesh2.devices
    if sum(map(len, d1)) != sum(map(len, d2)):
        return None
    pos2 = {dev: (r, c) for r, row in enumerate(d2) for c, dev in enumerate(row)}
    cmap = []
    for row in d1:
        out = []
        for dev in row:
            got = pos2.get(dev)
            if got is None:
                return None
            out.append(got)
        cmap.append(tuple(out))
    return tuple(cmap)


def redistribute(d: DistMatrix, mesh: VirtualMesh, nb: Optional[int] = None,
                 impl: Optional[str] = None) -> DistMatrix:
    """Re-distribute between layouts (src/redistribute.cc), on the card.
    Two lowerings, selected by ``impl``:

    - ``eager``: the cyclic-order permutation (``from_cyclic`` /
      ``to_cyclic``), the tile grid padded or cropped for the new lcm; an
      nb change retiles through ``from_dense``;
    - ``shardmap``: the ring all-to-all (:func:`_redistribute_ring`), each
      device's source block circulating over the source grid by audited
      ``comm.ppermute_a`` hops; bitwise the eager result.  Needs an
      unchanged nb and a target mesh that re-arranges exactly the source
      mesh's devices;
    - ``auto`` (None): shardmap when eligible, else eager.

    A ``diag_pad`` source keeps its identity pad: fresh pad tiles of a
    grown tile grid get the identity (both lowerings), and an nb retile
    re-establishes it through ``from_dense(diag_pad_one=True)``."""
    nb2 = nb or d.nb
    impl = impl or "auto"
    if impl not in REDIST_IMPLS:
        raise ValueError(f"unknown redistribute impl {impl!r}; expected one of {REDIST_IMPLS}")
    p1, q1 = mesh_shape(d.mesh)
    p2, q2 = mesh_shape(mesh)
    if nb2 == d.nb and impl != "eager":
        if ((p2, q2) == (p1, q1) and mesh.devices == d.mesh.devices
                and mesh.device == d.mesh.device):
            return d  # identical layout: nothing moves
        cmap = _shardmap_coord_map(d.mesh, mesh)
        if cmap is not None:
            return _redistribute_ring(d, mesh, cmap)
        if impl == "shardmap":
            raise ValueError(
                "shardmap redistribute needs the target mesh to re-arrange "
                "exactly the source mesh's devices; use impl='eager'/'auto'"
            )
    elif impl == "shardmap":
        raise ValueError("shardmap redistribute cannot retile (nb change); use impl='eager'/'auto'")
    if nb2 != d.nb:
        dense = from_tiles(from_cyclic(d.tiles, p1, q1), d.m, d.n)
        return from_dense(dense, mesh, nb2, diag_pad_one=d.diag_pad)
    # pure ownership change: the logical tile grid is unchanged
    t_log = from_cyclic(d.tiles, p1, q1)
    mt, nt = t_log.shape[:2]
    mt2 = padded_tiles(d.m, nb2, mesh)
    nt2 = padded_tiles(d.n, nb2, mesh)
    if (mt2, nt2) != (mt, nt):  # pad / crop the tile grid for the new lcm
        grown = t_log.new_zeros((mt2, nt2, nb2, nb2))
        grown[:min(mt, mt2), :min(nt, nt2)] = t_log[:min(mt, mt2), :min(nt, nt2)]
        start, stop = fresh_pad_diag_range(mt, nt, mt2, nt2)
        if d.diag_pad and stop > start:
            fresh = torch.arange(start, stop, device=grown.device)
            grown[fresh, fresh] = torch.eye(nb2, dtype=d.dtype, device=grown.device)
        t_log = grown
    t2 = to_cyclic(t_log, p2, q2).to(mesh.device)
    no_pad2 = mt2 * nb2 == d.m and nt2 * nb2 == d.n
    return DistMatrix(tiles=t2, m=d.m, n=d.n, nb=nb2, mesh=mesh, diag_pad=no_pad2 or d.diag_pad)


def _ring_plan(p1: int, q1: int, dims, cmap, diag_pad: bool):
    """The ring's index lists, on the host: for every step, the (r1, c1,
    destination slot i, j, source slot i, j) of every destination tile the
    block a device holds at that step fills; and the fresh identity pad
    slots.  ``dims`` = (p2, q2, mt1, nt1, mt2, nt2)."""
    p2, q2, mt1, nt1, mt2, nt2 = dims
    mtl1, ntl1 = mt1 // p1, nt1 // q1
    mtl2, ntl2 = mt2 // p2, nt2 // q2
    r1 = np.arange(p1)[:, None, None, None]
    c1 = np.arange(q1)[None, :, None, None]
    r2 = np.array([[rc[0] for rc in row] for row in cmap])[:, :, None, None]
    c2 = np.array([[rc[1] for rc in row] for row in cmap])[:, :, None, None]
    a = np.arange(mtl2)[None, None, :, None]
    b = np.arange(ntl2)[None, None, None, :]
    i2 = r2 + a * p2  # logical tile indices of each device's destination slots
    j2 = c2 + b * q2
    full = np.broadcast_shapes(r1.shape, c1.shape, a.shape, b.shape)
    grid = [np.broadcast_to(x, full) for x in (r1, c1, a, b)]
    src_i = np.clip(i2 // p1, 0, mtl1 - 1)
    src_j = np.clip(j2 // q1, 0, ntl1 - 1)
    steps, off_p, off_q = [], 0, 0
    for idx in range(p1 * q1):
        rs = (r1 + off_p) % p1  # the source coordinate of the block held now
        cs = (c1 + off_q) % q1
        take = (i2 % p1 == rs) & (i2 < mt1) & (j2 % q1 == cs) & (j2 < nt1)
        take = np.broadcast_to(take, full)
        steps.append([x[take] for x in grid]
                     + [np.broadcast_to(src_i, full)[take], np.broadcast_to(src_j, full)[take]])
        if idx == p1 * q1 - 1:
            break  # the last block is consumed: no trailing hop
        if (idx + 1) % q1 == 0:
            off_p += 1
        else:
            off_q += 1
    pad0, pad1 = fresh_pad_diag_range(mt1, nt1, mt2, nt2)
    fresh = None
    if diag_pad and pad1 > pad0:
        mask = np.broadcast_to((i2 == j2) & (i2 >= pad0), full)
        fresh = [x[mask] for x in grid]
    return steps, fresh


def _redistribute_ring(d: DistMatrix, mesh: VirtualMesh, cmap) -> DistMatrix:
    """The ring all-to-all over the source grid (``slate_tpu``'s
    ``_redist_shardmap_fn``).  p1 q1 steps: at each, every source device
    gathers into its destination block the slots it can fill from the
    source block it holds now (one batched gather for the grid); then the
    blocks move by ``comm.ppermute_a``, q1 - 1 hops along q and one along
    p per row of steps, no hop after the last.  ``cmap`` gives each source
    coordinate the target coordinate of the same device, whose block it
    builds; the final placement onto the target grid is one block
    reorder, which moves nothing on a real mesh and is not audited."""
    from .comm import ppermute_a

    p1, q1 = mesh_shape(d.mesh)
    p2, q2 = mesh_shape(mesh)
    nb = d.nb
    mt1, nt1 = d.mt, d.nt
    mt2 = padded_tiles(d.m, nb, mesh)
    nt2 = padded_tiles(d.n, nb, mesh)
    mtl2, ntl2 = mt2 // p2, nt2 // q2
    steps, fresh = _ring_plan(p1, q1, (p2, q2, mt1, nt1, mt2, nt2), cmap, d.diag_pad)
    dev = d.tiles.device
    ix = lambda v: torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64)).to(dev)  # noqa: E731
    dest = d.tiles.new_zeros((p1, q1, mtl2, ntl2, nb, nb))
    if fresh is not None:
        dest[tuple(ix(v) for v in fresh)] = torch.eye(nb, dtype=d.dtype, device=dev)
    buf = local_view(d.tiles, p1, q1)
    for idx, (r, c, a, b, si, sj) in enumerate(steps):
        r, c = ix(r), ix(c)
        dest[r, c, ix(a), ix(b)] = buf[r, c, ix(si), ix(sj)]
        if idx == len(steps) - 1:
            break
        if (idx + 1) % q1 == 0:
            buf = ppermute_a(buf, ROW_AXIS, [((i + 1) % p1, i) for i in range(p1)])
        else:
            buf = ppermute_a(buf, COL_AXIS, [((i + 1) % q1, i) for i in range(q1)])
    # target slot (s, t) of the cyclic stack is device (s // mtl2, t // ntl2)'s
    # slot (s % mtl2, t % ntl2); that device built it at its source coordinate
    src_of = np.zeros((2, p2, q2), np.int64)
    for r1, row in enumerate(cmap):
        for c1, (r2, c2) in enumerate(row):
            src_of[:, r2, c2] = (r1, c1)
    s = np.arange(mt2)[:, None]
    t = np.arange(nt2)[None, :]
    t2 = dest[ix(src_of[0][s // mtl2, t // ntl2]), ix(src_of[1][s // mtl2, t // ntl2]),
              ix(s % mtl2), ix(t % ntl2)].to(mesh.device)
    no_pad2 = mt2 * nb == d.m and nt2 * nb == d.n
    return DistMatrix(tiles=t2, m=d.m, n=d.n, nb=nb, mesh=mesh, diag_pad=no_pad2 or d.diag_pad)


def redistribute_nonuniform(d: DistMatrix, row_sizes, col_sizes, nb: Optional[int] = None,
                            diag_pad_one: bool = False) -> DistMatrix:
    """Re-distribute a ``from_dense_nonuniform`` matrix onto a uniform nb
    tiling of the same mesh, the form every factorization takes (interior
    tile pad would make diagonal tiles singular), on the card.  Pass
    ``diag_pad_one=True`` when the result feeds a factorization."""
    dense = to_dense_nonuniform(d, row_sizes, col_sizes)
    return from_dense(dense, d.mesh, nb or d.nb, diag_pad_one=diag_pad_one)
