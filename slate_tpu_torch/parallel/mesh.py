"""The virtual (p, q) process grid of the mesh drivers.

Counterpart of ``slate_tpu/parallel/mesh.py``.  ``slate_tpu`` builds a
``jax.sharding.Mesh`` over p * q chips; this slice of the port runs the same
block-cyclic algorithms on ONE card: the grid is *virtual*, a descriptor
that tells the drivers how to read a cyclic tile stack as p x q local
stacks (``dist.local_view``).  Every local op of a device becomes one op
batched over the (p, q) grid, and the collectives of ``comm.py`` become
indexing, sums and slices over the grid dims.  A ``torch.distributed``
backend over several cards is a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch

from ..core.grid import grid_2d_factor
from ..core.matrix import DEFAULT_DEVICE
from ..types import GridOrder

# the axis names of slate_tpu, used by the comm audit records
ROW_AXIS = "p"
COL_AXIS = "q"


@dataclass(frozen=True)
class VirtualMesh:
    """A p x q process grid on one device.  ``devices`` is the (p, q) grid
    of virtual device ids (a tuple of row tuples): which device would hold
    which block on a real mesh.  On one card it moves nothing; it is the
    device identity ``dist.redistribute`` reads to decide whether a new
    mesh re-arranges exactly this one's devices.  ``order`` is the
    reference's grid ordering that placed them."""

    p: int
    q: int
    device: torch.device
    order: GridOrder = GridOrder.Row
    devices: Tuple[Tuple[int, ...], ...] = ()


def _device_grid(ids: Sequence[int], p: int, q: int, order: GridOrder) -> Tuple[Tuple[int, ...], ...]:
    """Row order places id k at (k // q, k % q), Col order at (k % p, k // p)."""
    if order == GridOrder.Col:
        return tuple(tuple(ids[c * p + r] for c in range(q)) for r in range(p))
    return tuple(tuple(ids[r * q + c] for c in range(q)) for r in range(p))


def make_mesh(
    p: Optional[int] = None,
    q: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    order: Optional[GridOrder] = None,
    devices: Optional[Sequence[int]] = None,
) -> VirtualMesh:
    """A p x q virtual mesh on ``device`` (default: the card) over the
    virtual device ids ``devices`` (distinct ints, default ``range(p q)``).
    With p or q left out, ``devices`` is required and sets the grid from
    its length, near-square when both are out (``grid_2d_factor``)."""
    if devices is None:
        if p is None or q is None:
            raise ValueError("make_mesh: give p and q, or the devices to factor")
        ids = list(range(int(p) * int(q)))
    else:
        ids = [int(k) for k in devices]
        if len(set(ids)) != len(ids):
            raise ValueError(f"make_mesh: device ids repeat: {ids}")
    if p is None and q is None:
        p, q = grid_2d_factor(len(ids))
    elif p is None:
        p = len(ids) // q
    elif q is None:
        q = len(ids) // p
    p, q = int(p), int(q)
    if p < 1 or q < 1 or p * q > len(ids):
        raise ValueError(f"mesh {p}x{q} invalid for {len(ids)} devices")
    order = order or GridOrder.Row
    return VirtualMesh(p=p, q=q,
                       device=torch.device(device if device is not None else DEFAULT_DEVICE),
                       order=order, devices=_device_grid(ids[:p * q], p, q, order))


def mesh_shape(mesh: VirtualMesh) -> Tuple[int, int]:
    return mesh.p, mesh.q
