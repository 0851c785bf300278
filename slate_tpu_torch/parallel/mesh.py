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
from typing import Optional, Tuple, Union

import torch

from ..core.matrix import DEFAULT_DEVICE
from ..types import GridOrder

# the axis names of slate_tpu, used by the comm audit records
ROW_AXIS = "p"
COL_AXIS = "q"


@dataclass(frozen=True)
class VirtualMesh:
    """A p x q process grid on one device.  ``order`` keeps the reference's
    grid ordering (it decides which physical device would hold which block
    on a real mesh; on one card it changes nothing)."""

    p: int
    q: int
    device: torch.device
    order: GridOrder = GridOrder.Row


def make_mesh(
    p: int,
    q: int,
    device: Optional[Union[str, torch.device]] = None,
    order: Optional[GridOrder] = None,
) -> VirtualMesh:
    """A p x q virtual mesh on ``device`` (default: the card)."""
    if p < 1 or q < 1:
        raise ValueError(f"mesh {p}x{q} invalid")
    return VirtualMesh(p=int(p), q=int(q),
                       device=torch.device(device if device is not None else DEFAULT_DEVICE),
                       order=order or GridOrder.Row)


def mesh_shape(mesh: VirtualMesh) -> Tuple[int, int]:
    return mesh.p, mesh.q
