"""Elastic resume: continue a checkpointed factorization on a (possibly
reshaped) mesh.

Counterpart of ``slate_tpu/ft/elastic.py``.  Preemption at scale usually
hands back a DIFFERENT mesh: ``resume`` rebuilds the snapshot's carry on
whatever grid it is given and runs the remaining k-loop segments.  Three
carry-rebuild tiers:

- same grid: the snapshot goes onto ``mesh.device`` and back to cyclic
  order there (a copy: the resumed loop writes its carry in place and the
  snapshot must stay as it was; on the card the permutation is one device
  copy, not two host gathers of the whole stack);
- a reshaped grid over the same device count: the snapshot lands on its
  ORIGINAL grid over the new mesh's device ids, and moves through the
  ring all-to-all (``parallel.dist.redistribute(impl="shardmap")``, whose
  audited link bytes are ``redistribute_wire_bytes``), the primitive that
  also rebalances live matrices (``reshard``);
- anything else (the device count changed): the host relayout of the
  logical tile grid (``_regrow``) -- still exact byte moves.

Either way the resumed run is BITWISE the uninterrupted one: pad tiles
carry identity diagonals and exact-zero updates, so the data region does
not change under re-padding for a different mesh lcm, and the pp row
permutation re-bases onto the new padded row space by copying its prefix.
The multi-array ops (geqrf, he2hb) carry grid-locked arrays and resume on
their own grid shape only.  Recovery costs land in the ``ft.ckpt_*``
counters.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..core.tiling import to_cyclic
from ..parallel.dist import (
    DistMatrix,
    fresh_pad_diag_range,
    padded_tiles,
    redistribute,
    redistribute_wire_bytes,
)
from ..parallel.mesh import VirtualMesh, make_mesh, mesh_shape
from ..types import SlateError
from . import ckpt as _ckpt
from .ckpt import Checkpoint
from .policy import count


def resumable(ck: Optional[Checkpoint]) -> bool:
    """True when ``ck`` is a snapshot this module can continue."""
    return ck is not None and ck.op in _ckpt.CKPT_OPS


def _regrow(logi: np.ndarray, mt2: int, nt2: int, nb: int, diag_pad: bool) -> np.ndarray:
    """Crop / grow a LOGICAL-order tile grid to the target padded extent;
    grown pad tiles get the identity diagonal (the factorization padding
    contract).  Pure byte moves and fresh identity tiles: exact."""
    mt1, nt1 = logi.shape[:2]
    if (mt1, nt1) == (mt2, nt2):
        return logi
    out = np.zeros((mt2, nt2, nb, nb), logi.dtype)
    out[:min(mt1, mt2), :min(nt1, nt2)] = logi[:min(mt1, mt2), :min(nt1, nt2)]
    if diag_pad:
        for t in range(*fresh_pad_diag_range(mt1, nt1, mt2, nt2)):
            out[t, t] = np.eye(nb, dtype=logi.dtype)
    return out


def _on_mesh(ck: Checkpoint, logi: np.ndarray, mesh: VirtualMesh) -> DistMatrix:
    """A logical tile grid as a fresh cyclic DistMatrix on ``mesh``."""
    t = to_cyclic(_ckpt._to_device(logi, mesh.device), *mesh_shape(mesh))
    return DistMatrix(tiles=t, m=ck.m, n=ck.n, nb=ck.nb, mesh=mesh, diag_pad=True)


def _carry_to_mesh(ck: Checkpoint, mesh: VirtualMesh, mt2: int, nt2: int) -> DistMatrix:
    p1, q1 = ck.grid
    if (p1, q1) == mesh_shape(mesh):
        return _on_mesh(ck, ck.tiles, mesh)
    ids = [i for row in mesh.devices for i in row]
    if p1 * q1 == len(ids):
        # reshaped grid, same device count: land the snapshot in its
        # ORIGINAL layout and move it with the ring exchange
        d1 = _on_mesh(ck, ck.tiles, make_mesh(p1, q1, device=mesh.device, devices=ids))
        d2 = redistribute(d1, mesh, impl="shardmap")
        count("ft.ckpt_redistribute_bytes", ck.op, float(
            redistribute_wire_bytes(d1.tiles.shape, p1, q1, d1.tiles.element_size())))
        return d2
    # the original grid is not reconstructible over these devices: host relayout
    return _on_mesh(ck, _regrow(ck.tiles, mt2, nt2, ck.nb, True), mesh)


def _rowperm_to_rows(ck: Checkpoint, mglob2: int) -> Optional[np.ndarray]:
    """Re-base the pp row permutation onto the new padded row space: all
    swap activity lives below the true extent (pivots are drawn from
    rows < m), so the old perm's prefix transplants exactly and the new
    pad rows are fixed points."""
    if ck.rowperm is None:
        return None
    out = np.arange(mglob2, dtype=np.int64)
    ncopy = min(len(ck.rowperm), mglob2)
    out[:ncopy] = ck.rowperm[:ncopy]
    return out


def reshard(d: DistMatrix, mesh: VirtualMesh) -> DistMatrix:
    """Move a live DistMatrix onto a different mesh by the ring exchange
    (the rebalancing verb; counted as a ckpt reshard so its traffic is
    observable)."""
    p1, q1 = mesh_shape(d.mesh)
    out = redistribute(d, mesh, impl="shardmap")
    if out is not d:  # the identical-layout early return moves no bytes
        count("ft.ckpt_reshards", "reshard")
        count("ft.ckpt_redistribute_bytes", "reshard", float(
            redistribute_wire_bytes(d.tiles.shape, p1, q1, d.tiles.element_size())))
    return out


def resume(ck: Checkpoint, mesh: VirtualMesh, bcast_impl: Optional[str] = None,
           panel_impl: Optional[str] = None):
    """Continue a checkpointed factorization from its snapshot on ``mesh``
    (on ``mesh.device``) and return exactly what the checkpointed driver
    returns: (L, info) / (LU, info), (LU, perm, info) for pp, DistQR for
    geqrf, DistTwoStage for he2hb.  Bitwise the uninterrupted run on the
    same grid and, for the tile-stack ops, on a reshaped grid.  The
    multi-array ops carry grid-locked arrays (a mesh row's local panel QR
    factors exactly the rows that row owns), so a reshaped-grid resume
    raises; a same-shape grid over other device ids resumes.  A monitored
    snapshot resumes monitored, its gauges continued, and its growth gate
    still policed.  Raises ``Preempted`` again if a persistent kill fault
    is still armed."""
    if not resumable(ck):
        raise SlateError("elastic.resume: checkpoint is missing or names an unknown op")
    t0 = time.perf_counter()
    p2, q2 = mesh_shape(mesh)
    if ck.op in _ckpt._MULTI_KEYS and (p2, q2) != tuple(ck.grid):
        raise SlateError(
            f"elastic.resume: {ck.op} carries grid-locked auxiliary "
            f"arrays (per-mesh-row panel factors); its {ck.grid[0]}x"
            f"{ck.grid[1]} snapshot cannot resume on a {p2}x{q2} grid — "
            "restart from scratch or grant a same-shape grid")
    mt2 = padded_tiles(ck.m, ck.nb, mesh)
    nt2 = padded_tiles(ck.n, ck.nb, mesh)
    if (p2, q2) != tuple(ck.grid):
        count("ft.ckpt_reshards", ck.op)
    d = _carry_to_mesh(ck, mesh, mt2, nt2)
    rowperm = _rowperm_to_rows(ck, mt2 * ck.nb)
    count("ft.ckpt_resumes", ck.op)
    out = _ckpt._run(
        ck.op, d, ck.step, ck.every,
        bcast_impl if bcast_impl is not None else ck.bcast_impl,
        panel_impl if panel_impl is not None else ck.panel_impl,
        # a monitored snapshot continues its gauges (max / min folds are
        # exact, so the finished chain records the unbroken run's)
        ck.num_monitor, rowperm=rowperm, gauges=(ck.gauges or None), ckpt0=ck,
        arrays=(ck.arrays or None),
        # keep the interrupted run's async preference (persisted in the
        # snapshot) unless the environment re-arms it
        async_snap=(ck.async_snapshots or _ckpt.resolve_ckpt_async(None)),
        growth_abort=ck.growth_abort, owned=True,
    )
    count("ft.ckpt_resume_runtime_s", ck.op, time.perf_counter() - t0)
    return out
