"""Checkpointed mesh k-loops: segment chains and carry snapshots.

Counterpart of ``slate_tpu/ft/ckpt.py``.  The mesh factorizations run
their whole k-loop in one call, so a preemption mid-factorization loses
everything.  This module runs the five long loops -- ``potrf``, the
no-pivot LU, the partial-pivot LU, the distributed CAQR (``geqrf``) and
the two-stage eig reduction (``he2hb``) -- as a CHAIN OF SEGMENTS, each
running steps [k0, k1) on the loop carry, and snapshots the carry to the
host at every ``every``-step boundary:

- ``potrf`` / ``getrf_nopiv``: the cyclic tile stack, each step run in the
  strict schedule (lookahead 0) on the window of the bucket that holds it
  in the plain driver's own ``comm.bucket_plan`` (``dist_chol._potrf_tiles``
  / ``dist_lu._getrf_nopiv_tiles`` over a step range), so every tile gets
  the same products in the same order as in the uninterrupted loop;
- ``getrf_pp``: the tile stack and the replicated row permutation (a host
  array), through ``dist_lu._pp_strict_steps``, the strict form of the
  plain loop;
- ``geqrf``: the flat local matrices, the per-(mesh row, panel) T_loc
  stack and the replicated tree V / T stacks (``dist_qr._qr_panel_step``);
- ``he2hb``: the flat local matrices, the reflector stack sharded over the
  mesh rows and the compact-WY stack (``dist_twostage._he2hb_step``).

Every schedule of these loops is bitwise the same (lookahead and
bucketing reorder only independent work), so a chain of segments gives
the plain driver's bytes at every boundary set, and a run resumed from
any snapshot is bitwise the uninterrupted run (``ft/elastic.py``).
Snapshots keep the tile grid in LOGICAL order, so a snapshot taken on a
p x q mesh resumes on a p' x q' one; the multi-array carries of geqrf and
he2hb are grid-locked (a mesh row's panel QR factors the rows it owns),
so those resume on their own grid shape only.

The port's loops write the carry IN PLACE (``slate_tpu``'s segment jits
are functional and its snapshots keep the buffers they were handed).  So:

- a run works on a copy of the input's tiles (``potrf_dist`` without
  ``overwrite_a``), and a resume on a fresh copy of the snapshot;
- a snapshot is a COPY: the carry's parts are cloned on its device (the
  tiles into logical order), then copied to the host.  ``.cpu()`` and
  ``.numpy()`` alias a CPU tensor's storage, so a snapshot taken that way
  would go on changing under the next segment;
- an ASYNC snapshot (``SLATE_TPU_CKPT_ASYNC=1`` or
  ``async_snapshots=True``) makes that device clone at the boundary (one
  carry of device memory: 1 GiB for f32 n = 16384) and issues its copy
  into pinned host buffers on a side stream, after an event on the compute
  stream; the copy is fenced at the next boundary, at a kill or at the
  loop's end (``ft.ckpt_async_overlap_s``: issue to fence).  On the CPU the
  async snapshot is the sync copy, bitwise;
- an in-segment kill runs its partial segment on the live carry, which
  is dropped with the exception; the last snapshot is a separate copy.

``Option.Checkpoint`` (an int K; explicit > ``SLATE_TPU_CKPT`` > off)
routes the mesh drivers here; off calls the plain drivers untouched.  The
injector's ``KillFault`` is consulted between segments: an armed kill
raises ``Preempted`` carrying the last snapshot.  Recovery costs land in
the ``ft.ckpt_*`` counters (``ft.policy``).  ``num_monitor="on"`` raises
until the observability slice, as in every port driver; the snapshot
format keeps ``gauges`` and ``growth_abort`` for it.  numpy has no
bfloat16, so a bf16 carry cannot be snapshotted and raises.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..obs.span import instrument
from ..core.tiling import cyclic_perm, inv_perm
from ..linalg.eig import _he2hb_panel_count
from ..ops.kernels import panel_impl_scope, resolve_panel_impl, resolve_update_impl, update_impl_scope
from ..parallel.comm import bcast_impl_scope, resolve_bcast_impl
from ..parallel.dist import DistMatrix
from ..parallel.dist_chol import _check_num_monitor, _chol_info_dist, _potrf_tiles, potrf_dist
from ..parallel.dist_lu import (
    _getrf_nopiv_tiles,
    _lu_info_dist,
    _pp_strict_steps,
    getrf_nopiv_dist,
    getrf_pp_dist,
)
from ..parallel.dist_qr import DistQR, _from_flat, _qr_pad_identity, _qr_panel_step, _to_flat, geqrf_dist
from ..parallel.dist_twostage import DistTwoStage, _he2hb_step, he2hb_dist
from ..parallel.mesh import mesh_shape
from ..types import SlateError
from . import inject
from .policy import count

CKPT_ENV = "SLATE_TPU_CKPT"
CKPT_ASYNC_ENV = "SLATE_TPU_CKPT_ASYNC"
CKPT_OPS = ("potrf", "getrf_nopiv", "getrf_pp", "geqrf", "he2hb")
# auxiliary carry arrays per multi-array op, in snapshot order.  These
# carries are GRID-LOCKED: their per-device layout (and the arithmetic
# that produced them -- a mesh row's local panel QR factors exactly the
# rows that row owns) depends on the (p, q) grid shape, so a reshaped
# resume cannot be bitwise and elastic.resume refuses it.
_MULTI_KEYS: Dict[str, Tuple[str, ...]] = {
    "geqrf": ("tls", "tvs", "tts"),
    "he2hb": ("vqs", "tqs"),
}


def resolve_checkpoint(every=None) -> Optional[int]:
    """Resolve an Option.Checkpoint value at driver level: explicit
    argument > ``SLATE_TPU_CKPT`` environment > off.  Returns the
    snapshot interval (int >= 1) or None (off: the plain drivers)."""
    if every is None:
        env = os.environ.get(CKPT_ENV, "").strip()
        if env in ("", "0", "off"):
            return None
        every = env
    if every in (None, 0, False) or str(every) in ("0", "off"):
        return None
    k = int(every)
    if k < 1:
        raise ValueError(
            f"Option.Checkpoint must be a positive step interval or off, got {every!r}")
    return k


def resolve_ckpt_async(flag=None) -> bool:
    """Async-snapshot switch: explicit argument > ``SLATE_TPU_CKPT_ASYNC``
    environment > off (sync).  Sync and async snapshots are bitwise
    equal; async overlaps the device-to-host copy with the next segment."""
    if flag is None:
        return os.environ.get(CKPT_ASYNC_ENV, "").strip().lower() in ("1", "on", "true", "async")
    return bool(flag)


# ---------------------------------------------------------------------------
# Snapshot + preemption types
# ---------------------------------------------------------------------------


@dataclass
class Checkpoint:
    """One host-resident snapshot of a mesh factorization's k-loop carry.

    ``tiles`` is the PADDED tile grid in LOGICAL order (mt, nt, nb, nb),
    layout-independent, so the snapshot resumes on any grid shape: pad
    tiles carry the identity diagonal and receive exact-zero trailing
    updates, hence the data region is bitwise-invariant under re-padding
    for a different mesh lcm.  ``rowperm`` (pp only) covers the padded row
    space; all swap activity lives below the true extent, so re-basing
    onto a different padded length copies a prefix of fixed points and
    data swaps exactly.  ``gauges`` are the NumMonitor carry scalars
    (empty until the observability slice: ``num_monitor`` on raises).

    ``arrays`` holds the multi-array ops' auxiliary carries
    (``_MULTI_KEYS``): the geqrf T_loc / tree stacks, the he2hb reflector
    and compact-WY stacks, in ``slate_tpu``'s global layout (``tls``
    (p nt, nb, nb), mesh row r's stack at [r nt:(r + 1) nt]), which is
    grid-locked, so a resume requires the snapshot's own (p, q) grid
    shape for these ops.  The ``np.savez`` file layout is
    ``slate_tpu``'s: a snapshot saved by either package loads in the
    other."""

    op: str
    step: int  # next logical k-step to execute on resume
    every: int  # snapshot interval the run was using
    m: int
    n: int
    nb: int
    grid: Tuple[int, int]  # (p, q) the snapshot was taken on
    bcast_impl: str
    panel_impl: str
    num_monitor: bool
    tiles: np.ndarray  # LOGICAL-order padded tile grid
    rowperm: Optional[np.ndarray] = None
    gauges: Dict[str, np.ndarray] = field(default_factory=dict)
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    # whether the interrupted run had the mid-loop growth-abort gate
    # armed (monitored no-pivot LU); kept for the observability slice
    growth_abort: bool = False
    # whether the interrupted run snapshotted asynchronously: resume
    # keeps the caller's overlap preference (results are bitwise either way)
    async_snapshots: bool = False

    @property
    def nbytes(self) -> int:
        n = int(self.tiles.nbytes)
        if self.rowperm is not None:
            n += int(self.rowperm.nbytes)
        for v in self.arrays.values():
            n += int(v.nbytes)
        return n

    def save(self, path: str) -> str:
        """Persist to disk (``np.savez``): the preemption-survival form;
        ``Checkpoint.load(path)`` round-trips bitwise."""
        meta = dict(
            op=self.op, step=self.step, every=self.every, m=self.m,
            n=self.n, nb=self.nb, grid=list(self.grid),
            bcast_impl=self.bcast_impl, panel_impl=self.panel_impl,
            num_monitor=self.num_monitor, growth_abort=self.growth_abort,
            async_snapshots=self.async_snapshots,
        )
        arrays = {
            "tiles": self.tiles,
            "meta": np.frombuffer(json.dumps(meta).encode(), np.uint8),
        }
        if self.rowperm is not None:
            arrays["rowperm"] = self.rowperm
        for k, v in self.gauges.items():
            arrays[f"gauge_{k}"] = np.asarray(v)
        for k, v in self.arrays.items():
            arrays[f"arr_{k}"] = np.asarray(v)
        with open(path, "wb") as f:  # np.savez(str) would append .npz
            np.savez(f, **arrays)
        return path

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            gauges = {k[len("gauge_"):]: z[k] for k in z.files if k.startswith("gauge_")}
            arrs = {k[len("arr_"):]: z[k] for k in z.files if k.startswith("arr_")}
            return cls(
                op=meta["op"], step=int(meta["step"]),
                every=int(meta["every"]), m=int(meta["m"]), n=int(meta["n"]),
                nb=int(meta["nb"]), grid=tuple(meta["grid"]),
                bcast_impl=meta["bcast_impl"], panel_impl=meta["panel_impl"],
                num_monitor=bool(meta["num_monitor"]), tiles=z["tiles"],
                rowperm=(z["rowperm"] if "rowperm" in z.files else None),
                gauges=gauges, arrays=arrs,
                growth_abort=bool(meta.get("growth_abort", False)),
                async_snapshots=bool(meta.get("async_snapshots", False)),
            )


class Preempted(SlateError):
    """A (possibly injected) preemption interrupted a checkpointed
    k-loop.  ``checkpoint`` is the last snapshot -- resume it with
    ``ft.elastic.resume`` -- or None when the kill landed before the
    first snapshot boundary (nothing to resume from: the caller decides
    between a from-scratch restart and rejection)."""

    def __init__(self, op: str, killed_at: int, checkpoint: Optional[Checkpoint]):
        self.op = op
        self.killed_at = int(killed_at)
        self.checkpoint = checkpoint
        state = (f"resumable from step {checkpoint.step}" if checkpoint is not None
                 else "no snapshot taken — unresumable")
        super().__init__(f"ckpt[{op}]: preempted at step {killed_at} ({state})")


def _cyclic_to_logical(t: np.ndarray, p: int, q: int) -> np.ndarray:
    """Host-side ``tiling.from_cyclic`` (a pure index permutation: moves
    exact bytes, never touches values)."""
    rp = inv_perm(cyclic_perm(t.shape[0], p))
    cp = inv_perm(cyclic_perm(t.shape[1], q))
    return np.ascontiguousarray(t[rp][:, cp])


def _logical_to_cyclic(t: np.ndarray, p: int, q: int) -> np.ndarray:
    rp = cyclic_perm(t.shape[0], p)
    cp = cyclic_perm(t.shape[1], q)
    return np.ascontiguousarray(t[rp][:, cp])


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    """A device copy of a host array (never a view of it: the carry is
    written in place, and the snapshot it came from must not change)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device, copy=True)


# ---------------------------------------------------------------------------
# The carry: its initial state, its segments and its snapshot parts
# ---------------------------------------------------------------------------


def _steps(op: str, d: DistMatrix) -> int:
    return _he2hb_panel_count(d.n, d.nb) if op == "he2hb" else d.nt


def _carry_init(op: str, d: DistMatrix, rowperm=None, arrays=None, owned: bool = False) -> dict:
    """The loop carry of ``op`` over ``d``: a copy of its tiles (``owned``:
    ``d``'s own stack, a fresh one), or for the multi-array ops its flat
    local matrices (always a copy) with the auxiliary stacks, from
    ``arrays`` (a snapshot's, copied) or zeros as the plain drivers make
    them."""
    p, q = mesh_shape(d.mesh)
    nb, dtype, dev = d.nb, d.dtype, d.tiles.device
    if op not in _MULTI_KEYS:
        st = {"tiles": d.tiles if owned else d.tiles.clone()}
        if op == "getrf_pp":
            st["rowperm"] = (np.arange(d.nt * nb) if rowperm is None
                             else np.array(rowperm, dtype=np.int64))
        return st
    st = {"flat": _to_flat(d.tiles, p, q)}
    if arrays:
        for kk in _MULTI_KEYS[op]:
            st[kk] = _to_device(arrays[kk], dev)
        if op == "geqrf":
            st["tls"] = st["tls"].view(p, d.nt, nb, nb)
    elif op == "geqrf":
        nmerge = max(1, p)
        st["tls"] = torch.zeros((p, d.nt, nb, nb), dtype=dtype, device=dev)
        st["tvs"] = torch.zeros((d.nt, nmerge, 2 * nb, nb), dtype=dtype, device=dev)
        st["tts"] = torch.zeros((d.nt, nmerge, nb, nb), dtype=dtype, device=dev)
    else:
        nsteps = max(_steps(op, d), 1)
        mfl = st["flat"].shape[2]
        st["vqs"] = torch.zeros((nsteps, p * mfl, nb), dtype=dtype, device=dev)
        st["tqs"] = torch.zeros((nsteps, nb, nb), dtype=dtype, device=dev)
    return st


def _seg_dispatch(op: str, st: dict, d: DistMatrix, k0: int, k1: int) -> None:
    """Steps [k0, k1) of ``op``'s loop, in place on the carry ``st``."""
    p, q = mesh_shape(d.mesh)
    if op == "potrf":
        _potrf_tiles(st["tiles"], p, q, d.nt, 0, k0, k1)
    elif op == "getrf_nopiv":
        _getrf_nopiv_tiles(st["tiles"], p, q, d.nt, 0, k0, k1)
    elif op == "getrf_pp":
        _pp_strict_steps(st["tiles"], st["rowperm"], p, q, d.nt, d.m, k0, k1)
    elif op == "geqrf":
        carry = (st["flat"], st["tls"], st["tvs"], st["tts"])
        for k in range(k0, k1):
            _qr_panel_step(k, carry, p, q, d.nb, d.m)
    elif op == "he2hb":
        carry = (st["flat"], st["vqs"], st["tqs"])
        for k in range(k0, k1):
            _he2hb_step(k, carry, p, q, d.n, d.nb)
    else:
        raise ValueError(f"no checkpointed driver for op {op!r}; expected one of {CKPT_OPS}")


def _fresh(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` (always a copy, never a view)."""
    return x.clone(memory_format=torch.contiguous_format)


def _carry_parts(op: str, st: dict, d: DistMatrix) -> Dict[str, torch.Tensor]:
    """Copies of the carry's tensors on its device: the tiles in logical
    order (from the cyclic stack, or from the flat local matrices of the
    multi-array ops), the auxiliary stacks in ``slate_tpu``'s layout."""
    p, q = mesh_shape(d.mesh)
    nb, mt, nt = d.nb, d.mt, d.nt
    mtl, ntl = mt // p, nt // q
    if op not in _MULTI_KEYS:
        loc = st["tiles"].view(p, mtl, q, ntl, nb, nb).permute(1, 0, 3, 2, 4, 5)
        return {"tiles": _fresh(loc).view(mt, nt, nb, nb)}
    # flat[r, c, a nb + i, b nb + j] is logical tile (a p + r, b q + c)'s (i, j)
    flat = st["flat"].view(p, q, mtl, nb, ntl, nb).permute(2, 0, 4, 1, 3, 5)
    parts = {"tiles": _fresh(flat).view(mt, nt, nb, nb)}
    for kk in _MULTI_KEYS[op]:
        parts[kk] = _fresh(st[kk])
    if op == "geqrf":
        parts["tls"] = parts["tls"].view(p * nt, nb, nb)
    return parts


_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _issue_host_copy(parts: Dict[str, torch.Tensor]):
    """Start the device-to-host copy of ``parts``: on the card into pinned
    buffers on a side stream, after an event on the current stream;
    returns (host tensors, the copies' done event).  CPU parts are
    already fresh copies and are returned as they are (no event)."""
    first = next(iter(parts.values()))
    if not first.is_cuda:
        return parts, None
    side = _SIDE_STREAMS.get(first.device)
    if side is None:
        side = _SIDE_STREAMS[first.device] = torch.cuda.Stream(first.device)
    ready = torch.cuda.Event()
    ready.record()
    host = {}
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for kk, v in parts.items():
            v.record_stream(side)  # not reused before the copy has read it
            host[kk] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[kk].copy_(v, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return host, done


class _PendingSnapshot:
    """A snapshot whose device-to-host copy is in flight: the device
    clone of the carry (``_carry_parts``) is made at the boundary, so the
    next segment may write the live carry while the copy runs; the clone
    is held until :meth:`wait` fences the copy.  The pp row permutation
    lives on the host and is copied at once."""

    def __init__(self, op, d: DistMatrix, st, k, every, bi, pi, ga=False, asnap=False):
        self._meta = (op, d, int(k), int(every), bi, pi, ga, asnap)
        self._rowperm = st["rowperm"].copy() if "rowperm" in st else None
        self._dev = _carry_parts(op, st, d)
        self._host, self._done = _issue_host_copy(self._dev)
        self.issued = time.perf_counter()

    def wait(self) -> Checkpoint:
        """Fence the copy and build the host Checkpoint; counts it."""
        if self._done is not None:
            self._done.synchronize()
        self._dev = None
        op, d, k, every, bi, pi, ga, asnap = self._meta
        p, q = mesh_shape(d.mesh)
        host = {kk: v.numpy() for kk, v in self._host.items()}
        ck = Checkpoint(
            op=op, step=k, every=every, m=d.m, n=d.n, nb=d.nb, grid=(p, q),
            bcast_impl=bi, panel_impl=pi, num_monitor=False, tiles=host["tiles"],
            rowperm=self._rowperm, arrays={kk: host[kk] for kk in _MULTI_KEYS.get(op, ())},
            growth_abort=ga, async_snapshots=asnap,
        )
        count("ft.ckpt_snapshots", op)
        count("ft.ckpt_snapshot_bytes", op, float(ck.nbytes))
        return ck


def _snapshot(op, d: DistMatrix, st, k, every, bi, pi, ga: bool = False) -> Checkpoint:
    """A sync snapshot of the carry at step ``k``: a host copy, complete
    on return."""
    return _PendingSnapshot(op, d, st, k, every, bi, pi, ga).wait()


# ---------------------------------------------------------------------------
# Host engine: segment chain + snapshot + kill consultation
# ---------------------------------------------------------------------------


def _finish(op: str, d: DistMatrix, st: dict):
    """The plain drivers' exit computations on the finished carry, and
    their return forms."""
    p, q = mesh_shape(d.mesh)
    if op in _MULTI_KEYS:
        tiles = torch.empty_like(d.tiles)
        _from_flat(st["flat"], tiles, p, q)
        if op == "he2hb":
            band = DistMatrix(tiles=tiles, m=d.m, n=d.n, nb=d.nb, mesh=d.mesh)
            return DistTwoStage(band, st["vqs"], st["tqs"], st["vqs"][:0], st["tqs"][:0])
        _qr_pad_identity(tiles, p, q, d.n)
        fd = DistMatrix(tiles=tiles, m=d.m, n=d.n, nb=d.nb, mesh=d.mesh, diag_pad=True)
        return DistQR(fd, st["tls"].reshape(p * d.nt, d.nb, d.nb), st["tvs"], st["tts"])
    t = st["tiles"]
    out = DistMatrix(tiles=t, m=d.m, n=d.n, nb=d.nb, mesh=d.mesh, diag_pad=True)
    if op == "potrf":
        return out, _chol_info_dist(t, p, q, d.nb)
    info = _lu_info_dist(t, p, q, d.nb)
    if op == "getrf_pp":
        return out, torch.from_numpy(st["rowperm"]).to(t.device), info
    return out, info


def _run(op: str, d: DistMatrix, k_from: int, every: int, bi: str, pi: str, rowperm=None,
         ckpt0: Optional[Checkpoint] = None, arrays=None, async_snap: bool = False,
         growth_abort: bool = False, owned: bool = False):
    """Run the k-loop of ``op`` over [k_from, nsteps) as segments of
    ``every`` steps: snapshot the carry at every boundary (async when
    ``async_snap``: the copy overlaps the next segment and fences at the
    next boundary); raise ``Preempted`` when an armed ``KillFault`` lands
    inside the segment about to run (an ``in_segment`` kill first runs
    the partial segment up to the kill step: real work, then lost).
    Either way the work since the last snapshot is exactly what the
    resume re-executes (``ft.ckpt_lost_steps``).  ``owned``: ``d``'s tiles
    are a fresh stack the run may write (a resume's)."""
    if d.dtype == torch.bfloat16:
        raise ValueError(f"{op}_ckpt: numpy has no bfloat16, so a bf16 carry cannot be "
                         "snapshotted; factor in f32 or run without Option.Checkpoint")
    nt = _steps(op, d)
    st = _carry_init(op, d, rowperm, arrays, owned)
    ui = "xla" if op == "getrf_pp" else resolve_update_impl()  # pp pins its update, as its driver
    last = ckpt0
    pending: Optional[_PendingSnapshot] = None

    def fence():
        nonlocal last, pending
        if pending is not None:
            count("ft.ckpt_async_overlap_s", op, max(0.0, time.perf_counter() - pending.issued))
            last = pending.wait()
            pending = None

    with bcast_impl_scope(bi), panel_impl_scope(pi), update_impl_scope(ui):
        k = int(k_from)
        while k < nt:
            k2 = min(k + every, nt)
            kills = [f for f in inject.armed_kills(op) if k <= f.k < k2]
            if kills:
                kill = min(kills, key=lambda f: f.k)
                plan = inject.current_plan()
                if plan is not None:
                    plan.consume_fault(kill)
                if kill.in_segment and kill.k > k:
                    # step-level arm: the machine really runs [k, kill.k) and
                    # dies there; the live carry is dropped with it
                    _seg_dispatch(op, st, d, k, kill.k)
                    count("ft.ckpt_inseg_kills", op)
                count("ft.ckpt_kills", op)
                count("ft.ckpt_lost_steps", op, float(kill.k - k))
                fence()  # an in-flight host copy survives the preemption
                raise Preempted(op, kill.k, last)
            _seg_dispatch(op, st, d, k, k2)
            k = k2
            if k < nt:
                if async_snap:
                    fence()  # the previous copy fences only now, one interval late
                    pending = _PendingSnapshot(op, d, st, k, every, bi, pi, growth_abort, True)
                    count("ft.ckpt_async_snapshots", op)
                else:
                    last = _snapshot(op, d, st, k, every, bi, pi, growth_abort)
        fence()  # account the final interior snapshot's overlap and bytes
    return _finish(op, d, st)


# ---------------------------------------------------------------------------
# Public drivers (Option.Checkpoint off calls the plain drivers untouched)
# ---------------------------------------------------------------------------


def _check_square(a: DistMatrix, who: str, num_monitor) -> None:
    if a.mt != a.nt:
        raise ValueError(f"{who} needs a square tile grid")
    a.require_diag_pad(who)
    _check_num_monitor(num_monitor, who)


@instrument("potrf_ckpt")
def potrf_ckpt(a: DistMatrix, every=None, bcast_impl: Optional[str] = None,
               panel_impl: Optional[str] = None, num_monitor: Optional[str] = None,
               async_snapshots=None):
    """Checkpointed mesh Cholesky: ``potrf_dist``'s results (bitwise) with
    the carry snapshotted every ``every`` steps (Option.Checkpoint; None
    resolves the env chain, and off calls ``potrf_dist`` untouched).
    Returns (L DistMatrix, info); raises ``Preempted`` under an armed kill
    fault.  ``async_snapshots`` resolves the SLATE_TPU_CKPT_ASYNC chain:
    overlap the snapshot copy with the next segment (bitwise either way)."""
    ev = resolve_checkpoint(every)
    if ev is None:
        return potrf_dist(a, bcast_impl=bcast_impl, panel_impl=panel_impl,
                          num_monitor=num_monitor)
    _check_square(a, "potrf_ckpt", num_monitor)
    return _run("potrf", a, 0, ev, resolve_bcast_impl(bcast_impl),
                resolve_panel_impl(panel_impl), async_snap=resolve_ckpt_async(async_snapshots))


@instrument("getrf_nopiv_ckpt")
def getrf_nopiv_ckpt(a: DistMatrix, every=None, bcast_impl: Optional[str] = None,
                     panel_impl: Optional[str] = None, num_monitor: Optional[str] = None,
                     async_snapshots=None, growth_abort: bool = True):
    """Checkpointed mesh LU without pivoting (``getrf_nopiv_dist``,
    bitwise).  Returns (LU DistMatrix, info).  ``growth_abort`` is
    ``slate_tpu``'s mid-loop growth gate of the monitored run; it is
    recorded in every snapshot and acts with ``num_monitor="on"``, which
    raises until the observability slice."""
    ev = resolve_checkpoint(every)
    if ev is None:
        return getrf_nopiv_dist(a, bcast_impl=bcast_impl, panel_impl=panel_impl,
                                num_monitor=num_monitor)
    _check_square(a, "getrf_nopiv_ckpt", num_monitor)
    return _run("getrf_nopiv", a, 0, ev, resolve_bcast_impl(bcast_impl),
                resolve_panel_impl(panel_impl), async_snap=resolve_ckpt_async(async_snapshots),
                growth_abort=growth_abort)


@instrument("getrf_pp_ckpt")
def getrf_pp_ckpt(a: DistMatrix, every=None, bcast_impl: Optional[str] = None,
                  num_monitor: Optional[str] = None, async_snapshots=None):
    """Checkpointed partial-pivot mesh LU (``getrf_pp_dist``, bitwise): the
    carry also snapshots the replicated row permutation.  Returns (LU
    DistMatrix, perm, info).  The panel lowering is the resolved
    Option.PanelImpl chain, as ``getrf_pp_dist``'s default."""
    ev = resolve_checkpoint(every)
    if ev is None:
        return getrf_pp_dist(a, bcast_impl=bcast_impl, num_monitor=num_monitor)
    _check_square(a, "getrf_pp_ckpt", num_monitor)
    return _run("getrf_pp", a, 0, ev, resolve_bcast_impl(bcast_impl), resolve_panel_impl(),
                async_snap=resolve_ckpt_async(async_snapshots))


@instrument("geqrf_ckpt")
def geqrf_ckpt(a: DistMatrix, every=None, bcast_impl: Optional[str] = None,
               async_snapshots=None, num_monitor: Optional[str] = None):
    """Checkpointed distributed CAQR: ``geqrf_dist``'s results (bitwise)
    with the MULTI-ARRAY carry -- the flat local matrices, the
    per-(mesh row, panel) T_loc stack, the replicated tree V / T stacks --
    snapshotted every ``every`` panel steps.  Returns DistQR; raises
    ``Preempted`` under an armed kill fault.  The auxiliary carries are
    grid-locked: a resume needs the snapshot's own (p, q) grid shape."""
    ev = resolve_checkpoint(every)
    if ev is None:
        return geqrf_dist(a, bcast_impl=bcast_impl, num_monitor=num_monitor)
    if a.m < a.n:
        raise ValueError(f"geqrf_ckpt requires m >= n, got {a.m}x{a.n}")
    _check_num_monitor(num_monitor, "geqrf_ckpt")
    return _run("geqrf", a, 0, ev, resolve_bcast_impl(bcast_impl), resolve_panel_impl(),
                async_snap=resolve_ckpt_async(async_snapshots))


@instrument("he2hb_ckpt")
def he2hb_ckpt(a: DistMatrix, every=None, bcast_impl: Optional[str] = None,
               async_snapshots=None, num_monitor: Optional[str] = None):
    """Checkpointed two-stage eig stage-1 reduction: ``he2hb_dist``'s
    results (bitwise) with the multi-array carry -- the flat local
    matrices evolving toward the band, the reflector stack sharded over
    the mesh rows, the compact-WY stack -- snapshotted every ``every``
    panel steps.  Returns DistTwoStage; raises ``Preempted`` under an
    armed kill fault.  Grid-locked carry, as geqrf_ckpt's."""
    ev = resolve_checkpoint(every)
    if a.m != a.n:
        raise ValueError("he2hb_ckpt needs a square matrix")
    if ev is None or _he2hb_panel_count(a.n, a.nb) == 0:
        return he2hb_dist(a, bcast_impl=bcast_impl, num_monitor=num_monitor)
    _check_num_monitor(num_monitor, "he2hb_ckpt")
    return _run("he2hb", a, 0, ev, resolve_bcast_impl(bcast_impl), resolve_panel_impl(),
                async_snap=resolve_ckpt_async(async_snapshots))
