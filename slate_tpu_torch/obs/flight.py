"""Step-level flight recorder: per-k-step, per-phase, per-device timelines
of the mesh k-loops.

Counterpart of ``slate_tpu/obs/flight.py``.  A driver is one span to
``obs.span``; this module is the layer below it, the reference's per-task
Gantt traces of panel / bcast / update (Trace.hh) for the six mesh loops
of ``FLIGHT_OPS``: ``summa.gemm_summa`` (GemmC), ``dist_chol.potrf_dist``,
``dist_lu.getrf_nopiv_dist``, ``dist_trsm.trsm_dist`` (TrsmB),
``dist_qr.geqrf_dist`` and ``dist_twostage.he2hb_dist``.

Step dispatch (``SLATE_TPU_OBS_DEEP=1`` or ``flight_scope()``): in
``slate_tpu`` each phase of a step is its own jitted program, fenced.  The
port's loops already run eagerly, so the step dispatch is the plain
driver's own loop: the phase markers of ``parallel.comm`` (``phase_scope``
and ``flight_row``) open one row per phase, and each row is fenced on the
card (``torch.cuda.synchronize``) and stamped by the host clock at both
ends.  Each row records one ``StepEvent(op, k, phase, device_coord, t0,
t1, bytes, flops)`` per mesh coordinate: ``bytes`` the row's audited
bytes (the schedule records made inside it), ``flops`` closed-form counts
from the phase's shapes.  The results are bitwise the plain driver's at
the same depth: it is the same loop.

Rows follow ``slate_tpu``'s issue order: the update a step defers is a
``bulk`` row of the step whose payload it applies, and the update work of
one step issued back to back (a bucket's drain and the next bucket's first
narrow update, which applies the zero payload that stands for it) is one
row.  Work outside every row (the zero-payload updates of the first step,
the info reduction, the pad fix-up) is not recorded.

The fences serialize the card with the host, so the recorder measures
per-phase costs, not achieved concurrency: the overlap and critical-path
numbers come from applying the lookahead issue order to the measured
durations (``obs.schedule.analyze``).  On one card a ``bcast`` row is
indexing: its time is fence and host overhead, not wire time.

Off by default: with the environment variable unset and no scope open,
``step_dispatch_active()`` is False and the drivers do nothing more.

CLI::

    python -m slate_tpu_torch.obs.flight potrf [--n 96] [--nb 8] [--depth 1]
        [--impl auto] [--hops] [--out FLIGHT.json] [--trace TRACE.json]
        [--device cpu|cuda]
    python -m slate_tpu_torch.obs.flight --smoke [--out DIR] [--device cpu|cuda]

(artifacts in ``artifacts/obs_torch`` unless ``--out`` says otherwise).

The FlightReport (schema ``slate_tpu.obs.flight_report`` v1, the same as
``slate_tpu``'s) carries a ``values`` section with the ``sched.*`` keys, so
``python -m slate_tpu_torch.obs.report --check NEW OLD`` gates it like a
RunReport.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Any, List, NamedTuple, Optional, Tuple

DEEP_ENV = "SLATE_TPU_OBS_DEEP"
FLIGHT_SCHEMA = "slate_tpu.obs.flight_report"
FLIGHT_VERSION = 1
PHASES = ("panel", "bcast", "bulk")
FLIGHT_OPS = ("summa", "potrf", "getrf_nopiv", "trsm", "geqrf", "he2hb")
# strict-schedule ops: panel k + 1 reads the whole update of step k, so no
# lookahead exists; the flight records the depth-0 order and the overlap
# lens reads 0 by construction
_STRICT_OPS = ("geqrf", "he2hb")
# the factor loops' pipelining caps at depth 1
_FACTOR_OPS = ("potrf", "getrf_nopiv")

# bound on recorded events / hop-event groups
_EVENT_CAP = 200_000
# the CLI's default artifact directory (slate_tpu's is artifacts/obs)
OUT_DIR = os.path.join("artifacts", "obs_torch")


class StepEvent(NamedTuple):
    """One row of the timeline as seen from one mesh coordinate: ``t0`` /
    ``t1`` are the host stamps after the fences (the same for every
    coordinate of the row), ``bytes`` and ``flops`` this device's share."""

    op: str
    k: int
    phase: str
    device_coord: Tuple[int, int]
    t0: float
    t1: float
    bytes: float
    flops: float
    trace_id: str = ""
    tenant: str = ""


class FlightRecorder:
    """Collects StepEvents plus the per-row hop schedules (src -> dst
    pairs) the Perfetto exporter renders as flow arrows."""

    def __init__(self) -> None:
        self.events: List[StepEvent] = []
        self.hop_events: List[dict] = []  # {op, k, phase, root_k, t0, t1, hops}
        self.runs: List[dict] = []
        # obs.memory samples taken at each row's close while memory
        # sampling is active: the memory counter track beside the Gantt
        self.mem_samples: List[dict] = []

    def record_phase(self, op, k, phase, t0, t1, nbytes, flops, coords,
                     hops=None, root_k=None) -> None:
        from . import context as _context

        ctx = _context.current()
        trace_id = ctx.trace_id if ctx is not None else ""
        tenant = (ctx.tenant or "") if ctx is not None else ""
        share = max(1, len(coords))
        if len(self.events) + share <= _EVENT_CAP:
            for rc in coords:
                self.events.append(StepEvent(
                    op, int(k), phase, tuple(rc), float(t0), float(t1),
                    float(nbytes) / share, float(flops) / share, trace_id, tenant))
        if hops and len(self.hop_events) < _EVENT_CAP:
            # root_k: the logical step owning the row's broadcasts; the hop
            # pairs are stored relative to it (root 0), as slate_tpu's are
            he = {"op": op, "k": int(k), "phase": phase,
                  "root_k": int(k if root_k is None else root_k),
                  "t0": float(t0), "t1": float(t1), "hops": hops}
            if trace_id:
                he["trace_id"] = trace_id
            self.hop_events.append(he)

    def note_run(self, **meta) -> None:
        self.runs.append(meta)

    def clear(self) -> None:
        self.events.clear()
        self.hop_events.clear()
        self.runs.clear()
        self.mem_samples.clear()


# ---------------------------------------------------------------------------
# Activation: scope > environment.  ``no_flight`` pins it off.
# ---------------------------------------------------------------------------

_OFF = object()
_SCOPE: List[Any] = []
_ENV_RECORDER: Optional[FlightRecorder] = None


def _env_deep() -> bool:
    return os.environ.get(DEEP_ENV, "") not in ("", "0")


def active_recorder() -> Optional[FlightRecorder]:
    """The recorder the step dispatch feeds, or None when recording is off."""
    if _SCOPE:
        top = _SCOPE[-1]
        return None if top is _OFF else top
    if _env_deep():
        global _ENV_RECORDER
        if _ENV_RECORDER is None:
            _ENV_RECORDER = FlightRecorder()
        return _ENV_RECORDER
    return None


def step_dispatch_active() -> bool:
    """True when the six flown drivers should record their k-loops."""
    return active_recorder() is not None


@contextlib.contextmanager
def flight_scope(recorder: Optional[FlightRecorder] = None):
    """Record the flown drivers called inside; yields the FlightRecorder."""
    rec = recorder if recorder is not None else FlightRecorder()
    _SCOPE.append(rec)
    try:
        yield rec
    finally:
        _SCOPE.pop()


@contextlib.contextmanager
def no_flight():
    """Record nothing inside (overrides the environment switch)."""
    from ..parallel import comm

    _SCOPE.append(_OFF)
    comm._STATE.flight.append(None)
    try:
        yield
    finally:
        comm._STATE.flight.pop()
        _SCOPE.pop()


class _Run:
    """One flown driver call: turns the phase markers of its loop into
    timeline rows.  A row is fenced and stamped when it opens and when it
    closes; an inner marker ends the enclosing row where it starts (the
    rest of the enclosing phase is not recorded), and a row that reopens
    the (k, phase) of the row closed just before it extends that row."""

    def __init__(self, rec: FlightRecorder, op: str, grid: Tuple[int, int]):
        self.rec, self.op, self.grid = rec, op, grid
        self.coords = [(r, c) for r in range(grid[0]) for c in range(grid[1])]
        self.sched: list = []  # comm's schedule records made during the run
        self.open: Optional[list] = None  # [phase, k, root_k, t0, i0, flops, token]
        self.pending: Optional[list] = None  # [phase, k, root_k, t0, t1, i0, i1, flops]

    @contextlib.contextmanager
    def row(self, phase: str, k, root_k=None):
        self._close()
        if k is None or int(k) < 0:  # nothing to attribute
            yield
            return
        token = object()
        self._open(phase, int(k), root_k, token)
        try:
            yield
        finally:
            self._close(token)

    def add_flops(self, flops: float) -> None:
        if self.open is not None:
            self.open[5] += float(flops)

    def _open(self, phase, k, root_k, token) -> None:
        from .span import fence

        fence()
        t0 = time.perf_counter()
        p = self.pending
        if p is not None and p[0] == phase and p[1] == k:
            self.open = [phase, k, p[2], p[3], p[5], p[7], token]
            self.pending = None
            return
        self._flush()
        self.open = [phase, k, k if root_k is None else int(root_k), t0, len(self.sched), 0.0, token]

    def _close(self, token=None) -> None:
        o = self.open
        if o is None or (token is not None and o[6] is not token):
            return
        from .span import fence

        fence()
        t1 = time.perf_counter()
        self.pending = [o[0], o[1], o[2], o[3], t1, o[4], len(self.sched), o[5]]
        self.open = None
        self._sample(o[0], o[1])

    def _sample(self, phase: str, k: int) -> None:
        """A memory sample after the row's fence, while sampling is active
        (``obs.memory``; the sampling switch is read only with obs on)."""
        from . import memory as _memory

        rec = self.rec
        if _memory.sampling_active() and len(rec.mem_samples) < _memory._SAMPLE_CAP:
            s = _memory.sample(f"flight:{self.op}:{phase}")
            rec.mem_samples.append(dict(s, k=int(k), phase=phase, op=self.op))

    def _flush(self) -> None:
        p = self.pending
        if p is None:
            return
        self.pending = None
        phase, k, root_k, t0, t1, i0, i1, flops = p
        recs = self.sched[i0:i1]
        hops = []
        for op_, nb, mult, _ph, _st, pairs in recs:
            if not pairs:
                continue
            size = self.grid[0] if "[p]" in op_ else self.grid[1]
            rot = root_k % size
            hops.append({"op": op_, "bytes": float(nb) * mult,
                         "pairs": [((s - rot) % size, (d - rot) % size) for s, d in pairs]})
        nbytes = float(sum(nb * mult for _, nb, mult, _, _, _ in recs))
        self.rec.record_phase(self.op, k, phase, t0, t1, nbytes, flops, self.coords,
                              hops=hops, root_k=root_k)

    def finish(self) -> None:
        self._close()
        self._flush()


@contextlib.contextmanager
def fly(op: str, grid: Tuple[int, int], **meta):
    """The drivers' step dispatch: while a recorder is active, the loop run
    inside records its rows under ``op`` (and ``meta`` is noted as the
    run's); otherwise nothing happens.  Yields the run, or None."""
    rec = active_recorder()
    if rec is None:
        yield None
        return
    from ..parallel import comm

    rec.note_run(op=op, grid=tuple(grid), **meta)
    run = _Run(rec, op, tuple(grid))
    outer = comm._STATE.flight[-1]
    if outer is not None:
        outer.finish()  # a flown driver inside another ends the outer's row
    comm._STATE.flight.append(run)
    try:
        yield run
    finally:
        comm._STATE.flight.pop()
        run.finish()


# ---------------------------------------------------------------------------
# End-to-end flight runs (CLI, smoke, dryrun, chip_smoke)
# ---------------------------------------------------------------------------


class _Gen:
    """Operand source of a flight case: numpy's generator (the operands of
    ``slate_tpu``'s ``_build_case``, draw for draw) or a torch generator on
    the mesh's device (full-size runs on the card)."""

    def __init__(self, kind: str, seed: int, device):
        import numpy as np
        import torch

        self.kind, self.device = kind, device
        if kind == "numpy":
            self.rng = np.random.default_rng(seed)
        elif kind == "torch":
            self.rng = torch.Generator(device=device).manual_seed(seed)
        else:
            raise ValueError(f"unknown operand source {kind!r}")

    def randn(self, shape):
        import numpy as np
        import torch

        if self.kind == "numpy":
            return torch.from_numpy(self.rng.standard_normal(shape).astype(np.float32)).to(self.device)
        return torch.randn(shape, generator=self.rng, device=self.device, dtype=torch.float32)

    def spd(self, a):
        """(a a^T / n + 2 I) in f32, as slate_tpu's case builds it."""
        import numpy as np
        import torch

        n = a.shape[0]
        if self.kind == "numpy":
            an = a.cpu().numpy()
            return torch.from_numpy((an @ an.T / n + 2 * np.eye(n)).astype(np.float32)).to(self.device)
        return torch.addmm(torch.eye(n, device=a.device, dtype=a.dtype), a, a.T,
                           beta=2.0, alpha=1.0 / n)


def _col_sample(n: int, cols: Optional[int], device):
    """Every column (None), or ``cols`` evenly spaced ones: the residuals'
    sample at full size on the card."""
    import torch

    if cols is None or cols >= n:
        return torch.arange(n, device=device)
    return torch.linspace(0, n - 1, cols, device=device).round().long().unique()


def _build_case(op: str, n: int, nb: int, mesh, gen: _Gen, m: Optional[int] = None,
                cols: Optional[int] = None):
    """Operands and closures of one flight op on ``mesh``: returns
    (run(depth, impl) -> result, verify(result) -> residual, nt).  The
    residuals are ``slate_tpu``'s, over the sampled columns ``cols`` (all
    by default)."""
    import torch

    from ..parallel import from_dense, to_dense
    from ..parallel.dist_chol import potrf_dist
    from ..parallel.dist_lu import getrf_nopiv_dist
    from ..parallel.dist_trsm import trsm_dist
    from ..parallel.summa import gemm_summa
    from ..types import MethodGemm, MethodTrsm, Op, Uplo

    dev = mesh.device
    amax = lambda x: float(x.abs().max())  # noqa: E731

    if op == "geqrf":
        from ..parallel.dist_qr import geqrf_dist

        mm = n if m is None else m
        a = gen.randn((mm, n))
        ad = from_dense(a, mesh, nb)

        def run(depth, impl):
            # strict schedule: the panel chain has no lookahead reorder
            return geqrf_dist(ad, bcast_impl=impl)

        def verify(res):
            # R^H R == A^H A for any QR of A (no Q needed)
            r_up = torch.triu(to_dense(res.fact))[:n, :n]
            j = _col_sample(n, cols, dev)
            ref = a.T @ a[:, j]
            return float((r_up.T @ r_up[:, j] - ref).abs().max() / (amax(ref) + 1e-30))

        return run, verify, ad.nt
    if m is not None and m != n:
        raise ValueError(f"flight op {op!r} is square; m = {m} is for geqrf")
    a = gen.randn((n, n))
    if op == "summa":
        b = gen.randn((n, n))
        ad, bd = from_dense(a, mesh, nb), from_dense(b, mesh, nb)

        def run(depth, impl):
            return gemm_summa(1.0, ad, bd, method=MethodGemm.GemmC, lookahead=depth,
                              bcast_impl=impl)

        def verify(res):
            j = _col_sample(n, cols, dev)
            ref = a @ b[:, j]
            return float((to_dense(res)[:, j] - ref).abs().max() / (amax(ref) + 1e-30))

        return run, verify, ad.nt
    if op == "potrf":
        spd = gen.spd(a)
        del a
        sd = from_dense(spd, mesh, nb, diag_pad_one=True)

        def run(depth, impl):
            return potrf_dist(sd, lookahead=depth, bcast_impl=impl)

        def verify(res):
            fac, info = res
            if int(info) != 0:
                return float("inf")
            lt = torch.tril(to_dense(fac))
            j = _col_sample(n, cols, dev)
            return float((lt @ lt.T[:, j] - spd[:, j]).abs().max() / amax(spd))

        return run, verify, sd.nt
    if op == "getrf_nopiv":
        up = gen.randn((n, n))
        dd = torch.tril(a) + n * torch.eye(n, device=dev) + torch.triu(up, 1)
        del a, up
        gd = from_dense(dd, mesh, nb, diag_pad_one=True)

        def run(depth, impl):
            return getrf_nopiv_dist(gd, lookahead=depth, bcast_impl=impl)

        def verify(res):
            lu, info = res
            if int(info) != 0:
                return float("inf")
            lun = to_dense(lu)
            j = _col_sample(n, cols, dev)
            lo = torch.tril(lun, -1) + torch.eye(n, device=dev)
            return float((lo @ torch.triu(lun)[:, j] - dd[:, j]).abs().max() / amax(dd))

        return run, verify, gd.nt
    if op == "trsm":
        tl = torch.tril(a) + n * torch.eye(n, device=dev)
        del a
        td = from_dense(tl, mesh, nb, diag_pad_one=True)
        b = gen.randn((n, n))
        bd = from_dense(b, mesh, nb)

        def run(depth, impl):
            return trsm_dist(td, bd, Uplo.Lower, Op.NoTrans, method=MethodTrsm.TrsmB,
                             lookahead=depth, bcast_impl=impl)

        def verify(res):
            x = to_dense(res)
            j = _col_sample(n, cols, dev)
            return float((tl @ x[:, j] - b[:, j]).abs().max()
                         / (amax(tl) * max(amax(x), 1e-30) * n))

        return run, verify, td.nt
    if op == "he2hb":
        from ..linalg.eig import _he2hb_panel_count
        from ..parallel.dist_twostage import he2hb_dist

        spd = gen.spd(a)
        del a
        sd = from_dense(spd, mesh, nb)

        def run(depth, impl):
            return he2hb_dist(sd, bcast_impl=impl)

        def verify(res):
            # the two-sided orthogonal reduction keeps the Frobenius norm
            band = to_dense(res.band)
            fa = float(torch.linalg.norm(spd))
            return float(abs(float(torch.linalg.norm(band)) - fa) / fa)

        return run, verify, _he2hb_panel_count(n, nb)
    raise ValueError(f"unknown flight op {op!r}; expected one of {FLIGHT_OPS}")


def _tensors(x) -> list:
    """The tensors of a driver's result (tuples, DistMatrix, NamedTuples)."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if hasattr(x, "tiles") and hasattr(x, "mesh"):
        return [x.tiles]
    if isinstance(x, tuple):
        return [t for e in x for t in _tensors(e)]
    return []


def bitwise_equal(x, y) -> bool:
    """True when two driver results hold the same tensors bit for bit."""
    import torch

    tx, ty = _tensors(x), _tensors(y)
    return len(tx) == len(ty) and all(
        a.shape == b.shape and a.dtype == b.dtype
        and torch.equal(a.view(torch.uint8) if a.is_floating_point() or a.is_complex() else a,
                        b.view(torch.uint8) if b.is_floating_point() or b.is_complex() else b)
        for a, b in zip(tx, ty))


def default_mesh(device: Optional[str] = None):
    """The flight's 2 x 4 mesh on the card, or on the host when asked
    (``device="cpu"``); raises without a card otherwise."""
    import torch

    from ..parallel import make_mesh

    device = device or "cuda"
    if str(device).startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("the flight runs on the card by default and no CUDA device is "
                           "available; pass device='cpu' (--device cpu) for a host run")
    return make_mesh(2, 4, device=device)


def run_flight(op: str, n: int = 96, nb: int = 8, depth: Optional[int] = None,
               bcast_impl: Optional[str] = None, hops: bool = False, mesh=None, seed: int = 0,
               m: Optional[int] = None, device: Optional[str] = None, gen: str = "numpy",
               cols: Optional[int] = None) -> dict:
    """One complete flight: the static schedule model from the plain
    driver (``sched_audit``), the flown run at the requested depth, the
    depth-0 run for the overlap contrast (the pipelined ops) and, with
    ``hops``, the psum lowering for the ring-vs-psum hop delta; analysed,
    as a FlightReport dict.  ``mesh`` None is a 2 x 4 mesh on ``device``
    (the card by default).  ``gen`` picks the operands: ``numpy`` draws
    ``slate_tpu``'s, ``torch`` makes them on the device; ``cols`` samples
    the residual's columns.  The report's ``bitwise_plain`` says whether
    the flown result equals the plain driver's bit for bit.

    Operands are made before the first run and the residual, in plain
    torch ops, after the flown one: the hand kernels launch only in the
    driver runs (plain, flown, the depth-0 contrast of a pipelined op and,
    with ``hops``, the two psum runs)."""
    import torch

    from ..parallel.comm import la_depth, resolve_bcast_impl, sched_audit
    from ..parallel.mesh import mesh_shape
    from . import schedule
    from .report import _env_info

    if mesh is None:
        mesh = default_mesh(device)
    p, q = mesh_shape(mesh)
    run, verify, nt = _build_case(op, n, nb, mesh, _Gen(gen, seed, mesh.device), m, cols)
    d = la_depth(depth, nt)
    if op in _FACTOR_OPS:
        d = min(d, 1)  # the depth that dispatches
    if op in _STRICT_OPS:
        d = 0
    impl = resolve_bcast_impl(bcast_impl)

    # the static model: the plain driver under the schedule capture
    with no_flight(), sched_audit() as sched_recs:
        plain = run(d, impl)
    model = schedule.ScheduleModel(op, nt, p, q, impl, list(sched_recs))

    # the measured timeline at the requested depth
    with flight_scope() as rec:
        res = run(d, impl)
    same = bitwise_equal(res, plain)
    del plain
    resid = verify(res)
    del res
    rows = schedule.rows_from_events(rec.events)
    sched = schedule.analyze(rows, d)

    if op in _STRICT_OPS:
        sched0 = sched
    else:
        with flight_scope() as rec0:
            r0 = run(0, impl)
        del r0
        sched0 = schedule.analyze(schedule.rows_from_events(rec0.events), 0)

    if hops and impl != "psum":
        with no_flight(), sched_audit() as psum_recs:
            r_ = run(d, "psum")
        del r_
        model_psum = schedule.ScheduleModel(op, nt, p, q, "psum", list(psum_recs))
        with flight_scope() as rec_psum:
            r_ = run(d, "psum")
        del r_
        hop_lat = schedule.hop_latency(rows, schedule.rows_from_events(rec_psum.events),
                                       model, model_psum)
        if hop_lat is not None:
            sched["hop_latency_s"] = hop_lat
    if torch.cuda.is_available() and str(mesh.device).startswith("cuda"):
        torch.cuda.synchronize()

    sched["overlap_eff_la0"] = sched0["overlap_eff"]
    sched["exposed_comm_s_la0"] = sched0["exposed_comm_s"]
    cal = schedule.calibrate(rows)
    model_steps = model.steps(cal, flops_by_phase=schedule.phase_flops(rows))

    base = min((e.t0 for e in rec.events), default=0.0)
    events = [
        {"op": e.op, "k": e.k, "phase": e.phase, "device": list(e.device_coord),
         "t0_s": e.t0 - base, "t1_s": e.t1 - base, "bytes": e.bytes, "flops": e.flops,
         **({"trace_id": e.trace_id} if e.trace_id else {}),
         **({"tenant": e.tenant} if e.tenant else {})}
        for e in rec.events
    ]
    hop_events = [
        {"op": h["op"], "k": h["k"], "phase": h["phase"], "root_k": h.get("root_k", h["k"]),
         "t0_s": h["t0"] - base, "t1_s": h["t1"] - base, "hops": h["hops"]}
        for h in rec.hop_events
    ]
    mem_samples = [
        {"t_s": s["t"] - base, "k": s.get("k", 0), "phase": s.get("phase", ""),
         "live_bytes": s.get("live_bytes", 0.0), "live_per_device": s.get("live_per_device") or {},
         "bytes_in_use": s.get("bytes_in_use") or {}}
        for s in rec.mem_samples
    ]
    values = {
        "sched.critical_path_s": sched["critical_path_s"],
        "sched.overlap_eff": sched["overlap_eff"],
        "sched.exposed_comm_s": sched["exposed_comm_s"],
        "sched.total_comm_s": sched["total_comm_s"],
        "sched.total_compute_s": sched["total_compute_s"],
        "sched.model_bytes": model.total_bytes,
        "sched.measured_bytes": sched["measured_bytes"],
        "resid": resid,
    }
    for ph, nbytes in model.phase_bytes.items():
        values[f"sched.model_{ph}_bytes"] = nbytes

    config = {"op": op, "n": n, "nb": nb, "grid": f"{p}x{q}", "lookahead": d,
              "bcast_impl": impl, "nt": nt}
    if op == "geqrf" and m is not None:
        config["m"] = m
    return {
        "schema": FLIGHT_SCHEMA,
        "version": FLIGHT_VERSION,
        "name": f"flight_{op}",
        "created_unix": time.time(),
        "env": _env_info(),
        "config": config,
        "events": events,
        "hop_events": hop_events,
        # the memory counter track's data: present (non-empty) when memory
        # sampling was active during the flight
        "mem_samples": mem_samples,
        "model": {
            "calibration": cal,
            "phase_bytes": dict(model.phase_bytes),
            "total_bytes": model.total_bytes,
            "steps": model_steps,
            # the flight runs the plain loop, bucket windows included, so the
            # measured bytes are the model's for every op
            "note": "exact",
        },
        "sched": sched,
        "values": values,
        "bitwise_plain": bool(same),
    }


def validate_flight_report(rep) -> List[str]:
    """Schema check for a FlightReport; returns problems (empty == valid)."""
    errs: List[str] = []
    if not isinstance(rep, dict):
        return ["flight report must be an object"]
    if rep.get("schema") != FLIGHT_SCHEMA:
        errs.append(f"schema must be {FLIGHT_SCHEMA!r}, got {rep.get('schema')!r}")
    if not isinstance(rep.get("version"), int):
        errs.append("version must be an int")
    if not isinstance(rep.get("name"), str) or not rep.get("name"):
        errs.append("name must be a non-empty string")
    cfg = rep.get("config")
    if not isinstance(cfg, dict) or cfg.get("op") not in FLIGHT_OPS:
        errs.append(f"config.op must be one of {FLIGHT_OPS}")
    evs = rep.get("events")
    if not isinstance(evs, list) or not evs:
        errs.append("events must be a non-empty list")
    else:
        for i, e in enumerate(evs):
            if not isinstance(e, dict):
                errs.append(f"events[{i}]: not an object")
                continue
            if e.get("phase") not in PHASES:
                errs.append(f"events[{i}]: bad phase {e.get('phase')!r}")
            if not isinstance(e.get("k"), int) or e["k"] < 0:
                errs.append(f"events[{i}]: bad k {e.get('k')!r}")
            if not (isinstance(e.get("t0_s"), (int, float))
                    and isinstance(e.get("t1_s"), (int, float))
                    and e["t1_s"] >= e["t0_s"] >= 0):
                errs.append(f"events[{i}]: bad t0_s/t1_s")
            dev = e.get("device")
            if not (isinstance(dev, (list, tuple)) and len(dev) == 2):
                errs.append(f"events[{i}]: bad device {dev!r}")
            if errs and len(errs) > 16:
                break
    sched = rep.get("sched")
    if not isinstance(sched, dict):
        errs.append("sched must be an object")
    else:
        for key in ("critical_path_s", "overlap_eff", "exposed_comm_s", "total_comm_s"):
            if not isinstance(sched.get(key), (int, float)):
                errs.append(f"sched.{key} must be a number")
        ov = sched.get("overlap_eff")
        if isinstance(ov, (int, float)) and not 0.0 <= ov <= 1.0:
            errs.append(f"sched.overlap_eff out of [0, 1]: {ov}")
    vals = rep.get("values")
    if not isinstance(vals, dict) or any(not isinstance(v, (int, float)) for v in vals.values()):
        errs.append("values must map metric name -> number")
    return errs


def write_flight_report(path: str, rep: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rep, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# CLI + smoke
# ---------------------------------------------------------------------------


def _smoke(out_dir: str, device: Optional[str] = None) -> int:
    """Tiny summa, potrf, geqrf and he2hb flights under psum and ring:
    schema-valid FlightReports, each result bitwise its plain driver, the
    Perfetto export valid with per-device tracks and hop flows, and
    overlap_eff above its depth-0 value (0) for the pipelined ops; the
    strict chains read 0."""
    from . import perfetto

    os.makedirs(out_dir, exist_ok=True)
    failures: List[str] = []
    n, nb = 64, 8
    mesh = default_mesh(device)
    for op in ("summa", "potrf", "geqrf", "he2hb"):
        strict = op in _STRICT_OPS
        reports = {}
        for impl in ("psum", "ring"):
            rep = run_flight(op, n=n, nb=nb, depth=1, bcast_impl=impl,
                             hops=(impl == "ring" and not strict), mesh=mesh)
            errs = validate_flight_report(rep)
            if errs:
                failures.append(f"{op}/{impl} schema: {errs[:4]}")
            if not rep["bitwise_plain"]:
                failures.append(f"{op}/{impl}: flown result differs from the plain driver's")
            if strict:
                if rep["sched"]["overlap_eff"] != 0.0:
                    failures.append(f"{op}/{impl}: strict-schedule overlap_eff "
                                    f"{rep['sched']['overlap_eff']:.3f} nonzero")
            elif rep["sched"]["overlap_eff"] <= rep["sched"]["overlap_eff_la0"]:
                failures.append(f"{op}/{impl}: overlap_eff {rep['sched']['overlap_eff']:.3f} does "
                                f"not exceed the depth-0 value {rep['sched']['overlap_eff_la0']:.3f}")
            if rep["sched"]["overlap_eff_la0"] != 0.0:
                failures.append(f"{op}/{impl}: depth-0 overlap_eff nonzero")
            if rep["values"]["resid"] > 1e-3:
                failures.append(f"{op}/{impl}: resid {rep['values']['resid']}")
            if rep["values"]["sched.measured_bytes"] != rep["model"]["total_bytes"]:
                failures.append(f"{op}/{impl}: measured bytes {rep['values']['sched.measured_bytes']}"
                                f" != model {rep['model']['total_bytes']}")
            reports[impl] = rep
        if not (reports["psum"]["model"]["total_bytes"] > 0
                and reports["ring"]["model"]["total_bytes"] > 0):
            failures.append(f"{op}: modeled bytes not positive")
        rep = reports["ring"]
        path = os.path.join(out_dir, f"flight_{op}.flight.json")
        write_flight_report(path, rep)
        trace_path = os.path.join(out_dir, f"flight_{op}.trace.json")
        tr = perfetto.flight_chrome_trace(rep["events"], rep["hop_events"], grid=(2, 4))
        with open(trace_path, "w") as f:
            json.dump(tr, f, indent=1)
        errs = perfetto.validate_chrome_trace(tr)
        if errs:
            failures.append(f"{op} trace schema: {errs[:4]}")
        tids = {e.get("tid") for e in tr["traceEvents"] if e.get("ph") == "X"}
        if len(tids) < 8:
            failures.append(f"{op} trace has {len(tids)} device tracks (< 8)")
        if not any(e.get("ph") == "s" for e in tr["traceEvents"]):
            failures.append(f"{op} trace has no hop flow events")
        print(f"obs.flight smoke: {op} ok — overlap_eff(la1)={rep['sched']['overlap_eff']:.3f} "
              f"vs la0={rep['sched']['overlap_eff_la0']:.3f}, "
              f"model {rep['model']['total_bytes']:,.0f} B -> {path}")
    if failures:
        print(f"obs.flight smoke: FAILED with {len(failures)} problem(s):")
        for msg in failures:
            print(f"  FAIL {msg}")
        return 1
    print(f"obs.flight smoke: OK — reports + traces in {out_dir}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.obs.flight", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("op", nargs="?", choices=FLIGHT_OPS, help="mesh loop to fly")
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--nb", type=int, default=8)
    ap.add_argument("--depth", type=int, default=None,
                    help="lookahead depth (default: Option.Lookahead)")
    ap.add_argument("--impl", default=None, help="bcast impl (psum|ring|doubling|auto)")
    ap.add_argument("--hops", action="store_true",
                    help="also run the psum lowering for the per-hop estimate")
    ap.add_argument("--out", default=None,
                    help="FlightReport path (default artifacts/obs_torch/flight_<op>.flight.json; "
                         "for --smoke: the artifact directory)")
    ap.add_argument("--trace", default=None,
                    help="also write a Perfetto Gantt (per-device tracks + hop flows)")
    ap.add_argument("--smoke", action="store_true",
                    help="the acceptance run (tiny summa, potrf, geqrf, he2hb under psum and ring)")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="the mesh's device (default: the card)")
    args = ap.parse_args(argv)

    if args.smoke:
        return _smoke(args.out or OUT_DIR, args.device)
    if not args.op:
        ap.error("give an op to fly or --smoke")

    rep = run_flight(args.op, n=args.n, nb=args.nb, depth=args.depth, bcast_impl=args.impl,
                     hops=args.hops, device=args.device)
    errs = validate_flight_report(rep)
    out = args.out or os.path.join(OUT_DIR, f"flight_{args.op}.flight.json")
    write_flight_report(out, rep)
    sched = rep["sched"]
    print(f"flight {args.op}: {sched['steps']} steps, depth {rep['config']['lookahead']}, "
          f"impl {rep['config']['bcast_impl']}")
    print(f"  critical_path_s {sched['critical_path_s']:.4f}  overlap_eff "
          f"{sched['overlap_eff']:.3f} (la0 {sched['overlap_eff_la0']:.3f})  "
          f"exposed_comm_s {sched['exposed_comm_s']:.4f}")
    print(f"  model bytes {rep['model']['total_bytes']:,.0f} "
          f"({', '.join(f'{k}={v:,.0f}' for k, v in rep['model']['phase_bytes'].items())})")
    if "hop_latency_s" in sched:
        print(f"  est. per-hop time {sched['hop_latency_s'] * 1e6:.1f} us")
    print(f"  wrote {out}")
    if args.trace:
        from . import perfetto

        tr = perfetto.flight_chrome_trace(
            rep["events"], rep["hop_events"],
            grid=tuple(int(x) for x in rep["config"]["grid"].split("x")))
        with open(args.trace, "w") as f:
            json.dump(tr, f, indent=1)
        print(f"  wrote {args.trace}")
    if errs:
        print("validation problems:")
        for e in errs:
            print(f"  {e}")
        return 2
    return 0


if __name__ == "__main__":
    # runpy loads this file as __main__, a second module instance whose
    # scope stack the drivers (which import slate_tpu_torch.obs.flight)
    # never see: run the canonical instance
    from slate_tpu_torch.obs import flight as _canonical

    sys.exit(_canonical.main())
