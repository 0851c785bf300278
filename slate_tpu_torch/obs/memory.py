"""Measured device-memory observability: one call's traced allocation
bytes, live-tensor / allocator sampling at span boundaries, and OOM
forensics.

Counterpart of ``slate_tpu/obs/memory.py`` (the measured sibling of
``obs.memmodel``).  Three surfaces:

- **Traced call** -- ``traced_memory(fn, *args)`` runs ``fn`` once under a
  ``TorchDispatchMode`` that tallies every storage an op creates and when
  its last tensor dies, and returns the call's ``arg`` / ``out`` / ``temp``
  / ``alias`` bytes.  It is the port's counterpart of ``slate_tpu``'s
  ``aot_memory_analysis`` (XLA's compile-time buffer assignment), which has
  no eager counterpart because nothing compiles: ``temp`` is the peak over
  the call of the bytes that are neither an argument nor an output,
  ``alias`` the outputs that share storage with an argument.  A kernel
  wrapper counts as one op (``opaque_call``): only what it returns is tallied,
  so the numbers are the same whether a wrapper launches its CUDA kernel
  or runs its plain twin, and deterministic at a fixed shape.
- **Live sampling** -- while observability is on (``SLATE_TPU_OBS=1``),
  every top-level ``driver_span`` exit and every flight row records the
  live bytes (``torch.cuda.memory_allocated`` on the card; the live
  tensors' storages, deduplicated, on the CPU -- the counterpart of
  ``jax.live_arrays()``) and the allocator's counters
  (``torch.cuda.memory_stats``; none on the CPU) into the metrics
  registry, the RunReport ``mem`` section and the sample list the Perfetto
  exporter renders as counter tracks.  Disabled, this module is never
  consulted: ``LIVE_CALLS`` and ``STATS_CALLS`` stay 0.
- **OOM forensics** -- ``handle_driver_exception`` (wired into
  ``obs.instrument``, enabled or not) recognizes
  ``torch.cuda.OutOfMemoryError``, writes one report to stderr per failure
  (the innermost instrumented driver's) naming the largest live tensors,
  the allocator's counters and the model's predicted peak, and lets the
  exception propagate.

``slate_tpu``'s donation-alias verification (``donation_alias_bytes``)
reads its ``analysis/`` donation registry, which the port does not have
yet; the traced ``alias_bytes`` is what a donation would show.
"""

from __future__ import annotations

import gc
import itertools
import os
import sys
import threading
import time
import weakref
from typing import Callable, Dict, List, Tuple

import torch

from .metrics import REGISTRY

# bounded sample stream for the Perfetto memory counter tracks
SAMPLES: List[dict] = []
_SAMPLE_CAP = 4096
_lock = threading.Lock()

# test hooks: live-tensor scans and allocator-stats reads this module made
LIVE_CALLS = 0
STATS_CALLS = 0

# the forensics reports written this process (tests and chip_smoke count them)
OOM_REPORTS: List[str] = []

# mem.* outcome totals for the RunReport "mem" section (the ft / ir pattern)
_STATE = {
    "oom_events": 0.0,
    "samples": 0.0,
    "live_bytes_max": 0.0,
    "bytes_in_use_max": 0.0,
    "peak_bytes_in_use_max": 0.0,
}

SAMPLE_ENV = "SLATE_TPU_OBS_MEM_SAMPLE"
_FORCE: List[bool] = []


def reset() -> None:
    with _lock:
        SAMPLES.clear()
        OOM_REPORTS.clear()
        for k in _STATE:
            _STATE[k] = 0.0


def mem_counter_values() -> Dict[str, float]:
    """mem.* totals for the RunReport ``mem`` section; all-zero (no
    sampling, no OOM this run) stays out of the report comparison."""
    with _lock:
        return dict(_STATE)


def sampling_active() -> bool:
    """Live sampling runs while observability is enabled and the env has
    not opted out (``SLATE_TPU_OBS_MEM_SAMPLE=0``), or when a test / smoke
    forced it."""
    if _FORCE:
        return _FORCE[-1]
    from . import span as _span

    if not _span.enabled():
        return False
    return os.environ.get(SAMPLE_ENV, "") != "0"


class force_sampling:
    """Context manager pinning sampling on (tests, memwatch) or off,
    independent of the obs switch."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        _FORCE.append(self.on)
        return self

    def __exit__(self, *exc):
        _FORCE.pop()
        return False


# ---------------------------------------------------------------------------
# The traced call (the port's counterpart of the AOT memory analysis)
# ---------------------------------------------------------------------------


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    tiles = getattr(x, "tiles", None)  # DistMatrix
    if isinstance(tiles, torch.Tensor):
        return [tiles]
    if hasattr(x, "_fields"):  # the drivers' NamedTuples
        return [t for v in x for t in _tensors(v)]
    return []


def _skey(t: torch.Tensor) -> Tuple[str, int]:
    st = t.untyped_storage()
    return str(t.device), st.data_ptr()


def _snbytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


_TRACER: List["_Tally"] = []


def _make_tally_mode():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __init__(self, tally):
            super().__init__()
            self.tally = tally

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not self.tally.opaque:
                self.tally.note(out)
            return out

    return _Mode


class _Tally:
    """The allocation tally of one traced call: every storage an op makes
    is an event (+ bytes) and its death (the last tensor referencing it
    that this tally saw is collected) another (- bytes)."""

    def __init__(self, arg_keys):
        self.arg_keys = set(arg_keys)
        self.live: Dict[Tuple[str, int], list] = {}  # key -> [id, nbytes, refs]
        self.events: List[Tuple[int, int]] = []  # (storage id, +/- bytes)
        self.next_id = 0
        self.opaque = 0

    def note(self, out) -> None:
        for t in _tensors(out):
            if t.device.type == "meta":
                continue
            key = _skey(t)
            if key in self.arg_keys or key[1] == 0:
                continue
            ent = self.live.get(key)
            if ent is None:
                nb = _snbytes(t)
                ent = self.live[key] = [self.next_id, nb, 0]
                self.next_id += 1
                self.events.append((ent[0], nb))
            ent[2] += 1
            weakref.finalize(t, self._release, key, ent[0])

    def _release(self, key, sid) -> None:
        ent = self.live.get(key)
        if ent is None or ent[0] != sid:
            return
        ent[2] -= 1
        if ent[2] == 0:
            del self.live[key]
            self.events.append((sid, -ent[1]))

    def peak_excluding(self, skip) -> int:
        cur = peak = 0
        for sid, nb in self.events:
            if sid in skip:
                continue
            cur += nb
            peak = max(peak, cur)
        return peak


def opaque_call(fn: Callable) -> Callable:
    """Count ``fn`` as one op of a traced call: only what it returns is
    tallied (the kernel wrappers use it, so that a wrapper's launch and
    its plain twin tally alike).  A plain call when nothing is traced."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _TRACER:
            return fn(*args, **kwargs)
        from torch.utils._python_dispatch import _disable_current_modes

        tally = _TRACER[-1]
        tally.opaque += 1
        try:
            with _disable_current_modes():  # the region's own ops go untraced
                out = fn(*args, **kwargs)
        finally:
            tally.opaque -= 1
        if not tally.opaque:
            tally.note(out)
        return out

    return wrapper


def traced_memory(fn: Callable, *args, **kwargs) -> Tuple[Dict[str, float], object]:
    """Run ``fn(*args, **kwargs)`` once and tally its allocations.  Returns
    ({arg_bytes, out_bytes, temp_bytes, alias_bytes, peak_bytes}, the
    call's result).  ``arg_bytes``: the argument tensors' storages;
    ``out_bytes``: the result's storages made during the call;
    ``alias_bytes``: the result's storages that are an argument's;
    ``temp_bytes``: the peak of everything else made during the call;
    ``peak_bytes`` = arg + out + temp, ``slate_tpu``'s decomposition."""
    arg_t = _tensors(list(args) + list(kwargs.values()))
    arg_keys = {}
    for t in arg_t:
        arg_keys.setdefault(_skey(t), _snbytes(t))
    tally = _Tally(arg_keys)
    mode = _make_tally_mode()(tally)
    # no cycle collection during the call: a storage is released when its
    # last tensor's reference count drops, at the same point every run
    was_enabled = gc.isenabled()
    gc.disable()
    _TRACER.append(tally)
    try:
        with mode:
            out = fn(*args, **kwargs)
    finally:
        _TRACER.pop()
        if was_enabled:
            gc.enable()
    out_ids, out_bytes, alias = set(), 0, {}
    for t in _tensors(out):
        key = _skey(t)
        if key in arg_keys:
            alias[key] = arg_keys[key]
            continue
        ent = tally.live.get(key)
        if ent is not None and ent[0] not in out_ids:
            out_ids.add(ent[0])
            out_bytes += ent[1]
    temp = tally.peak_excluding(out_ids)
    argb = float(sum(arg_keys.values()))
    res = {"arg_bytes": argb, "out_bytes": float(out_bytes), "temp_bytes": float(temp),
           "alias_bytes": float(sum(alias.values()))}
    res["peak_bytes"] = res["arg_bytes"] + res["out_bytes"] + res["temp_bytes"]
    return res, out


# ---------------------------------------------------------------------------
# Live-tensor / allocator sampling
# ---------------------------------------------------------------------------


def _cuda_live() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def _live_tensors() -> List[torch.Tensor]:
    """Every tensor the garbage collector tracks.  Filtered by type() in C
    loops (a process with JAX loaded tracks ~270k objects): type() and not
    isinstance(), since some module-level objects warn when their
    __class__ is read."""
    objs = gc.get_objects()
    types = list(map(type, objs))
    tensor_types = {t for t in set(types) if issubclass(t, torch.Tensor)}
    return list(itertools.compress(objs, map(tensor_types.__contains__, types)))


def device_live_bytes() -> Tuple[float, Dict[str, float]]:
    """(total, per-device) resident bytes: on the card the caching
    allocator's ``memory_allocated`` per device; on the CPU the live
    tensors' storages, each counted once.  Counted in ``LIVE_CALLS``."""
    global LIVE_CALLS
    LIVE_CALLS += 1
    per: Dict[str, float] = {}
    if _cuda_live():
        for i in range(torch.cuda.device_count()):
            per[f"cuda:{i}"] = float(torch.cuda.memory_allocated(i))
        return sum(per.values()), per
    seen = set()
    for t in _live_tensors():
        try:
            if t.device.type == "meta":
                continue
            key = _skey(t)
            if key in seen or key[1] == 0:
                continue
            seen.add(key)
            per[key[0]] = per.get(key[0], 0.0) + float(_snbytes(t))
        except Exception:
            continue
    return sum(per.values()), per


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device allocator counters where the device keeps them:
    ``bytes_in_use`` / ``peak_bytes_in_use`` from the caching allocator's
    ``allocated_bytes.all`` current / peak, ``bytes_limit`` the card's
    total memory.  Empty on the CPU (as ``slate_tpu``'s CPU devices report
    none).  Counted in ``STATS_CALLS``."""
    global STATS_CALLS
    STATS_CALLS += 1
    out: Dict[str, Dict[str, float]] = {}
    if not _cuda_live():
        return out
    for i in range(torch.cuda.device_count()):
        st = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": float(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(st.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": float(torch.cuda.get_device_properties(i).total_memory),
        }
    return out


def sample(tag: str, **extra) -> dict:
    """Record one memory sample (live bytes + allocator counters) into
    the bounded sample stream, the metrics registry (``mem.*`` gauges) and
    the running maxima of the RunReport ``mem`` section."""
    from . import context as _context

    live, per_live = device_live_bytes()
    stats = device_memory_stats()
    s = {
        "t": time.perf_counter(),
        "tag": tag,
        "live_bytes": live,
        "live_per_device": per_live,
        "bytes_in_use": {d: v.get("bytes_in_use", 0.0) for d, v in stats.items()},
        "peak_bytes_in_use": {d: v.get("peak_bytes_in_use", 0.0) for d, v in stats.items()},
    }
    ctx = _context.current()
    if ctx is not None:
        s.setdefault("trace_id", ctx.trace_id)
        if ctx.tenant:
            s.setdefault("tenant", ctx.tenant)
    s.update(extra)
    tt = {"tenant": ctx.tenant} if ctx is not None and ctx.tenant else {}
    REGISTRY.gauge_set("mem.live_bytes", live, span=tag, **tt)
    in_use_max = max(s["bytes_in_use"].values(), default=0.0)
    peak_max = max(s["peak_bytes_in_use"].values(), default=0.0)
    if stats:
        REGISTRY.gauge_set("mem.bytes_in_use_max", in_use_max, span=tag, **tt)
        REGISTRY.gauge_set("mem.peak_bytes_in_use_max", peak_max, span=tag, **tt)
    with _lock:
        _STATE["samples"] += 1
        _STATE["live_bytes_max"] = max(_STATE["live_bytes_max"], live)
        _STATE["bytes_in_use_max"] = max(_STATE["bytes_in_use_max"], in_use_max)
        _STATE["peak_bytes_in_use_max"] = max(_STATE["peak_bytes_in_use_max"], peak_max)
        if len(SAMPLES) < _SAMPLE_CAP:
            SAMPLES.append(s)
    # the live telemetry bus, only where obs.live was imported (a
    # sys.modules probe)
    _live = sys.modules.get(__package__ + ".live")
    if _live is not None:
        _live.publish("mem", s)
    return s


def sample_span(span) -> None:
    """driver_span exit hook: a top-level span's sample, with the live
    bytes (and the allocator's peak, where kept) in the span's metrics."""
    if span.depth != 0 or not sampling_active():
        return
    s = sample(span.name)
    span.metrics["mem.live_bytes"] = s["live_bytes"]
    peak = max(s["peak_bytes_in_use"].values(), default=0.0)
    if peak:
        span.metrics["mem.peak_bytes_in_use"] = peak


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------

_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory")


def is_oom(exc: BaseException) -> bool:
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def _fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.2f} {unit}" if unit != "B" else f"{b:.0f} B"
        b /= 1024
    return f"{b:.2f} GiB"


def _model_lines(driver: str, args) -> List[str]:
    """The MemoryModel's predicted peaks for the failing call: per device
    and for the virtual mesh on one card when its first operand is a
    DistMatrix of a modelled op, the f64 Cholesky residency models for the
    single-chip Cholesky drivers."""
    from . import memmodel

    lines = []
    a = args[0] if args else None
    op = next((o for o in memmodel.MODEL_OPS if driver.startswith(o)), None)
    if op == "getrf":
        op = None
    if op is not None and hasattr(a, "mesh") and hasattr(a, "nb"):
        from ..parallel.mesh import mesh_shape

        p, q = mesh_shape(a.mesh)
        m = memmodel.MemoryModel(op, a.n, a.nb, (p, q), str(a.dtype).replace("torch.", ""))
        lines.append(f"   model peak [{op} n={a.n} nb={a.nb} {p}x{q}]: "
                     f"{_fmt_bytes(m.peak_bytes)} per device, "
                     f"{_fmt_bytes(m.virtual_peak_bytes)} for the virtual mesh on one card")
    if any(k in driver for k in ("potrf", "posv", "chol")) and isinstance(a, torch.Tensor):
        n = int(a.shape[0])
        isz = a.element_size()
        lines.append(f"   predicted f64 peaks at n={n} [fused_ll / staged / ozaki_cache]: "
                     f"{_fmt_bytes(memmodel.potrf_fused_ll_peak(n, isz))} / "
                     f"{_fmt_bytes(memmodel.potrf_staged_peak(n, isz))} / "
                     f"{_fmt_bytes(memmodel.potrf_ozaki_cache_peak(n))}")
    return lines


def oom_report_text(driver: str, exc: BaseException, args=(), top: int = 12) -> str:
    """The forensics report: the allocator's counters, the largest live
    tensors, the model's predicted peaks and the escape routes."""
    from . import memmodel

    lines = [f"== slate_tpu_torch OOM forensics: {driver} ==",
             f"   {type(exc).__name__}: {str(exc)[:400]}"]
    for d, v in sorted(device_memory_stats().items())[:8]:
        lines.append(f"   {d}: in_use={_fmt_bytes(v.get('bytes_in_use', 0))} "
                     f"peak={_fmt_bytes(v.get('peak_bytes_in_use', 0))} "
                     f"limit={_fmt_bytes(v.get('bytes_limit', 0))}")
    global LIVE_CALLS
    LIVE_CALLS += 1
    sized, seen = [], set()
    for t in _live_tensors():
        try:
            key = _skey(t)
            if key in seen or key[1] == 0:
                continue
            seen.add(key)
            sized.append((_snbytes(t), tuple(t.shape), str(t.dtype), str(t.device)))
        except Exception:
            continue
    sized.sort(key=lambda r: -r[0])
    lines.append(f"   live storages: {len(sized)}, {_fmt_bytes(sum(r[0] for r in sized))} "
                 "total; largest:")
    for nb, shape, dt, dev in sized[:top]:
        lines.append(f"     {str(shape):>24} {dt:<16} {_fmt_bytes(float(nb))} on {dev}")
    try:
        lines += _model_lines(driver, args)
    except Exception as e:  # the model must never mask the report
        lines.append(f"   (model unavailable: {type(e).__name__})")
    lines.append(f"   model budget: override via {memmodel.HBM_ENV}")
    lines += [
        "   escape routes:",
        "     - Option.Lookahead=0: each depth unit pins extra panel payloads "
        "live (comm.la_live_buffers)",
        "     - smaller nb: panel payloads scale with nb^2 "
        "(memmodel.MemoryModel.payload_bytes)",
        "     - overwrite_a=True on the *_dist drivers: factor the input's "
        "tile stack in place instead of a copy",
        "     - feasibility up front: memmodel.predict_max_n(budget)",
    ]
    return "\n".join(lines)


def handle_driver_exception(driver: str, exc: BaseException, args=()) -> None:
    """Dispatch-layer hook (``obs.instrument``): on an out-of-memory
    failure, count it and write the forensics report to stderr.  One
    report per exception object: nested instrumented drivers see the same
    exception unwind through each layer, and the innermost (the first to
    see it) writes the report.  Never raises; the caller re-raises."""
    if not is_oom(exc):
        return
    if getattr(exc, "_slate_oom_reported", False):
        return
    try:
        exc._slate_oom_reported = True  # type: ignore[attr-defined]
    except Exception:
        pass
    with _lock:
        _STATE["oom_events"] += 1
    REGISTRY.counter_add("mem.oom_events", 1, span=driver)
    text = oom_report_text(driver, exc, args)
    OOM_REPORTS.append(text)
    print(text, file=sys.stderr, flush=True)
