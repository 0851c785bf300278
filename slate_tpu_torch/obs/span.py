"""Driver spans: the nesting instrumentation context the port's drivers
flow through.

Counterpart of ``slate_tpu/obs/span.py``.  ``driver_span(name, **tags)``
times a region, nests (a thread-local stack), bridges the name into
``torch.profiler`` traces (``torch.profiler.record_function``, where
``slate_tpu`` uses ``jax.profiler.TraceAnnotation``) and absorbs the
comm-byte audit (``parallel.comm``): every audited verb called inside
lands in the metrics registry tagged with the span's name, and its per-hop
schedule records ride along for the Perfetto exporter.

Everything is gated on ``enable()`` / the ``SLATE_TPU_OBS`` environment
variable.  Disabled, a span is a shared null object and ``instrument``
calls the undecorated function straight through.  Enabled, a span fences
the card on entry and on exit (``torch.cuda.synchronize``), so that its
``wall_seconds`` on the card is the work's time and not the time to queue
it.

Two differences from ``slate_tpu`` follow from eager execution:

- ``slate_tpu`` audits comm bytes at trace time, so a jit cache hit
  records nothing; the port records every call, so a span's
  ``comm_bytes`` is what that call moves.
- there is no ahead-of-time compile: ``measure`` takes ``slate_tpu``'s
  fallback, a ``cold`` phase and an ``execute`` phase with
  ``compile_seconds`` by difference, and reports no ``flops`` (the
  XLA cost analysis has no counterpart).  Its span counts one call's
  bytes: the cold call's records stay in its own phase span.

The memory sampling at span boundaries and the OOM forensics of
``slate_tpu``'s spans come with the memory slice.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .metrics import REGISTRY, serve_reset

# finished-span records for the Perfetto exporter; bounded so a long run
# cannot grow without limit
_EVENT_CAP = 100_000

_enabled = os.environ.get("SLATE_TPU_OBS", "") not in ("", "0")
_tls = threading.local()

# finished spans as plain dicts (name, tags, t0, t1, depth, parent,
# metrics, hops)
FINISHED: List[dict] = []
_finished_lock = threading.Lock()


def enable() -> None:
    """Every instrumented driver starts recording spans and metrics (the
    ``SLATE_TPU_OBS=1`` switch)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


@contextlib.contextmanager
def force_enabled(value: bool = True):
    """Flip observability for the body."""
    global _enabled
    old, _enabled = _enabled, value
    try:
        yield
    finally:
        _enabled = old


def reset() -> None:
    """Drop the finished spans, the metrics and the flat serve counters (a
    fresh run boundary)."""
    with _finished_lock:
        FINISHED.clear()
    REGISTRY.reset()
    serve_reset()


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional["Span"]:
    st = _stack()
    return st[-1] if st else None


class Span:
    """One timed region.  ``set()`` attaches a scalar metric (also a gauge
    tagged span=name); ``phase()`` opens a nested child span and copies its
    duration up as ``<phase>_seconds``."""

    __slots__ = ("name", "tags", "t0", "t1", "depth", "parent", "metrics")

    def __init__(self, name: str, tags: Dict[str, Any], depth: int,
                 parent: Optional[str]):
        self.name = name
        self.tags = tags
        self.depth = depth
        self.parent = parent
        self.t0 = 0.0
        self.t1 = 0.0
        self.metrics: Dict[str, float] = {}

    def set(self, key: str, value: float) -> None:
        self.metrics[key] = float(value)
        REGISTRY.gauge_set(key, float(value), span=self.name)

    @contextlib.contextmanager
    def phase(self, pname: str):
        with driver_span(f"{self.name}:{pname}", phase=pname) as sp:
            yield sp
        if sp is not _NULL:
            self.metrics[f"{pname}_seconds"] = sp.t1 - sp.t0


class _NullSpan:
    """Shared no-op span handed out while observability is off."""

    __slots__ = ()
    name = ""
    tags: Dict[str, Any] = {}
    metrics: Dict[str, float] = {}
    t0 = t1 = 0.0

    def set(self, key: str, value: float) -> None:
        pass

    @contextlib.contextmanager
    def phase(self, pname: str):
        yield self


_NULL = _NullSpan()


def _comm_bytes(records) -> Dict[str, float]:
    """(op, payload_bytes, mult) records -> {op_base: total_bytes}."""
    by_op: Dict[str, float] = {}
    for op, nbytes, mult in records:
        base = op.split("[")[0]
        by_op[base] = by_op.get(base, 0.0) + float(nbytes) * mult
    return by_op


def fence() -> None:
    """Wait for the card (when one is in use): span boundaries and flight
    phases stamp the host clock after it."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def driver_span(name: str, **tags):
    """Open an observability span: nests, absorbs the comm audit, names
    the region in ``torch.profiler`` traces, fences the card at both ends.
    Yields the Span, or a shared null object when observability is off.

    The span stack is thread-local; the comm audit it absorbs is the
    process-wide one of ``parallel.comm``, so per-span bytes are right
    when one thread drives the mesh at a time (every driver here)."""
    if not _enabled:
        yield _NULL
        return

    import torch

    from ..parallel import comm  # lazy: obs does not import parallel at load
    from . import context as _context

    st = _stack()
    parent = st[-1] if st else None
    # a span opened under a TraceContext carries its trace_id (and tenant)
    ctx = _context.current()
    if ctx is not None:
        tags.setdefault("trace_id", ctx.trace_id)
        if ctx.tenant:
            tags.setdefault("tenant", ctx.tenant)
    span = Span(name, tags, len(st), parent.name if parent else None)
    st.append(span)

    # audited verbs called inside, re-appended outward on exit so that
    # enclosing audits (an outer span's, a comm audit tool's) see them all;
    # the schedule channel carries the per-hop (src, dst) pairs
    es = contextlib.ExitStack()
    records: list = []
    sched_records: list = []
    try:
        es.enter_context(torch.profiler.record_function(name))
        records = es.enter_context(comm.comm_audit(propagate=True))
        sched_records = es.enter_context(comm.sched_audit(propagate=True))
        fence()
        span.t0 = time.perf_counter()
        yield span
        fence()
    finally:
        span.t1 = time.perf_counter()
        es.close()
        st.pop()
        _finish(span, name, tags, ctx, records, sched_records)


def _finish(span: Span, name: str, tags: dict, ctx, records, sched_records) -> None:
    dur = span.t1 - span.t0
    span.metrics.setdefault("wall_seconds", dur)
    # per-tenant series only when a tenant-carrying context is ambient
    tt = {"tenant": ctx.tenant} if ctx is not None and ctx.tenant else {}
    REGISTRY.counter_add("span_count", 1, span=name, **tt)
    REGISTRY.observe("span_seconds", dur, span=name, **tt)
    total_comm = 0.0
    for op, nbytes in _comm_bytes(records).items():
        REGISTRY.counter_add("comm_bytes", nbytes, span=name, op=op, **tt)
        total_comm += nbytes
    span.metrics["comm_bytes"] = total_comm
    # the schedule records as sched.* series: per-hop link bytes where the
    # lowering has hop pairs, collective payload bytes otherwise
    for rec_op, rec_bytes, rec_mult, _ph, _st, rec_pairs in sched_records:
        REGISTRY.counter_add("sched.link_bytes" if rec_pairs else "sched.coll_bytes",
                             float(rec_bytes) * rec_mult, span=name,
                             op=rec_op.split("[")[0], **tt)
    # per-hop link records for the Perfetto exporter, bounded per span.  The
    # port's records carry a concrete step and the owner's own pairs
    # (slate_tpu's in-loop records carry step None and the root-0 pairs)
    hops = [{"op": op, "bytes": float(nbytes), "mult": mult, "step": step, "pairs": pairs}
            for op, nbytes, mult, _ph, step, pairs in sched_records if pairs][:64]
    record = {
        "name": name,
        "tags": {k: str(v) for k, v in tags.items()},
        "t0": span.t0,
        "t1": span.t1,
        "depth": span.depth,
        "parent": span.parent,
        "metrics": dict(span.metrics),
        "hops": hops,
    }
    with _finished_lock:
        if len(FINISHED) < _EVENT_CAP:
            FINISHED.append(record)


def _default_tags(args) -> Dict[str, Any]:
    """Shape tags from the first operand, without touching device data."""
    if not args:
        return {}
    a = args[0]
    if hasattr(a, "m") and hasattr(a, "n") and hasattr(a, "nb"):
        return {"m": a.m, "n": a.n, "nb": a.nb}
    shape = getattr(a, "shape", None)
    if shape is not None:
        return {"shape": "x".join(str(s) for s in shape)}
    return {}


def instrument(name: Optional[str] = None, **static_tags) -> Callable:
    """Decorator wiring a driver into the observability layer.  Disabled,
    the wrapper calls the function straight through; enabled, the call
    runs inside ``driver_span(name, **shape_tags)``."""

    def deco(fn: Callable) -> Callable:
        span_name = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            tags = dict(static_tags)
            tags.update(_default_tags(args))
            with driver_span(span_name, **tags):
                return fn(*args, **kwargs)

        wrapper.__wrapped__ = fn
        wrapper._obs_span = span_name
        return wrapper

    return deco


def measure(name: str, fn: Callable, *args, tags: Optional[Dict[str, Any]] = None):
    """Run ``fn(*args)`` instrumented: a timed cold call and a timed
    execute call (each fenced), ``compile_seconds`` the cold call's excess
    over the execute call's.  Returns (the execute call's result, the span's
    metrics).  Works with or without observability enabled (it enables it
    for its own scope).  The span's ``comm_bytes`` is one call's: the cold
    call's audit records stay in its phase span."""
    from ..parallel import comm

    with force_enabled():
        with driver_span(name, **(tags or {})) as sp:
            with comm.comm_audit(), comm.sched_audit():
                with sp.phase("cold"):
                    fn(*args)
            with sp.phase("execute"):
                out = fn(*args)
            execute = sp.metrics.get("execute_seconds", 0.0)
            cold = sp.metrics.get("cold_seconds", 0.0)
            sp.set("compile_seconds", max(0.0, cold - execute))
            sp.set("execute_seconds", execute)
        metrics = dict(sp.metrics)
    return out, metrics
