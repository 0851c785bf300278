"""TraceContext: the one request identity every observability surface
shares.

Counterpart of ``slate_tpu/obs/context.py`` (plain Python, the same
code): a thread-local ambient record of whose work is running right now
-- ``trace_id`` (the correlation id), ``tenant`` (the only field that may
become a metrics tag: one value per tenant), ``klass`` / ``rid`` / ``op``
and ``parent`` (the enclosing span at entry).  Driver spans, flight
StepEvents and RunReports read ``current()`` at their record points and
carry its ids.  With no context entered, ``current()`` is None and every
surface keeps its plain record shape.
"""

from __future__ import annotations

import contextlib
import threading
import uuid
from typing import Dict, List, Optional

_tls = threading.local()


def new_trace_id() -> str:
    """A fresh 16-hex-char correlation id (the W3C traceparent shape,
    halved: collision-safe for any plausible ledger window, short
    enough to read in a Perfetto args panel)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One request's ambient identity while its work runs on this
    thread.  Immutable by convention — enter a fresh context instead of
    mutating one mid-flight."""

    __slots__ = ("trace_id", "tenant", "klass", "rid", "op", "parent")

    def __init__(self, trace_id: str, tenant: Optional[str] = None,
                 klass: Optional[str] = None, rid: Optional[int] = None,
                 op: Optional[str] = None,
                 parent: Optional[str] = None) -> None:
        self.trace_id = trace_id
        self.tenant = tenant
        self.klass = klass
        self.rid = rid
        self.op = op
        self.parent = parent

    def __repr__(self) -> str:  # debugging/ledger aid
        bits = [f"trace_id={self.trace_id!r}"]
        for k in ("tenant", "klass", "rid", "op"):
            v = getattr(self, k)
            if v is not None:
                bits.append(f"{k}={v!r}")
        return f"TraceContext({', '.join(bits)})"


def _stack() -> List[TraceContext]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> Optional[TraceContext]:
    """The innermost active context on this thread, or None.  The None
    case is the permanent fast path for every un-served workload (bench,
    lint, tests with obs off): one thread-local load and a truthiness
    test."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


@contextlib.contextmanager
def use_context(ctx: Optional[TraceContext]):
    """Make ``ctx`` the ambient context for the body.  ``None`` is a
    no-op (the disabled-mode call sites pass straight through without
    allocating)."""
    if ctx is None:
        yield None
        return
    st = _stack()
    st.append(ctx)
    try:
        yield ctx
    finally:
        st.pop()


def event_tags() -> Dict[str, str]:
    """Context tags for EVENT records (spans, samples, trace exports):
    trace_id always, tenant when set.  Event streams are bounded by
    their own caps, so per-request ids are safe here."""
    ctx = current()
    if ctx is None:
        return {}
    tags = {"trace_id": ctx.trace_id}
    if ctx.tenant:
        tags["tenant"] = ctx.tenant
    return tags


def tenant_tags() -> Dict[str, str]:
    """Context tags for METRIC SERIES (registry counters / gauges /
    histograms): tenant only — bounded cardinality.  trace_id would mint
    one series per request and is deliberately excluded."""
    ctx = current()
    if ctx is not None and ctx.tenant:
        return {"tenant": ctx.tenant}
    return {}
