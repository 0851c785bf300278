"""Request-level serving traces: the lifecycle record of one request
through the Router.

Counterpart of ``slate_tpu/serve/trace.py``: admission -> condest
classification -> executable-cache lookup (hit / miss) -> factor ->
solve / refine -> the degradation ladder (FtError retry, Preempted resume,
GrowthAbort pivoted retry, structured reject), each a nesting phase span,
ending in exactly one terminal outcome (``TERMINALS``).

Contracts (``slate_tpu``'s):

- **Exactly one terminal outcome per request.**  ``finish`` is single-shot;
  a request that retried and resumed terminates under the last degradation
  that carried it home.
- **Disabled mode allocates nothing.**  ``new_trace`` returns None while the
  obs layer is off, every Router call site goes through the None-safe
  helpers below, and the dispatch is unchanged.  Phase times are host-clock
  (``time.perf_counter``); the Router fences the card at a traced request's
  dispatch and solve ends, and an untraced request adds no fence.
- **The metric surface is the shared registry.**  ``finish`` observes the
  request latency into the ``serve.latency_s`` histogram tagged by (op,
  class, outcome), and ``sla_values`` reduces it to the flat
  ``latency_{p50,p95,p99}_*`` and outcome keys of the RunReport ``serve``
  section.

``obs.perfetto.request_trace_events`` renders finished traces, one track
per accuracy class with flow arrows retry -> resume -> final.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import REGISTRY, enabled
from ..obs import context as _obs_context

# terminal outcomes: every request ends in EXACTLY one of these
TERMINALS = (
    "served",                # clean dispatch, no degradation consumed
    "served_retry",          # transient FtError -> one Recompute retry
    "served_resume",         # Preempted -> resumed from its checkpoint
    "served_growth_retry",   # GrowthAbort -> one pivoted (pp) retry
    "reject_admission",      # over the HBM / bin admission bound
    "reject_budget",         # over the submitting tenant's HBM budget
    "reject_unresumable",    # preempted with no (or a re-killed) snapshot
    "reject_residual",       # the resilient path's residual gate refused it
    "reject_batch_abort",    # a sibling's failure aborted the batch first
    "failed_info",           # the factorization reported nonzero info
    "failed_error",          # the request's own dispatch raised past the ladder
)

# degradation notes -> the served terminal they map to (the LAST note names
# the cause that carried the request home)
_NOTE_TERMINAL = {
    "ft_retry": "served_retry",
    "resume": "served_resume",
    "growth_retry": "served_growth_retry",
}

_IDS = itertools.count(1)
_lock = threading.Lock()
_FINISHED: List["RequestTrace"] = []
_FINISHED_CAP = 4096
# (op, klass, outcome) -> count: the exact outcome totals (the histogram
# reservoirs estimate quantiles; these counts are exact)
_OUTCOME_COUNTS: Dict[Tuple[str, str, str], float] = {}


class RequestTrace:
    """One request's lifecycle: identity (rid / op / n / nb / dtype), the
    condest-keyed accuracy class, nesting phase spans, degradation notes
    and the single terminal outcome."""

    __slots__ = ("rid", "op", "n", "nb", "dtype", "klass", "bin", "batch",
                 "t0", "t1", "phases", "notes", "outcome", "_stack",
                 "trace_id", "tenant")

    def __init__(self, op: str, n: int, nb: int, dtype: str,
                 tenant: Optional[str] = None) -> None:
        self.rid = next(_IDS)
        # the correlation id of every surface below, assigned once: a
        # ladder retry or resume re-dispatches under the same trace_id
        self.trace_id = _obs_context.new_trace_id()
        self.tenant = tenant
        self.op = op
        self.n = int(n)
        self.nb = int(nb)
        self.dtype = dtype
        self.klass: Optional[str] = None
        self.bin: Optional[int] = None
        self.batch: int = 1
        self.t0 = time.perf_counter()
        self.t1 = 0.0
        self.phases: List[dict] = []   # {name, t0, t1, depth, parent, meta}
        self.notes: List[str] = []     # degradation events, in order
        self.outcome: Optional[str] = None
        self._stack: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        """One nesting phase span, recorded on exit (children append before
        their parents; containment is by interval and ``parent``).  The
        body runs under the request's TraceContext, so driver spans, memory
        samples and gauges recorded inside carry its trace_id."""
        rec = {"name": name, "t0": time.perf_counter(), "t1": 0.0,
               "depth": len(self._stack),
               "parent": self._stack[-1] if self._stack else None,
               "meta": dict(meta)}
        self._stack.append(name)
        ctx = _obs_context.TraceContext(self.trace_id, tenant=self.tenant, klass=self.klass,
                                        rid=self.rid, op=self.op)
        try:
            with _obs_context.use_context(ctx):
                yield rec
        finally:
            self._stack.pop()
            rec["t1"] = time.perf_counter()
            self.phases.append(rec)
            # unconditional: the trace exists because obs was on at
            # admission, and the phase surface must stay in step with the
            # exact outcome counts
            tt = {"tenant": self.tenant} if self.tenant else {}
            REGISTRY.observe("serve.phase_s", rec["t1"] - rec["t0"], op=self.op, phase=name, **tt)

    def note(self, kind: str) -> None:
        """Record one degradation event (ft_retry / resume / growth_retry /
        orth_retry)."""
        if kind not in _NOTE_TERMINAL and kind != "orth_retry":
            raise ValueError(f"unknown degradation note {kind!r}")
        self.notes.append(kind)

    def terminal(self) -> str:
        """The served terminal this request's notes attribute it to."""
        for kind in reversed(self.notes):
            if kind in _NOTE_TERMINAL:
                return _NOTE_TERMINAL[kind]
        return "served"

    def finish(self, outcome: str) -> None:
        """Set THE terminal outcome (single-shot), observe the latency
        tagged (op, class, outcome) and retire the trace to the finished
        stream."""
        if self.outcome is not None:
            raise RuntimeError(
                f"request {self.rid} ({self.op}) already terminal ({self.outcome!r}); a second "
                f"outcome {outcome!r} would double-attribute it")
        if outcome not in TERMINALS:
            raise ValueError(f"unknown terminal outcome {outcome!r}; expected one of {TERMINALS}")
        self.outcome = outcome
        self.t1 = time.perf_counter()
        klass = self.klass or "friendly"
        with _lock:
            key = (self.op, klass, outcome)
            _OUTCOME_COUNTS[key] = _OUTCOME_COUNTS.get(key, 0.0) + 1.0
            _FINISHED.append(self)
            if len(_FINISHED) > _FINISHED_CAP:
                del _FINISHED[0]
        tt = {"tenant": self.tenant} if self.tenant else {}
        REGISTRY.observe("serve.latency_s", self.t1 - self.t0, op=self.op, klass=klass,
                         outcome=outcome, **tt)
        REGISTRY.counter_add("serve.outcomes", 1.0, op=self.op, klass=klass, outcome=outcome,
                             **tt)
        # the live telemetry bus, when it is loaded (a sys.modules probe)
        live = sys.modules.get(__package__.rsplit(".", 1)[0] + ".obs.live")
        if live is not None:
            live.publish("request", {
                "rid": self.rid, "trace_id": self.trace_id, "tenant": self.tenant,
                "op": self.op, "n": self.n, "klass": klass, "outcome": outcome,
                "latency_s": self.t1 - self.t0, "notes": list(self.notes),
            })


# ---------------------------------------------------------------------------
# None-safe call-site helpers: the Router threads Optional[RequestTrace]
# ---------------------------------------------------------------------------


def new_trace(op: str, n: int, nb: int, dtype: str,
              tenant: Optional[str] = None) -> Optional[RequestTrace]:
    """A live trace while the obs layer is on, else None (no allocation,
    and no TraceContext is ever entered)."""
    if not enabled():
        return None
    return RequestTrace(op, n, nb, dtype, tenant=tenant)


def phase(tr: Optional[RequestTrace], name: str, **meta):
    return tr.phase(name, **meta) if tr is not None else contextlib.nullcontext()


@contextlib.contextmanager
def phase_all(trs, name: str, **meta):
    """One phase span opened on every live trace of a stacked group (the
    group shares the dispatch, so it shares the span times)."""
    with contextlib.ExitStack() as stack:
        for tr in trs:
            if tr is not None:
                stack.enter_context(tr.phase(name, **meta))
        yield


def note(tr: Optional[RequestTrace], kind: str) -> None:
    if tr is not None:
        tr.note(kind)


def finish(tr: Optional[RequestTrace], outcome: Optional[str] = None) -> None:
    """Terminate ``tr`` with ``outcome`` (default: the note-attributed
    served terminal)."""
    if tr is not None:
        tr.finish(outcome if outcome is not None else tr.terminal())


def finished_traces() -> List[RequestTrace]:
    with _lock:
        return list(_FINISHED)


def reset() -> None:
    with _lock:
        _FINISHED.clear()
        _OUTCOME_COUNTS.clear()


# ---------------------------------------------------------------------------
# SLA reduction: live registry -> flat RunReport serve-section keys
# ---------------------------------------------------------------------------


def sla_values() -> Dict[str, float]:
    """The flat SLA surface of the RunReport ``serve`` section:

    - ``latency_{p50,p95,p99}_{op}_{klass}_s``: reservoir quantiles pooled
      over every outcome of one (op, class), wall-clock keys;
    - ``latency_count_{op}_{klass}``: observation counts;
    - ``outcome_{outcome}`` / ``outcome_rate_{outcome}``: exact totals and
      their share of all terminated requests.

    Empty ({}) when no request terminated."""
    from ..obs.metrics import quantile_of
    from .metrics import _sanitize_key as _san

    with _lock:
        counts = dict(_OUTCOME_COUNTS)
    vals: Dict[str, float] = {}
    by_outcome: Dict[str, float] = {}
    for (_op, _kl, outc), c in counts.items():
        by_outcome[outc] = by_outcome.get(outc, 0.0) + c
    total = sum(by_outcome.values())
    for outc, c in sorted(by_outcome.items()):
        vals[f"outcome_{outc}"] = c
        vals[f"outcome_rate_{outc}"] = c / total
    pools: Dict[Tuple[str, str], dict] = {}
    for series in REGISTRY.histogram_series("serve.latency_s"):
        tags = series["tags"]
        key = (tags.get("op", "?"), tags.get("klass", "?"))
        pool = pools.setdefault(key, {"count": 0, "samples": [], "min": float("inf"),
                                      "max": float("-inf")})
        pool["count"] += series["count"]
        pool["samples"].extend(series["samples"])
        pool["min"] = min(pool["min"], series["min"])
        pool["max"] = max(pool["max"], series["max"])
    for (op, klass), pool in sorted(pools.items()):
        stem = _san(f"{op}_{klass}")
        vals[f"latency_count_{stem}"] = float(pool["count"])
        for label, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            qv = quantile_of(pool["samples"], q, pool["min"], pool["max"])
            if qv is not None:
                vals[f"latency_{label}_{stem}_s"] = qv
    return vals
