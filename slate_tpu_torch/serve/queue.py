"""The batch-window admission queue: the scheduler between a socket and the
Router.

Counterpart of ``slate_tpu/serve/queue.py``.  The Router is synchronous: a
caller must already hold B compatible requests to run them as one stacked
program.  This queue makes those batches out of a stream of single
requests:

- **Batch windows.**  ``submit`` bins each request by the Router-compatible
  window key ``(op, accuracy class, shape bin, nrhs, dtype)`` -- the
  identity the executable cache keys its programs on, the class through
  ``Router.effective_class`` -- so one window always lands in one stacked
  (or block-diagonally packed) program.  A window closes when it holds B
  requests (B-fill) or when T seconds have passed (``pump`` sees the
  deadline), whichever comes first.
- **Deterministic clock.**  Every scheduling decision reads
  ``clock.now()``: with a ``ManualClock``, B-fill against T-expiry, FIFO
  order, the DRR rounds and the starvation bound are testable without wall
  time.
- **Per-tenant budgets, weighted deficit round robin.**  A submit reserves
  modeled device bytes against its tenant's ``BudgetLedger`` account
  (``reject_budget`` when over), and an oversubscribed window dequeues by
  weighted DRR over the tenants: each round grants every pending tenant
  ``weight`` of deficit, so a tenant's service lag is bounded by one
  max-weight round and FIFO holds within a tenant.
- **Observability.**  Depth, open windows, per-tenant deficit and budget
  headroom are ``serve.queue_*`` gauges in the shared registry (the
  ``obs.live`` scrape, and ``/queue.json``); window closes publish
  ``queue`` events on the telemetry bus; every admitted request carries
  its RequestTrace from submit (the latency covers the window wait, which
  the ``queue`` phase records).

Operands become tensors on the router's device at submit
(``Router._operand``: a tensor stays where it lies), so a window stacks
tensors that are already there.  Window keys name dtypes as ``slate_tpu``
does (``serve.cache.dtype_name``: ``"float64"``), so the dispatch log,
``/queue.json`` and the gauges read the same strings in both packages.

Dispatch runs on the thread that closes the window: the submitter whose
request filled it, or the one calling ``pump`` / ``drain`` (the service
worker).  Every thread uses the default stream.  ``stacked_body`` /
``packed_mesh_body`` are the program bodies a closed window dispatches.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..obs import REGISTRY
from ..types import SlateError
from . import trace as rtrace
from .batch import bin_for, pack_block_diag, unpack_block_diag
from .budget import BudgetLedger, request_cost
from .cache import dtype_name, make_key
from .metrics import serve_count


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------


class ManualClock:
    """Deterministic injectable clock: tests and the queue smoke advance
    time explicitly, so every window close is a decision about numbers."""

    def __init__(self, t: float = 0.0) -> None:
        self._t = float(t)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> float:
        self._t += float(dt)
        return self._t


class MonotonicClock:
    """The wall clock (``python -m slate_tpu_torch.serve.service``)."""

    now = staticmethod(time.monotonic)


# ---------------------------------------------------------------------------
# tickets and windows
# ---------------------------------------------------------------------------

# process-wide ticket numbers: next() on a count() is atomic under the GIL,
# so submits on different queues (each under its own lock) get unique seqs
_TICKET_SEQ = itertools.count(1)


class Ticket:
    """One submitted request's handle: resolves to the solution once its
    window dispatched (or to the dispatch error)."""

    __slots__ = ("seq", "op", "n", "bin", "nrhs", "tenant", "tenant_key", "cost", "trace",
                 "submitted_at", "state", "_result", "_error")

    def __init__(self, seq, op, n, m, nrhs, tenant, tenant_key, cost, trace,
                 submitted_at) -> None:
        self.seq = seq
        self.op = op
        self.n = n
        self.bin = m
        self.nrhs = nrhs
        self.tenant = tenant
        self.tenant_key = tenant_key
        self.cost = cost
        self.trace = trace
        self.submitted_at = submitted_at
        self.state = "queued"   # -> "done" | "failed"
        self._result = None
        self._error: Optional[Exception] = None

    def done(self) -> bool:
        return self.state != "queued"

    def result(self):
        if self.state == "queued":
            raise SlateError(f"queue: request #{self.seq} not dispatched yet -- pump() the "
                             "queue (or wait on the service worker)")
        if self._error is not None:
            raise self._error
        return self._result

    def wait(self, timeout: Optional[float] = None, poll_s: float = 0.002):
        """Block (wall time) until dispatched: a front end's request thread
        parks here while the worker pumps."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.done():
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"queue: request #{self.seq} still queued after {timeout}s")
            time.sleep(poll_s)
        return self.result()


class _Window:
    """One open batch window: per-tenant FIFO sub-queues of compatible
    requests (tenant order = first-arrival order, the DRR rotation)."""

    __slots__ = ("key", "opened_at", "deadline", "entries", "count")

    def __init__(self, key, opened_at: float, deadline: float) -> None:
        self.key = key
        self.opened_at = opened_at
        self.deadline = deadline
        # tenant_key -> deque[(ticket, a, b)]
        self.entries: "OrderedDict[str, deque]" = OrderedDict()
        self.count = 0

    def add(self, tenant_key: str, entry) -> None:
        self.entries.setdefault(tenant_key, deque()).append(entry)
        self.count += 1

    def depth(self) -> int:
        return self.count


# ---------------------------------------------------------------------------
# the queue
# ---------------------------------------------------------------------------

# live queues by name: obs.live's ``/queue.json`` and ``/healthz`` read
# this through a sys.modules probe
_ACTIVE: "OrderedDict[str, BatchQueue]" = OrderedDict()

_DEFAULT_TENANT = "default"


class BatchQueue:
    """The admission queue over one Router (see the module docstring).

    Without a ``ledger``, tenants not named in ``budgets`` get the router's
    device budget (``hbm_budget`` or the card's, under ``HBM_SAFETY``)."""

    def __init__(self, router, *, max_batch: int = 8, window_s: float = 0.005,
                 ledger: Optional[BudgetLedger] = None,
                 budgets: Optional[Dict[str, int]] = None,
                 weights: Optional[Dict[str, float]] = None,
                 clock=None, dispatch: str = "stacked", name: str = "default") -> None:
        if dispatch not in ("stacked", "packed"):
            raise ValueError(f"unknown dispatch mode {dispatch!r}")
        self.router = router
        # the ServiceController's two window knobs, moved live
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.ledger = ledger if ledger is not None else BudgetLedger(
            budgets, weights, default_budget=router._budget)
        self.clock = clock if clock is not None else MonotonicClock()
        self.dispatch_mode = dispatch
        self.name = name
        self._windows: "OrderedDict[Tuple, _Window]" = OrderedDict()
        self._deficit: Dict[str, float] = {}
        self._lock = threading.RLock()
        self.dispatch_log: List[dict] = []   # the last _LOG_CAP window closes
        self._LOG_CAP = 64
        self.submitted = 0
        self.dispatched = 0
        _ACTIVE[name] = self

    def close(self) -> None:
        """Leave the live-scrape surface (open windows are the caller's to
        drain first)."""
        if _ACTIVE.get(self.name) is self:
            del _ACTIVE[self.name]

    # -- admission ---------------------------------------------------------

    def _reject_admission(self, op, n, dtype, tenant, msg):
        """The ``reject_admission`` terminal at submit: count, open and
        finish the request's trace, raise."""
        serve_count("admission_rejects")
        tr = rtrace.new_trace(op, n, self.router.nb, dtype, tenant=tenant)
        rtrace.finish(tr, "reject_admission")
        raise SlateError(msg)

    def submit(self, op: str, a, b, tenant: Optional[str] = None) -> Ticket:
        """Admit one request into its batch window.  Raises SlateError (the
        ``reject_admission`` / ``reject_budget`` terminal on the request's
        trace) when the request is malformed (a non-square operand, a rhs
        row count that does not match), exceeds the bins or is over its
        tenant's budget; otherwise returns a Ticket that resolves when the
        window dispatches.  Shapes are checked here, at admission: a
        malformed request in a shared window would abort every sibling at
        stack time."""
        a, b = self.router._operand(a), self.router._operand(b)
        dtype = dtype_name(a)
        tenant_key = tenant if tenant is not None else _DEFAULT_TENANT
        shape_a = tuple(a.shape)
        if a.ndim != 2 or shape_a[0] != shape_a[1]:
            self._reject_admission(
                op, int(shape_a[0]) if shape_a else 0, dtype, tenant,
                f"queue: operand must be a square matrix, got shape {shape_a}")
        n = a.shape[0]
        if b.ndim not in (1, 2) or b.shape[0] != n:
            self._reject_admission(
                op, n, dtype, tenant,
                f"queue: rhs shape {tuple(b.shape)} incompatible with operand n={n} "
                f"(want ({n},) or ({n}, nrhs))")
        m = bin_for(n, self.router.bins)
        if m is None:
            self._reject_admission(
                op, n, dtype, tenant,
                f"queue: n={n} exceeds the largest serving bin {self.router.bins[-1]}")
        cost = request_cost(m, a.element_size())
        if not self.ledger.try_reserve(tenant_key, cost):
            serve_count("queue_budget_rejects")
            tr = rtrace.new_trace(op, n, self.router.nb, dtype, tenant=tenant)
            rtrace.finish(tr, "reject_budget")
            self._publish("budget_reject", {
                "tenant": tenant_key, "op": op, "n": n, "cost_bytes": cost,
                "headroom_bytes": self.ledger.headroom(tenant_key)})
            raise SlateError(
                f"queue: tenant {tenant_key!r} over its HBM budget -- request needs "
                f"~{cost / 2**20:.1f} MiB modeled, headroom "
                f"{self.ledger.headroom(tenant_key) / 2**20:.1f} MiB")
        serve_count("queue_submitted")
        tr = rtrace.new_trace(op, n, self.router.nb, dtype, tenant=tenant)
        nrhs = b.shape[1] if b.ndim == 2 else 1
        klass = self.router.effective_class(op, a)
        key = (op, klass, m, nrhs, dtype)
        now = self.clock.now()
        with self._lock:
            tk = Ticket(next(_TICKET_SEQ), op, n, m, nrhs, tenant, tenant_key, cost, tr, now)
            w = self._windows.get(key)
            if w is None:
                w = self._windows[key] = _Window(key, opened_at=now, deadline=now + self.window_s)
            w.add(tenant_key, (tk, a, b))
            self._deficit.setdefault(tenant_key, 0.0)
            self.submitted += 1
            ready = w.depth() >= self.max_batch
        if ready:
            self._close_key(key, "full")
        self._update_gauges()
        return tk

    # -- scheduling --------------------------------------------------------

    def depth(self) -> int:
        with self._lock:
            return sum(w.depth() for w in self._windows.values())

    def pump(self) -> int:
        """Close every window that is due -- past its T deadline, or at or
        over B (the controller may shrink B under an open window).  Returns
        the number of requests dispatched.  A dispatch error propagates
        after its window's tickets, traces and reservations are settled
        (the Router's batch-abort contract)."""
        total = 0
        while True:
            now = self.clock.now()
            with self._lock:
                due = [(k, "full" if w.depth() >= self.max_batch else "expired")
                       for k, w in self._windows.items()
                       if w.depth() >= self.max_batch or now >= w.deadline]
            if not due:
                break
            for key, cause in due:
                total += self._close_key(key, cause)
        self._update_gauges()
        return total

    def drain(self) -> int:
        """Close every open window now, deadlines notwithstanding (shutdown,
        end of stream)."""
        total = 0
        while True:
            with self._lock:
                keys = list(self._windows)
            if not keys:
                break
            for key in keys:
                total += self._close_key(key, "expired")
        self._update_gauges()
        return total

    def _close_key(self, key, cause: str) -> int:
        with self._lock:
            w = self._windows.pop(key, None)
            if w is None:
                return 0
            pending_at_close = {t: len(q) for t, q in w.entries.items()}
            selected = self._drr_select(w, self.max_batch)
            if w.depth() > 0:
                # oversubscribed: the rest opens a fresh window (a new T
                # deadline: it queued behind a full round, not a lost one)
                now = self.clock.now()
                w.opened_at = now
                w.deadline = now + self.window_s
                self._windows[key] = w
            self.dispatch_log.append({
                "key": _key_str(key), "cause": cause,
                "tickets": [(tk.seq, tk.tenant_key) for tk, _a, _b in selected],
                "pending_at_close": pending_at_close,
            })
            del self.dispatch_log[:-self._LOG_CAP]
        serve_count("queue_windows")
        serve_count("queue_window_full" if cause == "full" else "queue_window_expired")
        self._dispatch(key, selected)
        return len(selected)

    def _drr_select(self, w: _Window, k: int) -> List[tuple]:
        """Weighted deficit round robin over the window's tenants: each
        round grants every pending tenant ``weight`` of deficit and serves
        whole requests (cost 1) while the deficit lasts, so within one round
        every tenant of weight >= 1 is served and a tenant's lag is bounded
        by one max-weight round.  A deficit resets only once its tenant has
        drained from every open window, and never banks across idle
        periods; FIFO holds within a tenant.  A rotation that serves nothing
        (only possible if the ledger hands back a degenerate weight at run
        time: construction checks > 0) serves the head-of-line tenant into
        deficit debt, so selection always ends."""
        selected: List[tuple] = []
        while len(selected) < k and w.entries:
            progressed = False
            for tenant_key in list(w.entries.keys()):
                if len(selected) >= k:
                    break
                q = w.entries.get(tenant_key)
                if not q:
                    continue
                self._deficit[tenant_key] = (self._deficit.get(tenant_key, 0.0)
                                             + self.ledger.weight(tenant_key))
                while self._deficit[tenant_key] >= 1.0 and q and len(selected) < k:
                    self._take(w, tenant_key, q, selected)
                    progressed = True
                if not q:
                    self._drop_subqueue(w, tenant_key)
            if not progressed and w.entries and len(selected) < k:
                tenant_key = next(iter(w.entries))
                q = w.entries[tenant_key]
                self._take(w, tenant_key, q, selected)
                if not q:
                    self._drop_subqueue(w, tenant_key)
        return selected

    def _take(self, w: _Window, tenant_key: str, q, selected) -> None:
        selected.append(q.popleft())
        w.count -= 1
        self._deficit[tenant_key] = self._deficit.get(tenant_key, 0.0) - 1.0

    def _drop_subqueue(self, w: _Window, tenant_key: str) -> None:
        """The tenant's sub-queue of this window drained: forget its deficit
        only if no other open window still holds its entries (this runs
        under the lock, the closing window already popped)."""
        del w.entries[tenant_key]
        if not any(w2.entries.get(tenant_key) for w2 in self._windows.values()):
            self._deficit[tenant_key] = 0.0

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, key, entries: List[tuple]) -> None:
        if not entries:
            return
        op = key[0]
        tickets = [tk for tk, _a, _b in entries]
        now = self.clock.now()
        for tk in tickets:
            # a zero-length marker phase: the window wait on the queue's own
            # clock (the trace's latency already spans submit -> terminal)
            with rtrace.phase(tk.trace, "queue", wait_s=now - tk.submitted_at):
                pass
        try:
            if self.dispatch_mode == "packed" and op == "posv":
                out = self._dispatch_packed(key, entries)
            else:
                out = self.router.solve_batch([(op, a, b) for _tk, a, b in entries],
                                              tenants=[tk.tenant for tk in tickets],
                                              traces=[tk.trace for tk in tickets])
            for tk, x in zip(tickets, out):
                tk._result = x
                tk.state = "done"
        except Exception as e:
            for tk in tickets:
                if tk.state == "queued":
                    tk._error = e
                    tk.state = "failed"
            raise
        finally:
            serve_count("queue_dispatched", len(entries))
            for tk in tickets:
                self.ledger.release(tk.tenant_key, tk.cost)
            self._publish("window", {"queue": self.name, "key": _key_str(key),
                                     "count": len(entries),
                                     "tenants": sorted({tk.tenant_key for tk in tickets})})

    def _dispatch_packed(self, key, entries: List[tuple]) -> List:
        """Block-diagonal packed dispatch: the window's k problems pack into
        one operand and one built program through the executable cache
        (posv only: a block diagonal of SPD blocks is SPD).  Co-packed
        blocks meet only through exact zeros; the bitwise-against-the-Router
        guarantee is the stacked path's."""
        import torch

        from .router import _fence

        _op, _klass, m, _nrhs, _dtype = key
        tickets = [tk for tk, _a, _b in entries]
        traces = [tk.trace for tk in tickets]
        ops_ = [a for _tk, a, _b in entries]
        rhs_ = [(b if b.ndim == 2 else b[:, None]) for _tk, _a, b in entries]
        serve_count("queue_packed_dispatches")
        # pack_block_diag counts serve.packed_problems itself
        a_pack, b_pack = pack_block_diag(ops_, m, rhs_)
        if self.router.mesh is not None:
            body, _merged = packed_mesh_body(self.router.mesh, a_pack.shape[0],
                                             dtype_name(a_pack), self.router.opts or None)
            pkey = make_key("posv_packed", (a_pack, b_pack), batch=len(entries),
                            mesh=self.router.mesh)
        else:
            body = _packed_single_body()
            pkey = make_key("posv_packed", (a_pack, b_pack), batch=len(entries), mesh=None)
        live = any(tr is not None for tr in traces)
        hit = self.router.cache.contains(pkey) if live else False
        with rtrace.phase_all(traces, "cache_lookup", result="hit" if hit else "miss"):
            prog = self.router.cache.get_or_build(pkey, lambda: body)
        with rtrace.phase_all(traces, "solve"):
            with obs.driver_span("serve.dispatch", op="posv_packed", batch=len(entries)):
                x_pack, info = prog(a_pack, b_pack)
                if live:
                    _fence(x_pack)
        serve_count("batches")
        serve_count("batched_solves", len(entries))
        if int(torch.as_tensor(info).max()) != 0:
            for tr in traces:
                rtrace.finish(tr, "failed_info")
            raise SlateError("queue: packed posv dispatch reported nonzero info -- an operand "
                             "in the window is not SPD")
        xs = unpack_block_diag(x_pack, [tk.n for tk in tickets], m, [r.shape[1] for r in rhs_])
        out = []
        for tk, x, (_tk, _a, b_orig) in zip(tickets, xs, entries):
            out.append(x[:, 0] if b_orig.ndim == 1 else x)
            rtrace.finish(tk.trace)
        return out

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """JSON-able live view: the ``/queue.json`` body."""
        with self._lock:
            windows = [{"key": _key_str(k), "depth": w.depth(), "opened_at": w.opened_at,
                        "deadline": w.deadline} for k, w in self._windows.items()]
            deficits = dict(self._deficit)
        tenants = self.ledger.snapshot()
        for name, d in deficits.items():
            tenants.setdefault(name, {})["deficit"] = d
        return {
            "depth": sum(w["depth"] for w in windows),
            "open_windows": len(windows),
            "windows": windows,
            "max_batch": self.max_batch,
            "window_s": self.window_s,
            "dispatch": self.dispatch_mode,
            "submitted": self.submitted,
            "tenants": tenants,
        }

    def _update_gauges(self) -> None:
        if not obs.enabled():
            return
        REGISTRY.gauge_set("serve.queue_depth", float(self.depth()), queue=self.name)
        with self._lock:
            REGISTRY.gauge_set("serve.queue_open_windows", float(len(self._windows)),
                               queue=self.name)
            deficits = dict(self._deficit)
        for tenant_key, d in deficits.items():
            REGISTRY.gauge_set("serve.queue_tenant_deficit", float(d), queue=self.name,
                               tenant=tenant_key)
            REGISTRY.gauge_set("serve.queue_budget_headroom_bytes",
                               float(self.ledger.headroom(tenant_key)), queue=self.name,
                               tenant=tenant_key)

    def _publish(self, event: str, data: dict) -> None:
        import sys as _sys

        _live = _sys.modules.get(__package__.rsplit(".", 1)[0] + ".obs.live")
        if _live is not None:
            _live.publish("queue", dict(data, event=event))


def _key_str(key) -> str:
    op, klass, m, nrhs, dtype = key
    return f"{op}/{klass}/n{m}/rhs{nrhs}/{dtype}"


def queue_stats() -> dict:
    """Every live queue's stats by name: the ``/queue.json`` body (and the
    ``/healthz`` liveness line).  The scrape runs on its own thread while
    queues open and close, so it iterates over a copy of the registry."""
    return {"queues": {name: q.stats() for name, q in list(_ACTIVE.items())}}


# ---------------------------------------------------------------------------
# the program bodies a closed window dispatches
# ---------------------------------------------------------------------------


def stacked_body(op: str, klass: str):
    """The stacked program a closed window dispatches for ``(op, klass)``:
    the Router's own batched body (the queue only schedules on the host)."""
    from .router import _build_batched

    return _build_batched(op, klass)


def packed_mesh_body(mesh, n_packed: int, dtype: str, opts=None):
    """The packed-operand mesh solve the packed dispatch builds through the
    executable cache, with the option resolution of
    ``batch.posv_packed_mesh`` (explicit > context > env > tuned > auto).
    Returns ``(body, merged_options)``."""
    from ..parallel.drivers import posv_mesh
    from ..parallel.mesh import mesh_shape
    from ..types import Option, get_option
    from .table import resolve_request_options

    merged = resolve_request_options(opts, "posv", n_packed, dtype, mesh_shape(mesh))
    nb = int(get_option(merged, Option.BlockSize, default=64))

    def packed(a, b):
        return posv_mesh(a, b, mesh, nb, merged)

    return packed, merged


def _packed_single_body():
    """The single-card packed body: one posv over the block-diagonal operand
    (info is the packed factor's)."""
    from ..linalg.chol import posv_array

    def packed(a, b):
        x, _f, info = posv_array(a, b)
        return x, info

    return packed
