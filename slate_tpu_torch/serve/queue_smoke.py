"""Queue smoke: the acceptance run of the service layer.

Counterpart of ``slate_tpu/serve/queue_smoke.py``, with its phases, streams
(the same numpy seeds) and report values.  A 64-request two-tenant stream
goes through the batch-window queue on a ``ManualClock`` -- every
scheduling decision is about numbers, never about how fast the run was --
and it asserts:

(a) **Windowed throughput**: the stream runs as at most ceil(N/B) batch
    programs, with no build after the first window (``assert_steady``),
    and every served solution bitwise the one-at-a-time dispatch of a
    fresh Router: the queue only schedules on the host.
(b) **Fair-share dequeue**: an oversubscribed window dequeues by weighted
    deficit round robin -- no pending tenant is shut out of a close, the
    split stays within one max-weight round of the weights, FIFO holds
    within a tenant -- and no tenant's ledger ever exceeded its budget.
(c) **Budget rejections**: a tenant past its budget is refused with the
    ``reject_budget`` terminal (counted, one terminal each), other tenants
    are untouched, and drained windows restore the tenant's headroom.
(d) **Admission memo**: 100 admissions across two Routers compute the
    MemoryModel closed form once per key (``serve.max_n_computes``).
(e) **Control loop**: a seeded p95 spike trips the controller's latch
    exactly once (no flapping on a held input), the actuation moves the
    (B, T) knobs, and the ``controller`` event reaches the telemetry bus.
(f) **Packed dispatch**: a ragged posv window in ``dispatch="packed"`` mode
    runs as one block-diagonal program whose solutions match the solo solve
    to factorization accuracy.

Meshless, so the stream does not depend on the broadcast lowering.  It
writes ``serve_queue.report.json`` (RunReport; the ``serve`` counter
section rides in) under ``--out``.

Usage::

    python -m slate_tpu_torch.serve.queue_smoke [--device cpu|cuda] [--out artifacts/serve_torch]

The device defaults to the card.
"""

from __future__ import annotations

import argparse
import os
import sys

OUT_DIR = os.path.join("artifacts", "serve_torch")


def _spd(rng, n, device):
    import numpy as np
    import torch

    g = rng.standard_normal((n, n))
    return torch.from_numpy(g @ g.T / n + 2 * np.eye(n)).to(device)


def _vec(rng, shape, device):
    import torch

    return torch.from_numpy(rng.standard_normal(shape)).to(device)


def run_stream_phase(failures: list, device) -> dict:
    """(a) + (b): the 64-request two-tenant stream and the oversubscribed
    DRR window."""
    import numpy as np
    import torch

    from .cache import ExecutableCache
    from .metrics import serve_counts
    from .queue import BatchQueue, ManualClock
    from .router import Router

    rng = np.random.default_rng(19)
    n, total, batch = 32, 64, 8
    clk = ManualClock()
    qcache = ExecutableCache()
    router = Router(bins=(n,), hbm_budget=1 << 30, cache=qcache, device=device)
    q = BatchQueue(router, max_batch=batch, window_s=0.005, clock=clk,
                   budgets={"acme": 1 << 30, "zeta": 1 << 30},
                   weights={"acme": 2.0, "zeta": 1.0}, name="smoke")
    probs = [(_spd(rng, n, device), _vec(rng, (n,), device)) for _ in range(total)]
    tenants = ["acme" if i % 2 == 0 else "zeta" for i in range(total)]
    c0 = serve_counts()
    tickets = []
    snapshot = None
    for i, ((a, b), tenant) in enumerate(zip(probs, tenants)):
        tickets.append(q.submit("posv", a, b, tenant=tenant))
        if i == batch - 1:
            # the first window just closed on B-fill: its program is the
            # steady state, and nothing after it may build
            snapshot = qcache.snapshot_traces()
    q.drain()
    c1 = serve_counts()
    windows = c1["queue_windows"] - c0["queue_windows"]
    if windows > -(-total // batch):
        failures.append(f"stream phase: {total} requests dispatched {windows:.0f} windows > "
                        f"ceil(N/B) = {-(-total // batch)} -- windows are fragmenting")
    if c1["queue_dispatched"] - c0["queue_dispatched"] != total:
        failures.append("stream phase: dispatched count != submitted count")
    try:
        qcache.assert_steady(snapshot)
    except AssertionError as e:
        failures.append(f"stream phase: steady-state rebuild: {e}")
    if any(not t.done() for t in tickets):
        failures.append("stream phase: a ticket never resolved")

    # bitwise against one-at-a-time dispatch through a fresh Router
    ref = Router(bins=(n,), hbm_budget=1 << 30, cache=ExecutableCache(), device=device)
    bitwise = all(torch.equal(t.result(), ref.solve("posv", a, b, tenant=tn))
                  for t, (a, b), tn in zip(tickets, probs, tenants))
    if not bitwise:
        failures.append("stream phase: queued solutions are not bitwise the one-at-a-time "
                        "Router dispatch")

    for tenant in ("acme", "zeta"):
        acct = q.ledger.account(tenant)
        if not 0 < acct.peak <= acct.budget:
            failures.append(f"stream phase: tenant {tenant} peak {acct.peak} outside "
                            "(0, budget]")

    # (b) oversubscribe one window (12 pending, B = 8) and dequeue by DRR
    q.max_batch = 16  # let the window fill past the dispatch size...
    over = [(_spd(rng, n, device), _vec(rng, (n,), device), "acme" if i % 2 == 0 else "zeta")
            for i in range(12)]
    otk = [q.submit("posv", a, b, tenant=t) for a, b, t in over]
    q.max_batch = 8   # ...then close it at B = 8: 12 pending, 8 slots
    clk.advance(0.01)
    q.pump()          # the contended close: 8 of 12 by DRR
    clk.advance(0.01)
    q.pump()          # the leftover window's fresh deadline expires
    sel = q.dispatch_log[-2]["tickets"]
    if len(sel) != 8:
        failures.append(f"DRR phase: contended close selected {len(sel)} != 8")
    by_tenant = {t: sum(1 for _s, tt in sel if tt == t) for t in ("acme", "zeta")}
    if min(by_tenant.values()) < 1:
        failures.append(f"DRR phase: a pending tenant was starved out of the close "
                        f"({by_tenant})")
    # weights 2:1 over 8 slots: within one max-weight round of (16/3, 8/3)
    if by_tenant["acme"] < 4 or by_tenant["zeta"] < 2:
        failures.append(f"DRR phase: selection {by_tenant} further than one max-weight round "
                        "from the 2:1 weight ratio")
    served_order = [s for entry in q.dispatch_log[-2:] for s in entry["tickets"]]
    for tenant in ("acme", "zeta"):
        seqs = [s for s, tt in served_order if tt == tenant]
        if seqs != sorted(seqs):
            failures.append(f"DRR phase: FIFO broken within {tenant}: {seqs}")
    if any(not t.done() for t in otk):
        failures.append("DRR phase: leftover tickets never dispatched")
    q.close()
    return {"requests": total, "windows": windows, "bitwise": bitwise, "drr_split": by_tenant}


def run_budget_phase(failures: list, device) -> dict:
    """(c): a per-tenant budget rejection and the headroom's return."""
    import numpy as np

    from ..types import SlateError
    from . import trace as serve_trace
    from .cache import ExecutableCache
    from .metrics import serve_counts
    from .queue import BatchQueue, ManualClock
    from .router import Router

    rng = np.random.default_rng(23)
    n = 32
    clk = ManualClock()
    router = Router(bins=(n,), hbm_budget=1 << 30, cache=ExecutableCache(), device=device)
    # one binned f64 request costs 3.5 * 32 * 32 * 8 = 28,672 bytes: a
    # 100 kB budget holds exactly 3 in flight
    q = BatchQueue(router, max_batch=8, window_s=0.005, clock=clk, budgets={"burst": 100_000},
                   name="smoke_budget")
    c0 = serve_counts()
    t0 = len(serve_trace.finished_traces())
    accepted, rejected = 0, 0
    for _ in range(5):
        a, b = _spd(rng, n, device), _vec(rng, (n,), device)
        try:
            q.submit("posv", a, b, tenant="burst")
            accepted += 1
        except SlateError:
            rejected += 1
    # a tenant without a declared budget keeps the default one
    q.submit("posv", _spd(rng, n, device), _vec(rng, (n,), device), tenant="calm")
    c1 = serve_counts()
    if (accepted, rejected) != (3, 2):
        failures.append(f"budget phase: expected 3 accepts + 2 rejects at a 100kB budget, got "
                        f"{accepted}+{rejected}")
    if c1["queue_budget_rejects"] - c0["queue_budget_rejects"] != rejected:
        failures.append("budget phase: serve.queue_budget_rejects did not count the refusals")
    rej = [t for t in serve_trace.finished_traces()[t0:] if t.outcome == "reject_budget"]
    if len(rej) != rejected:
        failures.append(f"budget phase: {rejected} refusals produced {len(rej)} reject_budget "
                        "terminals")
    # a submit past the bins is the other reject class
    try:
        q.submit("posv", _spd(rng, 64, device), _vec(rng, (64,), device), tenant="burst")
        failures.append("budget phase: an over-bin submit was admitted")
    except SlateError:
        pass
    clk.advance(0.01)
    q.pump()
    if q.ledger.account("burst").reserved != 0:
        failures.append("budget phase: drained windows did not restore the tenant's headroom")
    q.close()
    return {"accepted": accepted, "rejected": rejected}


def run_memo_phase(failures: list, device) -> dict:
    """(d): the admission memo computes each MemoryModel key once over 100
    admissions across two Router instances."""
    from .metrics import serve_counts
    from .router import Router

    # a budget no other phase uses: a fresh process-wide key
    budget = 987_654_321
    c0 = serve_counts()
    r1 = Router(bins=(32,), hbm_budget=budget, device=device)
    r2 = Router(bins=(32,), hbm_budget=budget, device=device)
    for _ in range(50):
        r1.admit("posv", 32)
        r2.admit("posv", 32)
    computes = serve_counts()["max_n_computes"] - c0["max_n_computes"]
    if computes != 1:
        failures.append(f"memo phase: 100 admissions across 2 routers evaluated the "
                        f"MemoryModel closed form {computes:.0f} times (want exactly 1 per "
                        "(op, nb, grid, dtype, budget) key)")
    return {"computes": computes}


def run_controller_phase(failures: list, device) -> dict:
    """(e): a seeded latency spike trips the control loop exactly once."""
    from ..obs import REGISTRY, live as obs_live
    from .cache import ExecutableCache
    from .controller import ServiceController
    from .metrics import serve_counts
    from .queue import BatchQueue, ManualClock
    from .router import Router

    router = Router(bins=(32,), hbm_budget=1 << 30, cache=ExecutableCache(), device=device)
    q = BatchQueue(router, max_batch=8, window_s=0.005, clock=ManualClock(), name="smoke_ctrl")
    # the failure latch out of reach: the earlier phases put reject outcomes
    # on the SLA surface, and this phase is about the latency latch
    ctrl = ServiceController(q, slo_p95_s=0.25, arm=2, cooldown=2, failure_rate_hi=0.9,
                             failure_rate_lo=0.0)
    base = (q.max_batch, q.window_s)
    c0 = serve_counts()
    # the spike: enough 2 s observations to own the pooled p95
    for _ in range(32):
        REGISTRY.observe("serve.latency_s", 2.0, op="posv", klass="friendly", outcome="served")
    if ctrl.signals()["p95_s"] < 1.0:
        failures.append("controller phase: seeded spike did not surface in the p95 signal")
    acted = []
    for _ in range(6):  # a held input
        acted += ctrl.step()
    trips = serve_counts()["controller_actuations"] - c0["controller_actuations"]
    if trips != 1:
        failures.append(f"controller phase: held spike produced {trips:.0f} actuations "
                        "(hysteresis should latch after exactly 1)")
    if not acted or acted[0]["action"] != "shrink_window":
        failures.append(f"controller phase: expected a shrink_window actuation, got "
                        f"{[a['action'] for a in acted]}")
    if (q.max_batch, q.window_s) == base or q.window_s >= base[1]:
        failures.append("controller phase: the actuation did not move the (B, T) knobs")
    if not any(e["kind"] == "controller" for e in obs_live.BUS.events()):
        failures.append("controller phase: no controller event on the telemetry bus")
    q.close()
    return {"trips": trips, "actions": [a["action"] for a in acted]}


def run_packed_phase(failures: list, device) -> dict:
    """(f): a ragged posv window in packed mode runs as one block-diagonal
    program."""
    import numpy as np
    import torch

    from ..linalg.chol import posv_array
    from . import trace as serve_trace
    from .cache import ExecutableCache
    from .metrics import serve_counts
    from .queue import BatchQueue, ManualClock
    from .router import Router

    rng = np.random.default_rng(29)
    clk = ManualClock()
    router = Router(bins=(32,), hbm_budget=1 << 30, cache=ExecutableCache(), device=device)
    q = BatchQueue(router, max_batch=8, window_s=0.005, clock=clk, dispatch="packed",
                   name="smoke_packed")
    sizes = (20, 28, 32)
    probs = [(_spd(rng, sz, device), _vec(rng, (sz, 1), device)) for sz in sizes]
    c0 = serve_counts()
    t0 = len(serve_trace.finished_traces())
    tks = [q.submit("posv", a, b) for a, b in probs]
    clk.advance(0.01)
    q.pump()
    c1 = serve_counts()
    if c1["queue_packed_dispatches"] - c0["queue_packed_dispatches"] != 1:
        failures.append("packed phase: 3 ragged requests did not dispatch as ONE packed "
                        "program")
    ok = True
    for tk, (a, b) in zip(tks, probs):
        ref, _f, info = posv_array(a, b)
        if int(info) != 0 or not torch.allclose(tk.result(), ref, rtol=1e-9, atol=1e-9):
            ok = False
    if not ok:
        failures.append("packed phase: unpacked solutions drifted from the solo solve past "
                        "factorization accuracy")
    outcomes = [t.outcome for t in serve_trace.finished_traces()[t0:]]
    if outcomes != ["served"] * len(sizes):
        failures.append(f"packed phase: outcomes {outcomes} != all served")
    q.close()
    return {"packed_ok": ok}


def run_smoke(out_dir: str = OUT_DIR, device=None) -> int:
    import json

    import torch

    from .. import obs
    from ..core.matrix import DEFAULT_DEVICE
    # load the bus first: phase (e) asserts the controller event reaches it
    # (the producers probe sys.modules)
    from ..obs import live as _obs_live  # noqa: F401
    from ..obs import report
    from . import metrics as serve_metrics
    from .cache import executable_cache

    device = torch.device(device if device is not None else DEFAULT_DEVICE)
    obs.reset()
    obs.enable()
    serve_metrics.reset()
    executable_cache.clear()
    failures: list = []

    stream = run_stream_phase(failures, device)
    budget = run_budget_phase(failures, device)
    memo = run_memo_phase(failures, device)
    ctrl = run_controller_phase(failures, device)
    packed = run_packed_phase(failures, device)

    os.makedirs(out_dir, exist_ok=True)
    rep_path = os.path.join(out_dir, "serve_queue.report.json")
    # every value is deterministic under the ManualClock workload; the
    # serve section's latency quantiles are wall clock
    report.write_report(
        rep_path, name="serve_queue",
        config={"n": 32, "batch": 8, "window_s": 0.005, "driver": "batch_queue_meshless",
                "clock": "manual", "device": str(device)},
        values={
            "serve.queue_stream_requests": float(stream["requests"]),
            "serve.queue_stream_windows": float(stream["windows"]),
            "serve.queue_stream_bitwise_ok": float(stream["bitwise"]),
            "serve.queue_drr_acme": float(stream["drr_split"]["acme"]),
            "serve.queue_drr_zeta": float(stream["drr_split"]["zeta"]),
            "serve.queue_budget_accepts": float(budget["accepted"]),
            "serve.queue_budget_rejections": float(budget["rejected"]),
            "serve.queue_memo_computes": float(memo["computes"]),
            "serve.queue_controller_trips": float(ctrl["trips"]),
            "serve.queue_packed_ok": float(packed["packed_ok"]),
        })
    with open(rep_path) as f:
        rep = json.load(f)
    errs = report.validate_report(rep)
    if errs:
        failures.append(f"RunReport schema: {errs}")
    if (rep.get("serve") or {}).get("queue_submitted", 0) <= 0:
        failures.append("serve section missing queue counters -- obs.report is not folding "
                        "serve.queue_* in")
    obs.disable()

    if failures:
        print(f"serve.queue_smoke: FAILED with {len(failures)} problem(s):")
        for msg in failures:
            print(f"  FAIL {msg}")
        return 1
    print(f"serve.queue_smoke: OK -- {stream['requests']} requests in {stream['windows']:.0f} "
          f"windows (0 rebuilds, bitwise parity), DRR split {stream['drr_split']}, "
          f"{budget['rejected']} budget reject(s), 1 memo compute, {ctrl['trips']:.0f} "
          f"controller trip, packed dispatch OK, report {rep_path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.serve.queue_smoke")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_smoke(args.out, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
