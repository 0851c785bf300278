"""The port's batch-window queue against slate_tpu's: B-fill against
T-expiry, FIFO within a tenant, weighted DRR and starvation freedom,
per-tenant budget rejections, admission hardening, the one-terminal contract
across a mid-batch abort, the Router.max_n memo and the tier override.

tests/test_service_queue.py's cases, each run on both packages' queues
(meshless, n = 16 in one bin, each on its own ManualClock) fed the same
numpy operands.  Held exactly: the dispatch logs (key strings, causes,
tenants in ticket order, seqs ranked among the test's submits), the
``serve.*`` counter deltas, the terminal outcomes and the DRR deficits.
Answers: within 1e-12 of slate_tpu's (SPD, cond < 10) and bitwise the
port's own one-at-a-time Router.solve.  No test waits on wall time but the
ticket timeout (bounded at 0.01 s).
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_queue_common import (
    BIN,
    N,
    assert_answers,
    counter_deltas,
    live_obs,  # noqa: F401 (fixture)
    outcomes,
    pair,
    routers,
    spd_np,
    t,
)
from torch_serve_common import clear_admission_memos

from slate_tpu.serve import trace as jtrace
from slate_tpu.serve.budget import request_cost as jrequest_cost
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.budget import BudgetLedger, request_cost
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.queue import BatchQueue, ManualClock, _key_str
from slate_tpu_torch.serve.router import Router
from slate_tpu_torch.types import SlateError

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def rhs(rng, *shape):
    return rng.standard_normal(shape or (N,))


# ---------------------------------------------------------------------------
# window closes: B-fill against T-expiry
# ---------------------------------------------------------------------------


def test_b_fill_closes_before_deadline(rng, live_obs):  # noqa: F811
    """The Bth compatible submit closes the window at once (the clock never
    moves), in both packages: one "full" close of 3, served."""
    with pair("t_bfill", max_batch=3) as p:
        with counter_deltas() as d:
            for _ in range(3):
                p.submit("posv", spd_np(rng), rhs(rng))
        assert all(tk.done() for tk in p.ttk)
        assert p.tq.dispatch_log[-1]["cause"] == "full"
        p.assert_same_logs()
        assert [tk.trace.outcome for tk in p.ttk] == ["served"] * 3
        assert d["torch"] == d["jax"]
        assert d["torch"]["queue_window_full"] == 1 and d["torch"]["queue_windows"] == 1
        assert_answers(p)


def test_t_expiry_closes_underfull_window(rng, live_obs):  # noqa: F811
    """Below B nothing dispatches until the clock crosses the deadline; the
    close is then "expired", and each answer is bitwise the port's
    one-at-a-time Router dispatch."""
    with pair("t_texp", max_batch=8, window_s=0.005) as p:
        with counter_deltas() as d:
            for _ in range(2):
                p.submit("posv", spd_np(rng), rhs(rng))
            assert p.pump() == (0, 0)
            assert not p.ttk[0].done()
            with pytest.raises(SlateError):
                p.ttk[0].result()
            p.advance(0.005)
            assert p.pump() == (2, 2)
        assert p.tq.dispatch_log[-1]["cause"] == "expired"
        p.assert_same_logs()
        assert d["torch"] == d["jax"]
        assert_answers(p)


def test_ticket_wait_times_out(rng, live_obs):  # noqa: F811
    with pair("t_wait", max_batch=8) as p:
        _jk, tk = p.submit("posv", spd_np(rng), rhs(rng))
        with pytest.raises(TimeoutError):
            tk.wait(timeout=0.01)


# ---------------------------------------------------------------------------
# dequeue order: FIFO within a tenant, weighted DRR across tenants
# ---------------------------------------------------------------------------


def test_fifo_within_tenant(rng, live_obs):  # noqa: F811
    with pair("t_fifo", max_batch=8) as p:
        for _ in range(5):
            p.submit("posv", spd_np(rng), rhs(rng), tenant="solo")
        p.advance(0.01)
        p.pump()
        served = [seq for seq, _t in p.tq.dispatch_log[-1]["tickets"]]
        assert served == [tk.seq for tk in p.ttk]
        p.assert_same_logs()


def _drr_contended(rng, p, per_tenant, k):
    """``per_tenant`` requests of acme and zeta interleaved into one
    oversubscribed window, closed at ``max_batch = k``, then the leftover's
    expiry."""
    p.set(max_batch=100)  # no B-fill while loading the window
    for _ in range(per_tenant):
        for tenant in ("acme", "zeta"):
            p.submit("posv", spd_np(rng), rhs(rng), tenant=tenant)
    p.set(max_batch=k)
    p.advance(0.01)
    p.pump()          # the contended close: DRR takes k of 2 per_tenant
    p.advance(0.01)
    p.pump()          # the reopened leftover window expires
    assert all(tk.done() for tk in p.ttk)
    return p.tq.dispatch_log[-2]["tickets"], p.tq.dispatch_log[-1]["tickets"]


def test_drr_equal_weights_split_evenly(rng, live_obs):  # noqa: F811
    with pair("t_drr1") as p, counter_deltas() as d:
        first, _rest = _drr_contended(rng, p, per_tenant=4, k=4)
        assert sorted(tn for _s, tn in first) == ["acme", "acme", "zeta", "zeta"]
        p.assert_same_logs()
    assert d["torch"] == d["jax"]


def test_drr_weighted_fairness_and_starvation_freedom(rng, live_obs):  # noqa: F811
    """At weights 2:1 the contended close serves acme:zeta 6:2 in both
    packages (both tenants present: no starvation), FIFO per tenant across
    the close and the leftover's, and the deficits after each close equal."""
    with pair("t_drr2", weights={"acme": 2.0, "zeta": 1.0}) as p:
        with counter_deltas() as d:
            first, rest = _drr_contended(rng, p, per_tenant=6, k=8)
        assert d["torch"] == d["jax"]
        n_first = {tn: sum(1 for _s, x in first if x == tn) for tn in ("acme", "zeta")}
        assert n_first == {"acme": 6, "zeta": 2}
        for tn in ("acme", "zeta"):
            seqs = [s for s, x in first + rest if x == tn]
            assert seqs == sorted(seqs)
        p.assert_same_logs()
        assert p.tq._deficit == p.jq._deficit
        assert_answers(p)


# ---------------------------------------------------------------------------
# per-tenant budgets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [4, 8])
def test_request_cost_matches_jax(itemsize):
    assert request_cost(BIN, itemsize) == jrequest_cost(BIN, itemsize)


def test_budget_reject_is_terminal_and_isolated(rng, live_obs):  # noqa: F811
    """A tenant over its declared budget is refused at submit with the
    reject_budget terminal in both packages; another tenant is untouched,
    and dispatch releases every reservation (the peak never over budget)."""
    budget = int(2.5 * request_cost(BIN, 8))  # room for two reservations
    with pair("t_budget", max_batch=8, budgets={"hog": budget}) as p, counter_deltas() as d:
        for _ in range(2):
            p.submit("posv", spd_np(rng), rhs(rng), tenant="hog")
        p.submit_raises("posv", spd_np(rng), rhs(rng), tenant="hog", match="budget")
        rejected = [tr for tr in rtrace.finished_traces() if tr.outcome == "reject_budget"]
        assert len(rejected) == 1 and rejected[0].tenant == "hog"
        p.submit("posv", spd_np(rng), rhs(rng), tenant="calm")
        p.advance(0.01)
        p.pump()
        tsnap, jsnap = p.tq.ledger.snapshot(), p.jq.ledger.snapshot()
        assert tsnap["hog"] == jsnap["hog"]
        assert tsnap["hog"]["reserved_bytes"] == 0
        assert 0 < tsnap["hog"]["peak_bytes"] <= budget
        for snap in (tsnap, jsnap):  # the calm tenant's default budget
            assert (snap["calm"]["reserved_bytes"], snap["calm"]["peak_bytes"]) == (
                0, request_cost(BIN, 8))
        p.assert_same_logs()
        assert outcomes(rtrace) == outcomes(jtrace)
    assert d["torch"] == d["jax"]
    assert d["torch"]["queue_budget_rejects"] == 1


def test_default_tenant_budget_is_the_routers():
    """Without a ledger, an undeclared tenant's budget is the router's
    device budget (the card's under HBM_SAFETY by default)."""
    r = Router(bins=(BIN,), hbm_budget=123_456_789, cache=ExecutableCache(), device="cpu")
    q = BatchQueue(r, clock=ManualClock(), name="t_default_budget")
    try:
        assert q.ledger.account("anyone").budget == 123_456_789
    finally:
        q.close()


# ---------------------------------------------------------------------------
# admission hardening: malformed shapes, degenerate weights
# ---------------------------------------------------------------------------


def test_malformed_shapes_rejected_at_submit(rng, live_obs):  # noqa: F811
    """A non-square operand or a mismatched rhs is refused at submit as
    reject_admission in both packages; it never enters a window, and a
    well-formed request on the same queue still serves."""
    with pair("t_malformed", max_batch=4) as p, counter_deltas() as d:
        p.submit_raises("posv", np.zeros((N, N - 2)), np.zeros((N,)), match="square")
        p.submit_raises("posv", spd_np(rng), np.zeros((N + 4,)), match="rhs")
        p.submit_raises("posv", spd_np(rng), np.zeros((N, 2, 2)), match="rhs")
        assert p.tq.depth() == 0 == p.jq.depth()
        assert outcomes(rtrace).count("reject_admission") == 3
        assert all(v["reserved_bytes"] == 0 for v in p.tq.ledger.snapshot().values())
        p.submit("posv", spd_np(rng), rhs(rng))
        p.advance(0.01)
        p.pump()
        assert p.ttk[-1].trace.outcome == "served"
        assert outcomes(rtrace) == outcomes(jtrace)
    assert d["torch"] == d["jax"]


def test_over_bin_submit_rejected(rng, live_obs):  # noqa: F811
    with pair("t_overbin") as p, counter_deltas() as d:
        p.submit_raises("posv", spd_np(rng, 2 * N), rhs(rng, 2 * N), match="bin")
        assert outcomes(rtrace) == outcomes(jtrace) == ["reject_admission"]
    assert d["torch"] == d["jax"] == {"admission_rejects": 1}


def test_nonpositive_weight_rejected_at_construction():
    """A weight <= 0 (or NaN) fails fast: its deficit would never reach 1."""
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="weight"):
            BudgetLedger(weights={"t": bad}, default_budget=1 << 30)
    with pytest.raises(ValueError, match="weight"):
        BudgetLedger(default_weight=0.0, default_budget=1 << 30)


def test_drr_progresses_under_degenerate_runtime_weight(rng, live_obs):  # noqa: F811
    """A ledger that hands back weight 0 at dequeue time: selection
    force-serves the head-of-line tenant instead of spinning."""
    with pair("t_degen", max_batch=8) as p:
        for _ in range(3):
            p.submit("posv", spd_np(rng), rhs(rng), tenant="stuck")
        p.tq.ledger.account("stuck").weight = 0.0
        p.jq.ledger.account("stuck").weight = 0.0
        p.advance(0.01)
        assert p.pump() == (3, 3)
        assert all(tk.trace.outcome == "served" for tk in p.ttk)
        p.assert_same_logs()
        assert p.tq._deficit == p.jq._deficit


def test_deficit_preserved_across_windows(rng, live_obs):  # noqa: F811
    """Accrued DRR credit survives one window's close while the tenant has
    entries in another open window; it resets on a full drain."""
    with pair("t_deficit", max_batch=8, weights={"acme": 1.7}) as p:
        p.submit("posv", spd_np(rng), rhs(rng), tenant="acme")          # nrhs 1
        p.submit("posv", spd_np(rng), rhs(rng, N, 2), tenant="acme")    # nrhs 2
        with p.tq._lock:
            k1, k2 = list(p.tq._windows)
        assert [_key_str(k) for k in (k1, k2)] == [_key_str(k) for k in p.jq._windows]
        p.tq._close_key(k1, "expired")
        p.jq._close_key(list(p.jq._windows)[0], "expired")
        assert p.tq._deficit["acme"] == pytest.approx(0.7)
        assert p.tq._deficit == p.jq._deficit
        p.tq._close_key(k2, "expired")
        p.jq._close_key(list(p.jq._windows)[0], "expired")
        assert p.tq._deficit["acme"] == 0.0 == p.jq._deficit["acme"]
        assert p.ttk[1].trace.outcome == "served"
        p.assert_same_logs()


def test_ticket_seqs_unique_across_queues(rng, live_obs):  # noqa: F811
    """Ticket numbers are process-wide: two queues never issue one seq."""
    _jr, ra = routers()
    _jr, rb = routers()
    qa = BatchQueue(ra, max_batch=8, clock=ManualClock(), name="t_seq_a")
    qb = BatchQueue(rb, max_batch=8, clock=ManualClock(), name="t_seq_b")
    try:
        seqs = [q.submit("posv", t(spd_np(rng)), t(rhs(rng))).seq for q in (qa, qb, qa, qb)]
        assert len(set(seqs)) == 4
        qa.drain()
        qb.drain()
    finally:
        qa.close()
        qb.close()


# ---------------------------------------------------------------------------
# one terminal per request, a mid-batch abort included
# ---------------------------------------------------------------------------


def test_mid_batch_abort_exactly_one_terminal(rng, live_obs):  # noqa: F811
    """A non-SPD operand in a posv window aborts the whole dispatch in both
    packages: the offender failed_info, every sibling reject_batch_abort,
    every ticket failed, every reservation released."""
    with pair("t_abort", max_batch=8) as p, counter_deltas() as d:
        for _ in range(2):
            p.submit("posv", spd_np(rng), rhs(rng))
        p.submit("posv", -np.eye(N), rhs(rng))
        p.advance(0.01)
        with pytest.raises(SlateError, match="info"):
            p.tq.pump()
        with pytest.raises(Exception, match="info"):
            p.jq.pump()
        assert [tk.trace.outcome for tk in p.ttk] == [
            "reject_batch_abort", "reject_batch_abort", "failed_info"]
        assert [tk.trace.outcome for tk in p.ttk] == [tk.trace.outcome for tk in p.jtk]
        for tk in p.ttk:
            assert tk.state == "failed"
            with pytest.raises(SlateError):
                tk.result()
        assert all(v["reserved_bytes"] == 0 for v in p.tq.ledger.snapshot().values())
        p.assert_same_logs()
    assert d["torch"] == d["jax"]


# ---------------------------------------------------------------------------
# Router.max_n memo; the tier override
# ---------------------------------------------------------------------------


def test_max_n_memoized_across_router_instances():
    """The closed form evaluates once per key process-wide in both packages:
    100 admissions over two Router instances compute it once."""
    clear_admission_memos()
    budget = 876_543_219
    with counter_deltas() as d:
        for _ in range(2):
            jr, tr_ = routers(budget)
            for _ in range(50):
                jr.admit("posv", N)
                tr_.admit("posv", N)
    assert d["torch"] == d["jax"] == {"max_n_computes": 1}


def test_tier_map_moves_window_class(rng, live_obs):  # noqa: F811
    """The controller's tier override changes the class every later submit
    is windowed and dispatched under, in both packages."""
    with pair("t_tier", max_batch=8) as p:
        a, b = spd_np(rng), rhs(rng)
        assert p.tq.router.effective_class("posv", t(a)) == "friendly"
        for q in (p.tq, p.jq):
            q.router.tier_map = {"friendly": "hostile"}
        assert p.tq.router.effective_class("posv", t(a)) == "hostile"
        p.submit("posv", a, b)
        with p.tq._lock:
            (key,) = p.tq._windows.keys()
        assert key[1] == "hostile"
        assert [_key_str(k) for k in p.tq._windows] == [_key_str(k) for k in p.jq._windows]
        p.advance(0.01)
        p.pump()
        assert p.ttk[0].trace.outcome == "served" and p.ttk[0].trace.klass == "hostile"
        p.assert_same_logs()


def test_mixed_stream_windows_by_key(rng, live_obs):  # noqa: F811
    """posv and gesv (nrhs 1 and 2) interleaved: the windows, their keys and
    the closes are slate_tpu's, with dtype names "float64" in the keys, and
    the gesv answers within the refined solve's class of slate_tpu's."""
    with pair("t_mixed", max_batch=3) as p, counter_deltas() as d:
        for i in range(7):
            op = "gesv" if i % 2 else "posv"
            a = (rng.standard_normal((N, N)) + N * np.eye(N)) if op == "gesv" else spd_np(rng)
            p.submit(op, a, rhs(rng, N, 1 + i % 3 // 2))
        p.advance(0.01)
        p.pump()
        p.assert_same_logs()
        keys = {e["key"] for e in p.tq.dispatch_log}
        assert all(k.endswith("/float64") for k in keys) and len(keys) >= 3
        for jk, tk in zip(p.jtk, p.ttk):
            np.testing.assert_allclose(tk.result().numpy(), np.asarray(jk.result()),
                                       rtol=1e-10, atol=1e-12)
    assert d["torch"] == d["jax"]


def test_numpy_operands_take_the_routers_device(rng, live_obs):  # noqa: F811
    """A numpy or list operand becomes a tensor on the router's device at
    submit (here the host router's), so a window stacks tensors that are
    there; a list of Python floats is torch's default dtype, float32."""
    with pair("t_numpy", max_batch=2) as p:
        a, b = spd_np(rng), rhs(rng)
        tk = p.tq.submit("posv", a, b)
        tk2 = p.tq.submit("posv", a, b)
        assert tk.done() and tk2.done()
        assert tk.result().device.type == "cpu"
        assert torch.equal(tk.result(), p.tq.router.solve("posv", t(a), t(b)))
        assert p.tq.dispatch_log[-1]["key"] == f"posv/friendly/n{BIN}/rhs1/float64"
        tk3 = p.tq.submit("posv", a.tolist(), b.tolist())
        p.tq.drain()
        assert tk3.result().dtype == torch.float32
        assert p.tq.dispatch_log[-1]["key"] == f"posv/friendly/n{BIN}/rhs1/float32"
        np.testing.assert_allclose(tk3.result().numpy(), tk.result().numpy(), rtol=1e-5)


def test_queue_stats_match_jax(rng, live_obs):  # noqa: F811
    """queue_stats() (the /queue.json body) of an equivalent open window is
    slate_tpu's: depth, windows and their key strings and times, knobs, and
    the declared tenant's ledger row and deficit."""
    from slate_tpu.serve.queue import queue_stats as jqueue_stats
    from slate_tpu_torch.serve.queue import queue_stats

    with pair("t_stats", max_batch=8, budgets={"acme": 1 << 30}) as p:
        p.submit("posv", spd_np(rng), rhs(rng), tenant="acme")
        ts, js = queue_stats()["queues"]["t_stats"], jqueue_stats()["queues"]["t_stats"]
        assert ts == js
        assert ts["depth"] == 1 and ts["open_windows"] == 1
        p.jq.drain()
        p.tq.drain()
        assert queue_stats()["queues"]["t_stats"] == jqueue_stats()["queues"]["t_stats"]
