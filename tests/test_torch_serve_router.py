"""The port's serve.Router on one device against slate_tpu's: admission,
the condest accuracy classes, cached stacked dispatch, the batch-abort
sweep and the request traces.

Same numpy inputs to both routers (meshless, bins (32,), 1 GiB budget,
each with a fresh executable cache).  Held exactly: the ``serve.*`` counter
deltas, each request's phase names / parents / metadata, notes, class, bin,
batch and outcome, the meshless ``max_n`` and ``predict_max_n``.  The
solutions are held to the refined solve's class (f64 IR to the normwise
gate: elementwise within 1e-10 of ``slate_tpu``'s at n = 32, + n I), the
hostile class to its residual as in tests/test_serve.py.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_serve_common import (
    EPS,
    clear_admission_memos,
    counter_deltas,
    hostile_np,
    j,
    phase_record,
    spd_np,
    spd_stack_np,
    t,
)

from slate_tpu import obs as jobs
from slate_tpu.obs import memmodel as jmemmodel
from slate_tpu.serve import trace as jtrace
from slate_tpu.serve.cache import ExecutableCache as JCache
from slate_tpu.serve.router import Router as JRouter
from slate_tpu.types import SlateError as JSlateError
from slate_tpu_torch import obs
from slate_tpu_torch.obs import memmodel, perfetto
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.router import Router, _build_batched
from slate_tpu_torch.types import SlateError

torch.set_num_threads(1)

N = 32


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def routers(budget=1 << 30, bins=(N,)):
    return (JRouter(bins=bins, hbm_budget=budget, cache=JCache()),
            Router(bins=bins, hbm_budget=budget, cache=ExecutableCache(), device="cpu"))


def friendly_np(rng, n=N):
    return rng.standard_normal((n, n)) + n * np.eye(n)


def test_router_accuracy_class_dispatch_matches_jax(rng):
    """tests/test_serve.py's accuracy-class walk in both packages: the
    friendly and hostile classes, the condest memo hit, the admission
    reject and the nonzero-info refusal, with equal counter deltas."""
    clear_admission_memos()
    jr, tr_ = routers()
    good = friendly_np(rng)
    bad = hostile_np(rng, N)
    b = rng.standard_normal((N, 2))
    b2 = rng.standard_normal((N, 2))
    good_t = t(good)  # one tensor object: the memo's stationary operator
    good_j = j(good)
    with counter_deltas() as d:
        xj = jr.solve("gesv", good_j, j(b))
        xt = tr_.solve("gesv", good_t, t(b))
        xbj = jr.solve("gesv", j(bad), j(b))
        xbt = tr_.solve("gesv", t(bad), t(b))
        jr.solve("gesv", good_j, j(b2))
        tr_.solve("gesv", good_t, t(b2))
    assert d["jax"] == d["torch"]
    assert d["torch"]["class_friendly"] == 2 and d["torch"]["class_hostile"] == 1
    assert d["torch"]["condest_cache_hits"] == 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10, atol=1e-12)
    assert np.abs(bad @ xbt.numpy() - b).max() < 1e-4  # cond 1e9: GMRES-IR lands a usable x
    assert np.abs(good @ xt.numpy() - b).max() < 1e-8
    # admission: a router whose budget admits nothing rejects in both
    jt, tt = routers(budget=10_000)
    a_spd = spd_np(rng, N)
    with counter_deltas() as d:
        with pytest.raises(JSlateError, match="admission"):
            jt.solve("posv", j(a_spd), j(b))
        with pytest.raises(SlateError, match="admission"):
            tt.solve("posv", t(a_spd), t(b))
    assert d["jax"] == d["torch"] and d["torch"]["admission_rejects"] == 1
    # a failed factorization is refused, never served
    with counter_deltas() as d:
        with pytest.raises(JSlateError, match="nonzero info"):
            jr.solve("posv", j(-np.eye(N)), j(b))
        with pytest.raises(SlateError, match="nonzero info"):
            tr_.solve("posv", t(-np.eye(N)), t(b))
    assert d["jax"] == d["torch"]


@pytest.mark.parametrize("ops", [("posv", "posv", "posv"), ("gesv", "posv", "gesv"),
                                 ("gesv", "gesv", "gesv", "posv")])
def test_solve_batch_groups_and_counters_match_jax(rng, ops):
    """A ragged solve_batch (sizes 20-32 in bin 32, 1-D and 2-D right-hand
    sides): the groups, the cache misses and hits of a second pass, and the
    solutions (posv bitwise its own single verb in the port; within 1e-10 of
    slate_tpu's)."""
    clear_admission_memos()
    jr, tr_ = routers()
    sizes = [N - 4 * i for i in range(len(ops))]
    reqs = []
    for op, n in zip(ops, sizes):
        a = spd_np(rng, n) if op == "posv" else friendly_np(rng, n)
        b = rng.standard_normal(n) if n % 8 else rng.standard_normal((n, 2))
        reqs.append((op, a, b))
    for _ in range(2):  # the second pass hits every key
        with counter_deltas() as d:
            xj = jr.solve_batch([(op, j(a), j(b)) for op, a, b in reqs])
            xt = tr_.solve_batch([(op, t(a), t(b)) for op, a, b in reqs])
        assert d["jax"] == d["torch"], (d["jax"], d["torch"])
    assert len(tr_.cache) == len(jr.cache)
    tr_.cache.assert_steady()
    for (op, a, b), x1, x2 in zip(reqs, xj, xt):
        assert x2.shape == tuple(np.shape(b))
        np.testing.assert_allclose(x2.numpy(), np.asarray(x1), rtol=1e-10, atol=1e-12)


def test_meshless_admission_equals_jax():
    """The meshless max_n is slate_tpu's exactly for every request op (its
    per-device model at grid (1, 1)), and so is predict_max_n's
    ``device_peak_bytes`` form across ops, grids and tile sizes."""
    budget = 16 * 2**30
    clear_admission_memos()
    jr = JRouter(hbm_budget=budget)
    tr_ = Router(hbm_budget=budget, device="cpu")
    for op in ("posv", "gesv", "potrf", "gemm", "geqrf", "gels", "heev", "he2hb"):
        assert tr_.max_n(op) == jr.max_n(op), op
    assert tr_.max_n("heev") < tr_.max_n("gesv")
    with pytest.raises(SlateError, match="admission"):
        tr_.admit("heev", tr_.max_n("heev") + 8 * 4 * 256)
    for op in ("potrf", "getrf_nopiv", "summa", "trsm", "geqrf", "he2hb"):
        for grid in ((1, 1), (2, 4)):
            for nb in (8, 64):
                for b in (1 << 30, 3 * 2**20):
                    want = jmemmodel.predict_max_n(b, op=op, nb=nb, grid=grid, dtype="float64")
                    got = memmodel.predict_max_n(b, op=op, nb=nb, grid=grid, dtype="float64",
                                                 peak="device_peak_bytes")
                    assert got == want, (op, grid, nb, b)


@pytest.mark.parametrize("op,model_op", [("posv", "potrf"), ("gesv", "getrf_nopiv"),
                                         ("gels", "geqrf"), ("heev", "he2hb")])
def test_mesh_router_admits_by_the_virtual_mesh(op, model_op):
    """A mesh router admits by the whole virtual mesh's peak (one card holds
    every shard): the model's virtual_peak_bytes at max_n fits the budget
    and one tile-grid step more does not; the per-device bound would admit
    more."""
    from slate_tpu_torch.parallel import make_mesh

    budget = 1 << 30
    r = Router(mesh=make_mesh(2, 4, device="cpu"), nb=64, hbm_budget=budget)
    n = r.max_n(op)
    step = 64 * 4
    fits = memmodel.MemoryModel(model_op, n, 64, (2, 4), "float64").virtual_peak_bytes
    over = memmodel.MemoryModel(model_op, n + step, 64, (2, 4), "float64").virtual_peak_bytes
    assert fits <= budget < over
    assert n < memmodel.predict_max_n(budget, op=model_op, nb=64, grid=(2, 4), dtype="float64")
    with pytest.raises(SlateError, match="admission"):
        r.admit(op, n + step)


def test_admission_memo_counts_each_key_once():
    clear_admission_memos()
    with counter_deltas() as d:
        for _ in range(3):
            jr, tr_ = routers(budget=2 << 30)
            for op in ("posv", "gesv", "gels"):
                jr.max_n(op)
                tr_.max_n(op)
    assert d["jax"] == d["torch"] == {"max_n_computes": 3}  # potrf, getrf_nopiv, geqrf


def test_condest_memo_misses_after_a_write_in_place(rng):
    """The memo is keyed on the operand's storage and version counter and
    checked bitwise: a hit for the untouched operand, a miss (a fresh
    estimate) after a write in place and after a write through ``.data``."""
    _jr, tr_ = routers()
    a = t(friendly_np(rng))
    from slate_tpu_torch.obs.metrics import serve_counts

    def hits():
        return serve_counts()["condest_cache_hits"]

    tr_.classify("gesv", a)
    h0 = hits()
    tr_.classify("gesv", a)
    assert hits() == h0 + 1
    a[0, 0] += 1.0  # bumps the version counter
    tr_.classify("gesv", a)
    assert hits() == h0 + 1
    tr_.classify("gesv", a)
    assert hits() == h0 + 2
    a.data[1, 1] += 1.0  # no version bump: caught by the bitwise check
    tr_.classify("gesv", a)
    assert hits() == h0 + 2
    # a hostile operand written to friendly in place re-classifies
    bad = t(hostile_np(rng, N))
    assert tr_.classify("gesv", bad) == "hostile"
    bad.copy_(a)
    assert tr_.classify("gesv", bad) == "friendly"


def test_request_traces_match_jax(rng):
    """With obs on, each request of one stream (friendly / hostile gesv,
    posv, an admission reject) carries the same phase sequence, notes,
    class, bin, batch and outcome in both packages, and the SLA keys
    (counts and outcome totals) agree."""
    clear_admission_memos()
    jr, tr_ = routers()
    b = rng.standard_normal((N, 2))
    stream = [("gesv", friendly_np(rng)), ("posv", spd_np(rng, N)), ("gesv", hostile_np(rng, N)),
              ("posv", spd_np(rng, 24))]
    recs = {}
    for name, (r, conv, on, traces, err) in {
            "jax": (jr, j, jobs.force_enabled, jtrace, JSlateError),
            "torch": (tr_, t, obs.force_enabled, rtrace, SlateError)}.items():
        with on(True):
            traces.reset()
            for op, a in stream:
                r.solve(op, conv(a), conv(b[:a.shape[0]]))
            r.solve_batch([("posv", conv(a), conv(b)) for a in
                           (spd_np(np.random.default_rng(5), N), spd_np(np.random.default_rng(6), N))])
            tiny = (JRouter if name == "jax" else Router)(bins=(N,), hbm_budget=10_000,
                                                          **({} if name == "jax" else
                                                             {"device": "cpu"}))
            with pytest.raises(err, match="admission"):
                tiny.solve("posv", conv(stream[1][1]), conv(b))
            recs[name] = [phase_record(x) for x in traces.finished_traces()]
            sla = traces.sla_values()
            recs[name + "_sla"] = {k: v for k, v in sla.items() if not k.endswith("_s")}
    assert recs["jax"] == recs["torch"]
    assert recs["jax_sla"] == recs["torch_sla"]
    outcomes = [r["outcome"] for r in recs["torch"]]
    assert outcomes == ["served"] * 6 + ["reject_admission"]
    assert [r["batch"] for r in recs["torch"]] == [1, 1, 1, 1, 2, 2, 1]


def test_request_trace_disabled_honest_and_dispatch_identical(rng):
    """Obs off: no trace is allocated and the finished stream does not
    grow; the solution bits equal the traced run's; the request timeline of
    the traced request validates, with its class track."""
    n = N
    good = t(friendly_np(rng, n))
    b = t(rng.standard_normal((n, 2)))
    _jr, router = routers()
    with obs.force_enabled(False):
        assert rtrace.new_trace("gesv", n, 8, "float64") is None
        before = len(rtrace.finished_traces())
        x_off = router.solve("gesv", good, b)
        assert len(rtrace.finished_traces()) == before
    with obs.force_enabled(True):
        x_on = router.solve("gesv", good, b)
        traces = rtrace.finished_traces()[before:]
    assert len(traces) == 1 and traces[0].outcome == "served"
    assert torch.equal(x_off, x_on)
    fn = _build_batched("posv", "friendly")
    spd = t(spd_stack_np(rng, 1, 16))
    bb = t(rng.standard_normal((1, 16, 1)))
    with obs.force_enabled(False):
        y_off = fn(spd, bb)[0]
    with obs.force_enabled(True):
        y_on = fn(spd, bb)[0]
    assert torch.equal(y_off, y_on)
    sla = rtrace.sla_values()
    assert sla["latency_count_gesv_friendly"] >= 1
    assert 0 <= sla["latency_p50_gesv_friendly_s"] <= sla["latency_p99_gesv_friendly_s"]
    total = sum(v for k, v in sla.items() if k.startswith("outcome_")
                and not k.startswith("outcome_rate_"))
    assert total == len(rtrace.finished_traces())
    evs = perfetto.request_trace_events(traces)
    assert perfetto.validate_chrome_trace({"traceEvents": evs}) == []
    assert any(e.get("args", {}).get("name") == "serve[friendly]"
               for e in evs if e.get("ph") == "M")


def test_request_trace_batch_abort_attributes_siblings(rng):
    """A failing request aborts the whole call: its own trace carries
    failed_info, the sibling reject_batch_abort, in both packages."""
    jr, tr_ = routers()
    good = spd_np(rng, N)
    b = rng.standard_normal((N, 2))
    got = {}
    for name, (r, conv, on, traces, err) in {
            "jax": (jr, j, jobs.force_enabled, jtrace, JSlateError),
            "torch": (tr_, t, obs.force_enabled, rtrace, SlateError)}.items():
        with on(True):
            before = len(traces.finished_traces())
            with pytest.raises(err, match="nonzero info"):
                r.solve_batch([("posv", conv(good), conv(b)), ("posv", conv(-np.eye(N)), conv(b))])
            got[name] = [x.outcome for x in traces.finished_traces()[before:]]
    assert got["jax"] == got["torch"]
    assert sorted(got["torch"]) == ["failed_info", "reject_batch_abort"]


def test_unified_trace_ties_requests_to_their_dispatch_spans(rng):
    """The unified timeline: the request tracks, the serve.dispatch driver
    spans carrying each request's trace_id, one flow pair per (request,
    span), valid for the validator."""
    _jr, router = routers()
    with obs.force_enabled(True):
        obs.reset()
        router.solve_batch([("posv", t(spd_np(rng, N)), t(rng.standard_normal((N, 1))))
                            for _ in range(2)])
        traces = rtrace.finished_traces()
        doc = perfetto.unified_chrome_trace(traces)
    assert perfetto.validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    spans = [e for e in evs if e.get("cat") == "driver" and e["name"] == "serve.dispatch"]
    assert spans and all(e["args"].get("trace_id") for e in spans)
    flows = [e for e in evs if e.get("cat") == "traceflow"]
    starts = [e for e in flows if e["ph"] == "s"]
    assert len(starts) == len([e for e in flows if e["ph"] == "f"]) >= 1
    ids = {x.trace_id for x in traces}
    assert {e["args"]["trace_id"] for e in starts} <= ids


@pytest.mark.parametrize("outcome", ["served", "served_retry", "reject_residual", "failed_error"])
def test_trace_is_single_shot(outcome):
    with obs.force_enabled(True):
        tr = rtrace.new_trace("posv", 8, 8, "float64")
        tr.finish(outcome)
        with pytest.raises(RuntimeError, match="already terminal"):
            tr.finish("served")
    with pytest.raises(ValueError, match="unknown terminal"):
        rtrace.RequestTrace("posv", 8, 8, "float64").finish("served_somehow")


@pytest.mark.parametrize("notes,want", [((), "served"), (("ft_retry",), "served_retry"),
                                        (("resume",), "served_resume"),
                                        (("ft_retry", "resume"), "served_resume"),
                                        (("resume", "growth_retry"), "served_growth_retry"),
                                        (("orth_retry",), "served")])
def test_note_attribution(notes, want):
    tr = rtrace.RequestTrace("gesv", 8, 8, "float64")
    for kind in notes:
        tr.note(kind)
    assert tr.terminal() == want
    with pytest.raises(ValueError, match="unknown degradation"):
        tr.note("made_up")


def test_eps_class_of_the_friendly_tier(rng):
    """The friendly tier's solution meets the refinement's normwise gate
    (||r|| <= ||x|| ||A|| n eps) on a well-conditioned operand."""
    _jr, router = routers()
    a = friendly_np(rng)
    b = rng.standard_normal((N, 3))
    x = router.solve("gesv", t(a), t(b)).numpy()
    r = np.abs(a @ x - b).max()
    assert r <= np.abs(x).max() * np.abs(a).sum(axis=1).max() * N * EPS
