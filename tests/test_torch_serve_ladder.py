"""The port's resilient router's request traces and its gels tier against
slate_tpu's: every ladder path's phase sequence, notes and outcome, the
CAQR gels tier with its re-orthogonalization retry, the unarmed mesh
router's stacked path, and the mesh condest memo the serving stream
reuses.

Shapes and pins as tests/test_torch_serve_resilient.py (2 x 4, n = 64,
nb = 8, ``xla`` panels).  Held exactly: phase sequences (names, parents,
depths, metadata), notes, class, bin, batch, outcomes and the ``serve.*``
counter deltas; gels x within 1e-9 of slate_tpu's and of the library's
least-squares solution (the CAQR f64 class at 64 x 40).
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_serve_common import (
    MESH_N as N,
    Side,
    both,
    clear_admission_memos,
    counter_deltas,
    j,
    jmesh24,
    mesh_operands as operands,
    no_mesh_env,  # noqa: F401 (an autouse fixture)
    phase_record,
    spd_np,
    t,
    tmesh24,
)

from slate_tpu_torch import obs
from slate_tpu_torch.ft.policy import FtPolicy
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.router import Router
from slate_tpu_torch.types import Option, SlateError

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


LADDER = {
    "clean": ("served", {Option.Checkpoint: 3}, "posv", "spd", None, {}),
    "ft_retry": ("served_retry", {Option.FaultTolerance: FtPolicy.Detect}, "posv", "spd",
                 ("fault", 12, "potrf", 8, (2, 4)), {"phase": "panel"}),
    "resume": ("served_resume", {Option.Checkpoint: 3}, "posv", "spd", ("kill", "potrf", 4), {}),
    "growth_abort": ("served_growth_retry", {Option.Checkpoint: 3, Option.NumMonitor: "on"},
                     "gesv", "growth", None, {}),
    "reject": ("reject_unresumable", {Option.Checkpoint: 3}, "posv", "spd",
               ("kill", "potrf", 1), {}),
}


@pytest.mark.parametrize("case", list(LADDER))
def test_request_trace_degradation_ladder_matches_jax(rng, case):
    """Every ladder path ends its trace with exactly one outcome, the same
    phase sequence (names, parents, depths, metadata), notes, class, bin
    and batch in both packages; the port's phases nest, served requests
    land in the tagged latency histogram, ladder flows validate."""
    from slate_tpu_torch.obs import perfetto
    from slate_tpu_torch.obs.metrics import REGISTRY

    want, opts, op, kind, fargs, fkw = LADDER[case]
    a, b = operands(rng, kind)
    recs = {}
    for s in both({Option.NumMonitor: "off", **opts}):
        with s.on(True):
            before = len(s.traces.finished_traces())
            plan = s.plan(fargs[0], *fargs[1:], **fkw) if fargs else None
            if want.startswith("reject"):
                with pytest.raises(s.err, match="unresumable"):
                    s.solve(op, a, b, plan)
            else:
                s.solve(op, a, b, plan)
            got = s.traces.finished_traces()[before:]
        assert len(got) == 1 and got[0].outcome == want
        recs[s.name] = (phase_record(got[0]), got[0])
    assert recs["jax"][0] == recs["torch"][0]
    tr = recs["torch"][1]
    with pytest.raises(RuntimeError, match="already terminal"):
        tr.finish("served")
    for ph in tr.phases:
        assert ph["t1"] >= ph["t0"] >= tr.t0
        if ph["parent"] is not None:
            assert any(p["name"] == ph["parent"] and p["t0"] <= ph["t0"] and p["t1"] >= ph["t1"]
                       for p in tr.phases if p is not ph)
    names = [ph["name"] for ph in tr.phases]
    assert "admission" in names
    if want.startswith("served"):
        assert "factor" in names and "solve" in names
        hist = [h for h in REGISTRY.histogram_series("serve.latency_s")
                if h["tags"] == {"op": tr.op, "klass": tr.klass or "friendly", "outcome": want}]
        assert hist and hist[-1]["count"] >= 1
    if want in ("served_retry", "served_resume", "served_growth_retry"):
        evs = perfetto.request_trace_events([tr])
        assert perfetto.validate_chrome_trace({"traceEvents": evs}) == []
        starts = [e for e in evs if e.get("ph") == "s"]
        assert starts and len(starts) == len([e for e in evs if e.get("ph") == "f"])


def _gels_operands(rng, m=N, n=40):
    return rng.standard_normal((m, n)), rng.standard_normal((m, 2))


@pytest.mark.parametrize("monitor", ["off", "on"])
def test_gels_tier_matches_jax(rng, monitor):
    """The CAQR gels tier in both packages: x within 1e-9 of slate_tpu's
    and of the library's least-squares solution, equal counters, no
    orthogonality retry on a well-conditioned operand."""
    a, b = _gels_operands(rng)
    clear_admission_memos()
    sides = both({Option.NumMonitor: monitor})
    xs = {}
    with counter_deltas() as d:
        for s in sides:
            xs[s.name] = np.asarray(s.router.gels(s.conv(a), s.conv(b)))
    assert d["jax"] == d["torch"] and "retries" not in d["torch"]
    ref = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(xs["torch"], ref, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(xs["torch"], xs["jax"], rtol=1e-9, atol=1e-11)
    x1 = Side("torch", {}).router.gels(t(a), t(b[:, 0]))
    assert tuple(x1.shape) == (40,)


def test_gels_orth_retry_serves_with_obs_on(rng, monkeypatch):
    """A monitored factor past ORTH_THRESHOLD takes the one
    re-orthogonalization retry (serve.retries +1) and is served, traced as
    "served" with the orth_retry note.  (slate_tpu's trace refuses the
    orth_retry note, so with obs on its request ends failed_error; the port
    does not reproduce that.)"""
    from slate_tpu_torch.obs import numerics

    a, b = _gels_operands(rng)
    s = Side("torch", {Option.NumMonitor: "on"})
    monkeypatch.setattr(numerics, "orth_exceeded", lambda op: True)
    from slate_tpu_torch.obs.metrics import serve_counts

    r0 = serve_counts()["retries"]
    with obs.force_enabled(True):
        before = len(rtrace.finished_traces())
        x = s.router.gels(t(a), t(b)).numpy()
        tr = rtrace.finished_traces()[before:]
    assert serve_counts()["retries"] == r0 + 1
    assert [x_.outcome for x_ in tr] == ["served"] and tr[0].notes == ["orth_retry"]
    np.testing.assert_allclose(x, np.linalg.lstsq(a, b, rcond=None)[0], rtol=1e-8, atol=1e-10)


def test_gels_requires_a_mesh(rng):
    a, b = _gels_operands(rng)
    with pytest.raises(SlateError, match="requires a mesh"):
        Router(bins=(N,), hbm_budget=1 << 30, device="cpu").gels(t(a), t(b))


def test_mesh_router_unarmed_takes_the_stacked_path(rng):
    """A mesh router without a resilience policy serves through the stacked
    single-device programs (as slate_tpu's), with equal counters."""
    a, b = operands(rng)
    clear_admission_memos()
    sides = both({})
    xs = {}
    with counter_deltas() as d:
        for s in sides:
            xs[s.name] = s.solve("posv", a, b)
    assert d["jax"] == d["torch"] and d["torch"]["batches"] == 1
    np.testing.assert_allclose(xs["torch"], xs["jax"], rtol=1e-10, atol=1e-12)


def test_condest_memo_on_factor_counts_like_jax(rng):
    """tests/test_serve.py's factor memo: a repeat pocondest_dist hits once,
    another probe configuration misses, in both packages."""
    from slate_tpu.parallel.dist import from_dense as jfrom_dense
    from slate_tpu.parallel.dist_aux import norm_dist as jnorm_dist
    from slate_tpu.parallel.dist_aux import pocondest_dist as jpocondest
    from slate_tpu.parallel.dist_chol import potrf_dist as jpotrf_dist
    from slate_tpu.types import Norm as JNorm
    from slate_tpu_torch.parallel import from_dense, norm_dist, pocondest_dist, potrf_dist
    from slate_tpu_torch.types import Norm

    a = spd_np(rng, N)
    jm, tm = jmesh24(), tmesh24()
    jl, jinfo = jpotrf_dist(jfrom_dense(j(a), jm, 8, diag_pad_one=True))
    tl, tinfo = potrf_dist(from_dense(t(a), tm, 8, diag_pad_one=True))
    assert int(jinfo) == int(tinfo) == 0
    janorm = jnorm_dist(JNorm.One, jfrom_dense(j(a), jm, 8))
    tanorm = norm_dist(Norm.One, from_dense(t(a), tm, 8))
    with counter_deltas() as d:
        r = [float(jpocondest(jl, janorm)), float(jpocondest(jl, janorm))]
        q = [float(pocondest_dist(tl, tanorm)), float(pocondest_dist(tl, tanorm))]
        float(jpocondest(jl, janorm, iters=3))
        float(pocondest_dist(tl, tanorm, iters=3))
    assert d["jax"] == d["torch"] == {"condest_cache_hits": 1}
    assert q[0] == q[1] and r[0] == r[1]
    np.testing.assert_allclose(q[0], r[0], rtol=1e-10)
