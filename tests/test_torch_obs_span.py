"""The port's observability core against ``slate_tpu``'s: the metrics
registry, spans and ``instrument``.

- the registry: the same sequence of counter / gauge / histogram calls
  gives the same snapshot, ``flatten_snapshot`` and quantiles;
- spans nest with their parents, absorb the comm audit per call, and the
  span tree of ``posv_mesh`` (its factor and two ``trsm_dist`` spans) and
  of a ``gemm_summa`` beside it is ``slate_tpu``'s, bytes included, on a
  shape no other test traces (n = 40, nb = 5);
- a disabled ``instrument`` returns the undecorated result and records
  nothing; ``measure`` counts one call's bytes and reports no flops;
- span names reach ``torch.profiler`` (``record_function``);
- every ``@instrument`` name of ``slate_tpu`` whose function the port has
  is an ``@instrument`` name of the port's counterpart (an AST check).
"""

import ast
import os

import jax
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import obs as jobs
from slate_tpu.obs import metrics as jmetrics
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import gemm_summa as jgemm_summa
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import posv_mesh as jposv_mesh
from slate_tpu_torch import obs as tobs
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import metrics as tmetrics
from slate_tpu_torch.obs import span as tspan
from slate_tpu_torch.parallel import comm as tcomm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def obs_off(monkeypatch):
    monkeypatch.delenv("SLATE_TPU_OBS", raising=False)
    tobs.disable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _feed(reg, rng):
    for i in range(700):  # past the 512-sample reservoir
        reg.observe("lat", float(rng.standard_normal()), op="gemm")
        reg.observe("lat", float(i % 7), op="potrf", tenant="a")
    reg.observe("one", 3.5)
    reg.counter_add("c", 2, span="x")
    reg.counter_add("c", 0.5, span="x")
    reg.counter_add("c", 1)
    reg.gauge_set("g", 4.0, span="y")
    reg.gauge_set("g", -1.0, span="y")


def test_registry_snapshot_flatten_and_quantiles_match():
    jreg, treg = jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()
    _feed(jreg, np.random.default_rng(3))
    _feed(treg, np.random.default_rng(3))
    assert treg.snapshot() == jreg.snapshot()
    assert tmetrics.flatten_snapshot(treg.snapshot()) == jmetrics.flatten_snapshot(jreg.snapshot())
    for q in (0.0, 0.25, 0.5, 0.95, 1.0):
        assert treg.quantile("lat", q, op="gemm") == jreg.quantile("lat", q, op="gemm")
        assert treg.quantile("lat", q, op="potrf", tenant="a") == jreg.quantile(
            "lat", q, op="potrf", tenant="a")
    assert treg.quantile("none", 0.5) is None and jreg.quantile("none", 0.5) is None
    assert treg.histogram_series("lat") == jreg.histogram_series("lat")
    samples = [3.0, 1.0, 2.0, 10.0]
    for q in (0.0, 0.3, 0.5, 1.0):
        assert tmetrics.quantile_of(samples, q, 1.5, 9.0) == jmetrics.quantile_of(samples, q, 1.5, 9.0)
    assert tmetrics.quantile_of([], 0.5) is None
    with pytest.raises(ValueError):
        tmetrics.quantile_of(samples, 1.5)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_spans_nest_and_set_metrics():
    tobs.enable()
    with tobs.driver_span("outer", n=3) as o:
        with o.phase("p1") as p:
            with tobs.driver_span("inner"):
                pass
            assert tobs.current_span() is p
        o.set("x", 2.0)
    recs = {s["name"]: s for s in tobs.FINISHED}
    assert [s["name"] for s in tobs.FINISHED] == ["inner", "outer:p1", "outer"]
    assert recs["inner"]["parent"] == "outer:p1" and recs["inner"]["depth"] == 2
    assert recs["outer:p1"]["parent"] == "outer" and recs["outer"]["parent"] is None
    assert recs["outer"]["tags"] == {"n": "3"}
    assert recs["outer"]["metrics"]["x"] == 2.0 and "p1_seconds" in recs["outer"]["metrics"]
    assert tobs.REGISTRY.counter_value("span_count", span="inner") == 1
    assert tobs.REGISTRY.gauge_value("x", span="outer") == 2.0
    with tobs.use_context(tobs.TraceContext("abc", tenant="t1")):
        with tobs.driver_span("ctx"):
            pass
    assert tobs.FINISHED[-1]["tags"] == {"trace_id": "abc", "tenant": "t1"}


def test_disabled_instrument_is_a_passthrough():
    calls = []

    def fn(a, b=1):
        calls.append((a, b))
        return a + b

    wrapped = tobs.instrument("thing")(fn)
    assert wrapped.__wrapped__ is fn and wrapped.__name__ == "fn"
    assert wrapped(2, b=3) == 5 and calls == [(2, 3)]
    assert tobs.FINISHED == [] and tobs.REGISTRY.snapshot() == {
        "counters": [], "gauges": [], "histograms": []}
    with tobs.driver_span("off") as sp:
        assert sp is tspan._NULL
    assert tobs.FINISHED == []
    tobs.enable()
    assert wrapped(torch.zeros(2, 3)).shape == (2, 3)
    assert tobs.FINISHED[-1]["name"] == "thing" and tobs.FINISHED[-1]["tags"] == {"shape": "2x3"}


def _ops(n, nb, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, n))
    a = (g @ g.T / n + 2 * np.eye(n)).astype(np.float32)
    b = rng.standard_normal((n, 4)).astype(np.float32)
    return a, b


def _tree(finished):
    return [(s["name"], s["parent"], s["depth"], s["metrics"]["comm_bytes"]) for s in finished]


def test_posv_mesh_span_tree_matches_slate_tpu():
    n, nb = 40, 5
    a, b = _ops(n, nb)
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    jobs.reset()
    with jobs.force_enabled():
        jposv_mesh(jax.numpy.asarray(a), jax.numpy.asarray(b), jm, nb)
        jad = jfrom_dense(jax.numpy.asarray(a), jm, nb)
        jgemm_summa(1.0, jad, jfrom_dense(jax.numpy.asarray(b), jm, nb))
    jtree = _tree(jobs.FINISHED)
    jobs.reset()
    tm = tp.make_mesh(2, 4, device="cpu")
    tobs.enable()
    tp.posv_mesh(torch.from_numpy(a), torch.from_numpy(b), tm, nb)
    tad = tp.from_dense(torch.from_numpy(a), tm, nb)
    tp.gemm_summa(1.0, tad, tp.from_dense(torch.from_numpy(b), tm, nb))
    assert _tree(tobs.FINISHED) == jtree
    assert [s[0] for s in jtree] == ["potrf_dist", "potrf_mesh", "trsm_dist", "trsm_dist",
                                     "posv_mesh", "gemm_summa"]


def test_span_comm_bytes_are_the_calls_audit():
    n, nb = 48, 6
    a, b = _ops(n, nb, seed=1)
    tm = tp.make_mesh(2, 4, device="cpu")
    ad = tp.from_dense(torch.from_numpy(a), tm, nb, diag_pad_one=True)
    with tcomm.comm_audit() as recs:
        tp.potrf_dist(ad)
    audited = sum(nbytes * mult for _, nbytes, mult in recs)
    tobs.enable()
    for _ in range(2):  # every call records (no trace cache)
        tp.potrf_dist(ad)
    assert [s["metrics"]["comm_bytes"] for s in tobs.FINISHED] == [audited, audited]
    by_op = {}
    for op, nbytes, mult in recs:
        by_op[op.split("[")[0]] = by_op.get(op.split("[")[0], 0.0) + nbytes * mult
    for op, v in by_op.items():
        assert tobs.REGISTRY.counter_value("comm_bytes", span="potrf_dist", op=op) == 2 * v
    assert tobs.FINISHED[0]["hops"] and all(h["step"] is not None for h in tobs.FINISHED[0]["hops"])


def test_measure_counts_one_call():
    n, nb = 48, 6
    a, _ = _ops(n, nb, seed=2)
    tm = tp.make_mesh(2, 4, device="cpu")
    ad = tp.from_dense(torch.from_numpy(a), tm, nb, diag_pad_one=True)
    with tcomm.comm_audit() as recs:
        tp.potrf_dist(ad)
    one = sum(nbytes * mult for _, nbytes, mult in recs)
    (l, info), m = tobs.measure("dist_chol", tp.potrf_dist, ad)
    assert int(info) == 0 and not tobs.enabled()
    assert m["comm_bytes"] == one and "flops" not in m
    assert m["compile_seconds"] >= 0 and m["execute_seconds"] > 0
    names = [(s["name"], s["parent"]) for s in tobs.FINISHED]
    assert names == [("potrf_dist", "dist_chol:cold"), ("dist_chol:cold", "dist_chol"),
                     ("potrf_dist", "dist_chol:execute"), ("dist_chol:execute", "dist_chol"),
                     ("dist_chol", None)]
    cold = [s for s in tobs.FINISHED if s["name"] == "dist_chol:cold"][0]
    assert cold["metrics"]["comm_bytes"] == one


def test_span_names_reach_the_torch_profiler():
    tobs.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.driver_span("obs_bridge_probe"):
            torch.ones(4) @ torch.ones(4)
    assert "obs_bridge_probe" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# the instrument sites
# ---------------------------------------------------------------------------


def _instrument_sites(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for f in names:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if rel.startswith("obs" + os.sep):
                continue
            tree = ast.parse(open(path).read(), path)
            for node in tree.body:
                if not isinstance(node, ast.FunctionDef):
                    continue
                names_ = [d.args[0].value for d in node.decorator_list
                          if isinstance(d, ast.Call) and getattr(d.func, "id", None) == "instrument"]
                out[(rel, node.name)] = names_[0] if names_ else None
    return out


def test_every_ported_instrument_site_keeps_its_name():
    ref = _instrument_sites(os.path.join(REPO, "slate_tpu"))
    port = _instrument_sites(os.path.join(REPO, "slate_tpu_torch"))
    wanted = {k: v for k, v in ref.items() if v is not None and k in port}
    assert len(wanted) >= 71
    missing = {k: v for k, v in wanted.items() if port[k] != v}
    assert not missing, missing
