"""The port's executable cache, tuned table, tenant budgets and serve.*
report section against slate_tpu's serve/{cache,table,budget,metrics}.py.

Held exactly: the ``serve.*`` counter deltas of the same cache traffic
(the port's ``traces`` counts builds, slate_tpu's jit traces: one per key
on the same stream), the ``CacheKey`` fields (the platform pinned to
``cpu``), every ``lookup`` / ``resolve_request_options`` result on the
committed table and on pinned tables, the ledger's arithmetic, and the
RunReport section's keys.
"""

import gc

import jax
import jax.numpy as jnp
import pytest
import torch

from torch_serve_common import COUNTERS, counter_deltas, j, jmesh24, spd_stack_np, t, tmesh24

from slate_tpu.parallel.comm import use_bcast_impl as juse_bcast_impl
from slate_tpu.serve import budget as jbudget
from slate_tpu.serve import cache as jcache
from slate_tpu.serve import table as jtable
from slate_tpu.serve.batch import posv_batched as jposv_batched
from slate_tpu_torch.obs import report
from slate_tpu_torch.parallel.comm import BCAST_IMPL_ENV, use_bcast_impl
from slate_tpu_torch.serve import budget, cache, metrics, table
from slate_tpu_torch.serve.batch import posv_batched
from slate_tpu_torch.serve.cache import ExecutableCache, make_key
from slate_tpu_torch.types import MethodGemm, Option

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for env in (BCAST_IMPL_ENV, table.AUTOTUNE_ENV, table.TUNED_ENV):
        monkeypatch.delenv(env, raising=False)


def _table(entries):
    return {"schema": table.TUNED_SCHEMA, "version": table.TUNED_VERSION, "entries": entries}


def jopts(opts):
    """The same options under slate_tpu's Option enum."""
    from slate_tpu.types import Option as JOption

    if opts is None:
        return None
    return {JOption(k.value) if isinstance(k, Option) else k: v for k, v in opts.items()}


def plain(opts):
    """Options as {value name: value} for comparing the two packages."""
    return {str(getattr(k, "value", k)): getattr(v, "value", v) for k, v in opts.items()}


def test_cache_steady_state_counters_match_jax(rng):
    """tests/test_serve.py's steady-state walk in both packages: a warm-up,
    four hits on fresh data, a new shape's one build; equal deltas (4 hits,
    2 misses, 2 traces, 1 warmup); a rebuild past steady state trips
    assert_steady."""
    jc, tc = jcache.ExecutableCache(), ExecutableCache()
    B, n = 2, 16
    spd = spd_stack_np(rng, B, n)
    b = rng.standard_normal((B, n, 1))
    with counter_deltas() as d:
        kj = jcache.make_key("posv_batched", (j(spd), j(b)), batch=B)
        kt = make_key("posv_batched", (t(spd), t(b)), batch=B)
        jc.warmup(kj, lambda: jposv_batched, (j(spd), j(b)))
        tc.warmup(kt, lambda: posv_batched, (t(spd), t(b)))
        assert jc.trace_count(kj) == tc.trace_count(kt) == 1
        snaps = jc.snapshot_traces(), tc.snapshot_traces()
        for _ in range(4):
            spd2 = spd_stack_np(rng, B, n)
            b2 = rng.standard_normal((B, n, 1))
            assert make_key("posv_batched", (t(spd2), t(b2)), batch=B) == kt
            jax.block_until_ready(jc.get_or_build(kj, lambda: jposv_batched)(j(spd2), j(b2))[0])
            tc.get_or_build(kt, lambda: posv_batched)(t(spd2), t(b2))
        b3 = rng.standard_normal((B, n, 3))
        kj3 = jcache.make_key("posv_batched", (j(spd), j(b3)), batch=B)
        kt3 = make_key("posv_batched", (t(spd), t(b3)), batch=B)
        assert kt3 != kt
        jax.block_until_ready(jc.get_or_build(kj3, lambda: jposv_batched)(j(spd), j(b3))[0])
        tc.get_or_build(kt3, lambda: posv_batched)(t(spd), t(b3))
    assert d["jax"] == d["torch"]
    assert d["torch"] == {"cache_hits": 4, "cache_misses": 2, "traces": 2, "warmups": 1}
    assert tc.trace_count(kt) == 1 and tc.trace_count(kt3) == 1 and tc.total_traces() == 2
    tc.assert_steady(snaps[1])
    tc._trace_counts[kt] += 1
    with pytest.raises(AssertionError, match="retraced"):
        tc.assert_steady(snaps[1])


def test_cache_pin_and_clear(rng):
    tc = ExecutableCache()
    spd = t(spd_stack_np(rng, 1, 8))
    b = t(rng.standard_normal((1, 8, 1)))
    k1 = make_key("posv_batched", (spd, b))
    k2 = make_key("gesv_friendly", (spd, b))
    tc.get_or_build(k1, lambda: posv_batched)
    tc.get_or_build(k2, lambda: posv_batched)
    tc.pin(k1)
    assert tc.contains(k1) and tc.contains(k2) and len(tc) == 2
    tc.clear_unpinned()
    assert tc.contains(k1) and not tc.contains(k2) and tc.trace_count(k2) == 0
    tc.clear()
    assert len(tc) == 0 and tc.total_traces() == 0


@pytest.mark.parametrize("dtype", ["float64", "float32", "complex128"])
@pytest.mark.parametrize("opts", [None, {Option.BcastImpl: "ring", Option.Lookahead: 2},
                                  {"block_size": 16, Option.MethodGemm: MethodGemm.GemmC}])
def test_cache_key_fields_match_jax(rng, dtype, opts):
    """Same operands, same options: the same CacheKey fields, with the dtype
    in slate_tpu's names and the platform pinned to cpu."""
    a = rng.standard_normal((2, 8, 8)).astype(dtype)
    b = rng.standard_normal((2, 8, 3)).astype(dtype)
    kj = jcache.make_key("posv", (jnp.asarray(a), jnp.asarray(b)), batch=2, mesh=jmesh24(),
                         opts=opts)
    kt = make_key("posv", (t(a), t(b)), batch=2, mesh=tmesh24(), opts=opts)
    assert tuple(kt) == tuple(kj)
    assert kt.dtype == dtype and kt.mesh == "cpu:2x4"
    assert cache.mesh_signature(None) == jcache.mesh_signature(None) == "none"
    assert cache.options_signature(opts) == jcache.options_signature(opts)


def test_committed_tuned_table_valid():
    doc = table.load_tuned_table()
    assert doc is not None, "artifacts/serve/tuned.json missing or invalid"
    assert table.validate_table(doc) == [] and doc["entries"]
    assert doc == jtable.load_tuned_table()
    assert table.DEFAULT_TABLE_PATH == jtable.DEFAULT_TABLE_PATH
    assert table.TORCH_TABLE_PATH != table.DEFAULT_TABLE_PATH


LOOKUPS = [("potrf", 96), ("potrf", 128), ("potrf", 48), ("potrf", 47), ("potrf", 193),
           ("posv", 64), ("gesv", 96), ("gemm", 100), ("gemm", 4096), ("heev", 96)]


@pytest.mark.parametrize("op,n", LOOKUPS)
def test_committed_table_resolutions_match_jax(op, n):
    """lookup and resolve_request_options on the committed table: the same
    entries and the same merged options in both packages, with equal
    tuned_resolutions deltas."""
    grid = (2, 4)
    assert table.lookup(op, n, "float64", grid) == jtable.lookup(op, n, "float64", grid)
    for opts in (None, {Option.Lookahead: 0}, {Option.AutoTune: "off"}):
        with counter_deltas() as d:
            got = table.resolve_request_options(opts, op, n, "float64", grid)
            want = jtable.resolve_request_options(jopts(opts), op, n, "float64", grid)
        assert d["jax"] == d["torch"]
        assert plain(got) == plain(want)


def test_torch_dtype_name_finds_the_table_entry(rng):
    """A torch f64 request keys the table by slate_tpu's dtype name: its
    make_key dtype is "float64" and the tuned tier resolves its options;
    the torch spelling would find nothing."""
    a = t(rng.standard_normal((96, 96)))
    name = cache.dtype_name(a)
    assert name == "float64" == cache.dtype_name(torch.float64)
    assert table.lookup("posv", 96, name, (2, 4)) is not None
    assert table.lookup("posv", 96, str(a.dtype), (2, 4)) is None
    merged = table.resolve_request_options(None, "posv", 96, name, (2, 4))
    assert merged[Option.BlockSize] == 16 and merged[Option.Lookahead] == 0


def test_tuned_table_resolution_precedence(monkeypatch):
    """explicit > context > env > tuned > auto, in both packages."""
    tbl = _table({"potrf|n=96|dtype=float64|grid=2x4":
                  {"bcast_impl": "ring", "lookahead": 2, "nb": 16}})
    cases = []
    with table.use_tuned_table(tbl), jtable.use_tuned_table(tbl):
        def both(opts, n=96):
            got = table.resolve_request_options(opts, "potrf", n, "float64", (2, 4))
            want = jtable.resolve_request_options(jopts(opts), "potrf", n, "float64", (2, 4))
            assert plain(got) == plain(want)
            cases.append(got)
            return got

        got = both(None)
        assert got[Option.BcastImpl] == "ring" and got[Option.Lookahead] == 2
        assert got[Option.BlockSize] == 16
        assert both(None, 128)[Option.BcastImpl] == "ring"
        got = both({Option.BcastImpl: "psum", Option.Lookahead: 0})
        assert got[Option.BcastImpl] == "psum" and got[Option.Lookahead] == 0
        with use_bcast_impl("doubling"), juse_bcast_impl("doubling"):
            assert Option.BcastImpl not in both(None)
        monkeypatch.setenv(BCAST_IMPL_ENV, "psum")
        assert Option.BcastImpl not in both(None)
        monkeypatch.delenv(BCAST_IMPL_ENV)
        got = both({Option.AutoTune: "off"})
        assert Option.BcastImpl not in got and Option.Lookahead not in got
        monkeypatch.setenv(table.AUTOTUNE_ENV, "0")
        assert Option.BcastImpl not in both(None)
    monkeypatch.delenv(table.AUTOTUNE_ENV)
    with table.use_tuned_table(None):
        assert table.resolve_request_options({"lookahead": 3}, "potrf", 96, "float64",
                                             (2, 4)) == {"lookahead": 3}
    with pytest.raises(ValueError, match="invalid tuned table"):
        with table.use_tuned_table({"schema": "nope"}):
            pass


@pytest.mark.parametrize("doc", [[], {"schema": "x", "version": 1, "entries": {}},
                                 {"schema": "slate_tpu.serve.tuned_table", "version": "1",
                                  "entries": {}},
                                 {"schema": "slate_tpu.serve.tuned_table", "version": 1,
                                  "entries": {"k": {"nb": "16"}}},
                                 {"schema": "slate_tpu.serve.tuned_table", "version": 1,
                                  "entries": {"k": {"lookahead": 1, "bcast_impl": "ring"}}}])
def test_validate_table_matches_jax(doc):
    assert table.validate_table(doc) == jtable.validate_table(doc)


def test_write_table_and_env_path(tmp_path, monkeypatch):
    """write_table's document loads back through $SLATE_TPU_SERVE_TUNED and
    validates in both packages."""
    path = str(tmp_path / "tuned_torch.json")
    entries = {"posv|n=64|dtype=float64|grid=2x4": {"bcast_impl": "psum", "lookahead": 1,
                                                     "nb": 8}}
    table.write_table(path, entries, config={"n": 64})
    monkeypatch.setenv(table.TUNED_ENV, path)
    table.clear_table_cache()
    doc = table.load_tuned_table()
    assert doc["entries"] == entries and doc["env"]["platform"] in ("cpu", "cuda")
    assert jtable.validate_table(doc) == []
    table.clear_table_cache()


@pytest.mark.parametrize("m,itemsize", [(64, 8), (4096, 8), (512, 4)])
def test_request_cost_and_ledger_match_jax(m, itemsize):
    assert budget.request_cost(m, itemsize) == jbudget.request_cost(m, itemsize)
    cost = budget.request_cost(m, itemsize)
    kw = dict(budgets={"a": 3 * cost}, weights={"a": 2.0}, default_budget=cost)
    tl, jl = budget.BudgetLedger(**kw), jbudget.BudgetLedger(**kw)
    for tenant in ("a", "a", "b", "a", "b", "a"):
        assert tl.try_reserve(tenant, cost) == jl.try_reserve(tenant, cost)
    tl.release("a", cost)
    jl.release("a", cost)
    assert tl.snapshot() == jl.snapshot()
    assert tl.weight("a") == 2.0 and tl.headroom("b") == 0
    with pytest.raises(ValueError, match="must be > 0"):
        budget.BudgetLedger(weights={"x": 0.0}, default_budget=1)


def test_ledger_default_budget_is_the_cards(monkeypatch):
    monkeypatch.setenv("SLATE_TPU_HBM_BYTES", str(10 << 30))
    from slate_tpu_torch.obs import memmodel

    assert budget.BudgetLedger().headroom("t") == int((10 << 30) * memmodel.HBM_SAFETY)


def test_serve_report_section():
    """The serve section carries slate_tpu's counter names, gates the cache
    misses as lower-is-better, and a fresh run boundary zeroes it."""
    from slate_tpu_torch import obs

    metrics.serve_count("requests")
    rep = report.make_report("serve_section_test")
    assert report.validate_report(rep) == []
    assert set(COUNTERS) <= set(rep["serve"]) and rep["serve"]["requests"] >= 1
    vals = report.load_values(rep)
    assert vals.get("serve_requests", 0) >= 1
    old, new = dict(vals), dict(vals)
    new["serve_cache_misses"] = old.get("serve_cache_misses", 0) * 4 + 8
    old["serve_cache_misses"] = old.get("serve_cache_misses", 0) + 1
    failures, _ = report.check_regression(new, old, threshold=1.5)
    assert any("serve_cache_misses" in f for f in failures)
    with pytest.raises(KeyError, match="unknown serve counter"):
        metrics.serve_count("no_such_counter")
    obs.reset()
    assert not any(metrics.serve_counts().values())


def test_counters_reach_the_registry_when_obs_is_on():
    from slate_tpu_torch import obs
    from slate_tpu_torch.obs import REGISTRY

    obs.reset()
    with obs.force_enabled(False):
        metrics.serve_count("batches")
    assert REGISTRY.counter_value("serve.batches") == 0
    with obs.force_enabled(True):
        metrics.serve_count("batches", 2)
    assert REGISTRY.counter_value("serve.batches") == 2
    assert metrics.serve_counts()["batches"] == 3
    obs.reset()


@pytest.mark.parametrize("name", ["float64", "gesv_hostile", "a.b-c d", "torch.float64"])
def test_sanitize_key_matches_jax(name):
    from slate_tpu.serve.metrics import _sanitize_key as jsan

    assert metrics._sanitize_key(name) == jsan(name)
