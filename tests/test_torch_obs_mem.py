"""The port's memory observability (slate_tpu_torch.obs.memory / memmodel /
memwatch, the span and flight memory samples, the OOM forensics, the
dryrun's mem phase), against slate_tpu where the two are the same
arithmetic (the f64 potrf routes: tests/test_torch_chol_f64_routes.py).

Held against slate_tpu bitwise: MemoryModel's exact terms (the tile-stack
shards, the auxiliary outputs, the lookahead payloads, the bucketed
views) over ops, sizes, grids, depths, lowerings, FT and dtypes; the
f64 residency models and ``potrf_f64_form``'s decision table; the
mixed-ladder residency; the memory counter events' trace validity.

Within the port: the traced call is deterministic at a fixed shape and
reproduces the recorded fit points exactly; the model's virtual-mesh
workspace within 10% of the traced temp at two points off the fit set per
BcastImpl for every modelled op; no memory scan or stats call with obs
off; one OOM report per failure (a monkeypatched raise of
``torch.cuda.OutOfMemoryError``, nested drivers); ``memwatch --smoke``
and the dryrun's mem phase on the CPU.  No test reads XLA's
memory_analysis (slate_tpu's own test_mem.py is red on this host).
"""

import importlib
import itertools
import json

import numpy as np
import pytest
import torch

from slate_tpu.obs import memmodel as jmm
from slate_tpu.obs import perfetto as jperfetto
from slate_tpu_torch import obs
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import flight, memmodel, memory, memwatch, perfetto, report
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dryrun as tdry

jcomm = importlib.import_module("slate_tpu.parallel.comm")

torch.set_num_threads(1)

EXACT = ("nt", "mt", "mtl", "ntl", "kt", "depth", "tile_bytes", "stack_bytes", "panel_col_bytes",
         "panel_row_bytes", "arg_bytes", "aux_out_bytes", "out_bytes", "live_payloads",
         "payload_bytes")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in ("SLATE_TPU_OBS", memmodel.HBM_ENV, memory.SAMPLE_ENV, "SLATE_TPU_PANEL_IMPL",
                "SLATE_TPU_UPDATE_IMPL", "SLATE_TPU_BCAST_IMPL"):
        monkeypatch.delenv(env, raising=False)
    obs.reset()
    yield
    obs.disable()
    obs.reset()


# ---------------------------------------------------------------------------
# the model against slate_tpu's
# ---------------------------------------------------------------------------


def test_memory_model_exact_terms_match_jax():
    assert all(tcomm.la_live_buffers(d, f) == jcomm.la_live_buffers(d, f)
               for d in range(4) for f in (False, True))
    grid_cases = [(2, 4), (4, 2), (1, 8), (3, 2)]
    for op, (n, nb), grid, depth, impl, ft, dtype in itertools.product(
            memmodel.MODEL_OPS, [(96, 8), (1000, 64), (16384, 256)], grid_cases, (0, 1, 2),
            ("psum", "ring"), (False, True), ("float32", "float64")):
        tm = memmodel.MemoryModel(op, n, nb, grid, dtype, depth, impl, ft)
        jm = jmm.MemoryModel(op, n, nb, grid, dtype, depth, impl, ft)
        for attr in EXACT:
            assert getattr(tm, attr) == getattr(jm, attr), (op, n, nb, grid, depth, attr)
        assert tm._bucket_view_bytes() == jm._bucket_view_bytes()
    assert memmodel.MODEL_OPS == jmm.MODEL_OPS
    with pytest.raises(ValueError, match="unknown model op"):
        memmodel.MemoryModel("gemm", 96, 8, (2, 4))


def test_potrf_f64_form_decision_table_matches_jax():
    for n, concrete, ozaki, budget, isz in itertools.product(
            (4096, 8192, 12288, 16384, 32768, 49152), (True, False), (True, False),
            (int(0.5e9), int(15.75 * 2 ** 30), int(80e9), int(200e9)), (8, 16)):
        assert memmodel.potrf_f64_form(n, concrete, ozaki, budget, isz) == \
            jmm.potrf_f64_form(n, concrete, ozaki, budget, isz), (n, concrete, ozaki, budget, isz)
    for n in (4096, 16384, 32768):
        for fn in ("potrf_fused_ll_peak", "potrf_staged_peak", "potrf_ozaki_cache_peak"):
            assert getattr(memmodel, fn)(n) == getattr(jmm, fn)(n)
        assert memmodel.potrf_fused_fits(n, int(80e9)) == jmm.potrf_fused_fits(n, int(80e9))
    for b in (int(1e9), int(15.75 * 2 ** 30), int(80e9)):
        assert memmodel.potrf_ozaki_cache_max_n(b) == jmm.potrf_ozaki_cache_max_n(b)
    for n, nb, grid, nrhs in ((4096, 256, (2, 4), 1), (96, 8, (2, 2), 20), (16384, 256, (4, 2), 32)):
        assert memmodel.mixed_ladder_residency(n, nb, grid, nrhs) == \
            jmm.mixed_ladder_residency(n, nb, grid, nrhs)


def test_hbm_budget_and_predict_max_n(monkeypatch):
    """The budget: the env override, else the card's memory; a CPU device
    has none of its own (no TPU size stands in for it).  predict_max_n
    keeps slate_tpu's rule on the port's per-device peak: the largest
    tile-grid multiple that fits."""
    monkeypatch.setenv(memmodel.HBM_ENV, "12345678")
    assert memmodel.hbm_budget() == 12345678 == jmm.hbm_budget()
    monkeypatch.delenv(memmodel.HBM_ENV)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match=memmodel.HBM_ENV):
            memmodel.hbm_budget("cpu")
    assert not hasattr(memmodel, "V5E_HBM_BYTES")
    budget = 2 ** 30
    n = memmodel.predict_max_n(budget, "potrf", 256, (2, 4))
    step = 256 * 4
    peak = lambda m: memmodel.MemoryModel("potrf", m, 256, (2, 4)).peak_bytes  # noqa: E731
    assert n % step == 0 and peak(n) <= budget < peak(n + step)


# ---------------------------------------------------------------------------
# the traced call and the fit
# ---------------------------------------------------------------------------


def _trace(op, n, nb, depth, impl):
    fn, args = memwatch.build_case(op, n, nb, tp.make_mesh(2, 4, device="cpu"), depth, impl)
    return memory.traced_memory(fn, *args)[0]


@pytest.mark.parametrize("op", memmodel.MODEL_OPS)
def test_traced_call_deterministic_and_the_fit_points_reproduce(op):
    first = _trace(op, 96, 8, 1, "ring")
    assert _trace(op, 96, 8, 1, "ring") == first
    assert first["peak_bytes"] == first["arg_bytes"] + first["out_bytes"] + first["temp_bytes"]
    m = memmodel.MemoryModel(op, 96, 8, (2, 4), lookahead=1)
    assert (first["arg_bytes"], first["out_bytes"]) == (m.virtual_arg_bytes, m.virtual_out_bytes)
    pts = memmodel._FIT_POINTS[op]
    for n, nb, d, temp in (pts[0], pts[2]):
        assert _trace(op, n, nb, d, "psum")["temp_bytes"] == temp, (op, n, nb, d)


@pytest.mark.parametrize("impl", ["psum", "ring", "doubling"])
def test_model_within_ten_percent_off_the_fit_set(impl):
    """Two (n, nb, depth) points per lowering that the fit never saw."""
    for op in memmodel.MODEL_OPS:
        for n, nb, depth in ((80, 8, 1), (112, 16, 2)):
            temp = _trace(op, n, nb, depth, impl)["temp_bytes"]
            ws = memmodel.MemoryModel(op, n, nb, (2, 4), lookahead=depth,
                                      bcast_impl=impl).virtual_workspace_bytes
            err = abs(ws - temp) / temp if temp else ws
            assert err <= memwatch.MODEL_TOL, (op, n, nb, depth, impl, ws, temp)


def test_traced_call_counts_a_wrapper_as_one_op():
    """A kernel wrapper is one op of the tally: its twin's temporaries on
    the CPU (the launch's on the card) stay out, its outputs count."""
    from slate_tpu_torch.ops import kernels

    d = torch.eye(8, dtype=torch.float64) * 4 + 1
    tiles = torch.randn(2, 1, 3, 8, 8, dtype=torch.float64)
    res, (l, solved) = memory.traced_memory(kernels.chol_panel_tiles, d, tiles)
    assert res["out_bytes"] == (l.numel() + solved.numel()) * 8 and res["temp_bytes"] == 0
    res, _ = memory.traced_memory(kernels.chol_panel_tiles_plain, d, tiles)
    assert res["temp_bytes"] > 0  # the twin called alone shows its own temporaries


# ---------------------------------------------------------------------------
# sampling, forensics, traces
# ---------------------------------------------------------------------------


def _spd(n=48):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((n, n))
    return torch.from_numpy(a @ a.T / n + 2 * np.eye(n))


def test_sampling_off_makes_no_scan_or_stats_call():
    mesh = tp.make_mesh(2, 4, device="cpu")
    live, stats = memory.LIVE_CALLS, memory.STATS_CALLS
    tp.posv_mesh(_spd(), torch.ones(48, 2, dtype=torch.float64), mesh, 8)
    flight.run_flight("potrf", n=32, nb=8, depth=1, mesh=mesh)
    assert (memory.LIVE_CALLS, memory.STATS_CALLS) == (live, stats)
    assert memory.mem_counter_values()["samples"] == 0
    obs.enable()
    tp.potrf_dist(tp.from_dense(_spd(), mesh, 8, diag_pad_one=True))
    assert memory.LIVE_CALLS == live + 1 and memory.STATS_CALLS == stats + 1
    top = obs.FINISHED[-1]
    assert top["depth"] == 0 and top["metrics"]["mem.live_bytes"] > 0
    assert report.make_report("x")["mem"]["samples"] == 1


class _FakeOOM(torch.cuda.OutOfMemoryError):
    pass


@pytest.mark.parametrize("enabled", [False, True])
def test_one_oom_report_per_failure(monkeypatch, capsys, enabled):
    """A raise of torch.cuda.OutOfMemoryError deep in potrf_dist, under
    posv_mesh > potrf_mesh > potrf_dist: one report (the innermost
    driver's, with the model's peaks), one mem.oom_events, the error
    propagated; a non-OOM error writes none."""
    from slate_tpu_torch.parallel import dist_chol

    def boom(*a, **k):
        raise _FakeOOM("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setattr(dist_chol, "_potrf_tiles", boom)
    obs.enable() if enabled else obs.disable()
    mesh = tp.make_mesh(2, 4, device="cpu")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tp.posv_mesh(_spd(), torch.ones(48, 1, dtype=torch.float64), mesh, 8,
                     opts={"mixed_precision": "off"})
    assert len(memory.OOM_REPORTS) == 1 and memory.mem_counter_values()["oom_events"] == 1
    text = memory.OOM_REPORTS[0]
    assert "OOM forensics: potrf_dist" in text and "model peak [potrf n=48 nb=8 2x4]" in text
    assert text in capsys.readouterr().err
    monkeypatch.setattr(dist_chol, "_potrf_tiles", lambda *a, **k: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        tp.potrf_dist(tp.from_dense(_spd(), mesh, 8, diag_pad_one=True))
    assert len(memory.OOM_REPORTS) == 1
    assert memory.is_oom(torch.cuda.OutOfMemoryError("x")) and not memory.is_oom(ValueError("x"))


def test_memory_counter_tracks_validate():
    """Span samples and a flight's samples render as Perfetto counter
    tracks that both packages' validators accept; the flight report keeps
    its samples."""
    mesh = tp.make_mesh(2, 4, device="cpu")
    obs.enable()
    tp.potrf_dist(tp.from_dense(_spd(), mesh, 8, diag_pad_one=True))
    tr = perfetto.chrome_trace()
    names = {e["name"] for e in tr["traceEvents"] if e.get("ph") == "C"}
    assert "mem.live_bytes" in names and any(n.startswith("mem.live_bytes[") for n in names)
    obs.disable()
    with memory.force_sampling():
        rep = flight.run_flight("potrf", n=32, nb=8, depth=1, mesh=mesh)
    assert rep["mem_samples"] and not flight.validate_flight_report(rep)
    assert {s["phase"] for s in rep["mem_samples"]} >= {"panel", "bcast"}
    ft = perfetto.flight_chrome_trace(rep["events"], rep["hop_events"], grid=(2, 4),
                                      mem_samples=rep["mem_samples"])
    for t in (json.loads(json.dumps(tr)), json.loads(json.dumps(ft))):
        assert perfetto.validate_chrome_trace(t) == [] == jperfetto.validate_chrome_trace(t)
    assert any(e.get("ph") == "C" and e["name"] == "mem.live_bytes" for e in ft["traceEvents"])
    evs = perfetto.memory_counter_events(memory.SAMPLES, 0.0)
    assert evs and all(e["ph"] == "C" for e in evs)


def test_memwatch_smoke_and_cli_on_the_cpu(tmp_path):
    assert memwatch.run_smoke(str(tmp_path), device="cpu") == []
    assert memwatch.main(["trsm", "--n", "64", "--device", "cpu", "--out",
                          str(tmp_path / "t.json")]) == 0
    rep = json.loads((tmp_path / "t.json").read_text())
    assert report.validate_report(rep) == [] and rep["mem"] == {}
    assert rep["values"]["mem.model_err_frac"] <= memwatch.MODEL_TOL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            memwatch.run_memwatch("potrf")


def test_dryrun_mem_phase():
    res = tdry.dryrun("cpu")
    mem = res["phases"]["mem"]
    assert set(mem) == {"temp_bytes", "arg_bytes", "model_workspace_bytes", "model_err_frac",
                        "peak_bytes_per_device", "seconds"}
    assert mem["temp_bytes"] == dict((p[:2], p[3]) for p in memmodel._FIT_POINTS["potrf"])[(64, 8)]
    assert mem["arg_bytes"] == 64 * 64 * 4 and mem["model_err_frac"] <= memwatch.MODEL_TOL
