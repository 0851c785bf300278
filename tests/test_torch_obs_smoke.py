"""The port's obs acceptance runs on the host.

- ``obs.smoke`` (an instrumented ``potrf_dist``, its RunReport, trace and
  ``--check``), ``obs.flight --smoke`` and ``obs.comm_audit`` with
  ``--device cpu``; without a card and no ``--device cpu`` they raise;
- the dryrun's ``flight_timeline`` beside ``slate_tpu``'s: both pass
  ``__graft_entry__.py``'s gates and model the same bytes, and each
  package's FlightReport passes the other's validator.  ``slate_tpu``'s
  ``run_flight`` calls ``jax.clear_caches()``: this file is the only one
  that calls it.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.obs import comm_audit as jcomm_audit
from slate_tpu.obs import flight as jflight
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu_torch import obs as tobs
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import comm_audit, flight
from slate_tpu_torch.obs import smoke as tsmoke
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dryrun as tdry

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def obs_off(monkeypatch):
    monkeypatch.delenv("SLATE_TPU_OBS", raising=False)
    monkeypatch.delenv(flight.DEEP_ENV, raising=False)
    yield
    tobs.disable()
    tobs.reset()


def test_obs_smoke_on_the_host(tmp_path):
    res = tsmoke.run_smoke(str(tmp_path), device="cpu")
    assert res["ok"], res["failures"]
    assert res["check_rc"] == [0, 1] and res["comm_bytes"] > 0 and res["spans"] == 6
    rep = json.loads(open(res["report"]).read())
    assert rep["values"]["execute_seconds"] > 0 and "flops" not in rep["values"]
    assert not tobs.enabled()
    with contextlib.redirect_stdout(io.StringIO()):
        assert tsmoke.main(["--device", "cpu", "--out", str(tmp_path / "cli"), "--n", "40",
                            "--nb", "5"]) == 0


def test_flight_smoke_and_cli_on_the_host(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert flight.main(["--smoke", "--device", "cpu", "--out", str(tmp_path)]) == 0
        assert flight.main(["summa", "--device", "cpu", "--n", "40", "--nb", "5", "--hops",
                            "--out", str(tmp_path / "s.json"), "--trace",
                            str(tmp_path / "s.trace.json")]) == 0
    assert "obs.flight smoke: OK" in out.getvalue()
    rep = json.loads((tmp_path / "s.json").read_text())
    assert flight.validate_flight_report(rep) == jflight.validate_flight_report(rep) == []
    assert (tmp_path / "flight_he2hb.trace.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="the no-card rule; a card is present")
def test_the_card_is_the_default():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flight.run_flight("potrf", n=16, nb=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsmoke.run_smoke(n=16, nb=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm_audit.run_audit(16, 4)


def test_comm_audit_on_the_host(tmp_path):
    rows, p, q = comm_audit.run_audit(32, 4, device="cpu")
    assert [r[0] for r in rows][:3] == ["gemm_summa (C-stationary)",
                                       "gemm_summa (A-stationary, thin C)", "potrf_dist"]
    assert all(r[1] > 0 and r[3] > 0 for r in rows)
    # summarize is slate_tpu's formula on the same records
    mesh = tp.make_mesh(2, 4, device="cpu")
    a = torch.eye(32) * 4 + 0.1
    with tcomm.comm_audit() as recs:
        tp.potrf_dist(tp.from_dense(a, mesh, 4, diag_pad_one=True), bcast_impl="ring")
    assert comm_audit.summarize(recs, p, q) == jcomm_audit.summarize(recs, p, q)
    text = comm_audit.render(rows, p, q, 32, 4)
    assert "| potrf_dist |" in text
    out = tmp_path / "audit.md"
    with contextlib.redirect_stdout(io.StringIO()):
        assert comm_audit.main(["--n", "32", "--nb", "4", "--device", "cpu", "--out", str(out),
                                "--report", str(tmp_path / "r.json")]) == 0
    assert out.read_text() == text


def test_dryrun_flight_timeline_beside_slate_tpu():
    n, nb = tdry.N, tdry.NB
    gate = 100 * n * EPS32
    jrep = jflight.run_flight("potrf", n=n, nb=nb, depth=1,
                              mesh=jmake_mesh(2, 4, devices=cpu_devices(8)))
    res = tdry.dryrun("cpu")
    assert res["ok"], res["phases"]
    ft = res["phases"]["flight_timeline"]
    js = jrep["sched"]
    for s in (ft, js):
        assert s["overlap_eff_la0"] == 0.0 and 0.0 < s["overlap_eff"] <= 1.0
    assert ft["model_bytes"] == jrep["model"]["total_bytes"]
    assert jrep["values"]["resid"] <= gate
    trep = flight.run_flight("potrf", n=n, nb=nb, depth=1, device="cpu")
    assert trep["values"]["resid"] <= gate
    assert trep["model"]["phase_bytes"] == jrep["model"]["phase_bytes"]
    assert flight.validate_flight_report(jrep) == [] == jflight.validate_flight_report(trep)
    # the same rows, k by k; slate_tpu's step dispatch is unbucketed, so its
    # measured bytes exceed its model, the port's equal its model
    assert [(e["k"], e["phase"]) for e in trep["events"][::8]] == \
        [(e["k"], e["phase"]) for e in jrep["events"][::8]]
    assert trep["values"]["sched.measured_bytes"] == trep["model"]["total_bytes"]
    assert jrep["values"]["sched.measured_bytes"] >= jrep["model"]["total_bytes"]
