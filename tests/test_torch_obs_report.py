"""The port's RunReports and Perfetto export against ``slate_tpu``'s.

- a RunReport from each package passes the other's ``validate_report``
  (and a broken one fails both);
- the direction tables (``_LOWER_BETTER``, ``_NEUTRAL``,
  ``_SECTION_PREFIXES``) are ``slate_tpu``'s, and ``load_values``,
  ``check_regression`` and the ``--check`` / ``--trend`` exit codes agree
  on the same pairs of synthetic reports;
- the span trace and a flight's Gantt validate under both packages'
  ``validate_chrome_trace``;
- the three smokes' report step (``write_checked_report``).
"""

import contextlib
import copy
import io
import json
import os

import pytest
import torch

from slate_tpu.obs import perfetto as jperfetto
from slate_tpu.obs import report as jreport
from slate_tpu_torch import obs as tobs
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import flight, perfetto, report

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def obs_off(monkeypatch):
    monkeypatch.delenv("SLATE_TPU_OBS", raising=False)
    tobs.disable()
    tobs.reset()
    yield
    tobs.disable()
    tobs.reset()


def _port_report():
    tobs.enable()
    mesh = tp.make_mesh(2, 4, device="cpu")
    a = torch.eye(24) * 3 + 0.1
    with tobs.driver_span("case", n=24):
        tp.potrf_dist(tp.from_dense(a, mesh, 3, diag_pad_one=True))
    tobs.REGISTRY.observe("lat", 0.5, op="x")
    return report.make_report("case", config={"n": 24}, values={"wall_seconds": 1.25,
                                                                "gflops": 3.0})


def test_reports_cross_validate():
    rep = json.loads(json.dumps(_port_report()))
    assert report.validate_report(rep) == [] and jreport.validate_report(rep) == []
    assert rep["env"]["platform"] in ("cpu", "cuda") and "torch" in rep["env"]
    assert set(rep) >= {"ft", "ir", "mem", "num", "serve", "metrics", "spans"}
    assert [s["name"] for s in rep["spans"]] == ["potrf_dist", "case"]
    jrep = jreport.make_report("jcase", values={"x_seconds": 1.0})
    jrep = json.loads(json.dumps(jrep))
    assert report.validate_report(jrep) == []
    for bad in ({**rep, "schema": "x"}, {**rep, "values": {"a": "b"}}, {**rep, "spans": [{}]},
                {**rep, "ft": {"detected": "many"}}, {**rep, "metrics": {"counters": []}}, []):
        assert report.validate_report(bad) == jreport.validate_report(bad) != []


def test_direction_tables_are_slate_tpus():
    assert report._LOWER_BETTER == jreport._LOWER_BETTER
    assert report._NEUTRAL == jreport._NEUTRAL
    assert report._SECTION_PREFIXES == jreport._SECTION_PREFIXES
    assert report.SCHEMA == jreport.SCHEMA and report.VERSION == jreport.VERSION
    for name in ("wall_seconds", "gflops", "comm_bytes", "sched.overlap_eff", "ft_detected",
                 "resid", "flops", "ir_iters_total", "x|span=a"):
        assert report.lower_is_better(name) == jreport.lower_is_better(name)


def _synthetic_pairs():
    base = {"schema": report.SCHEMA, "version": 1, "name": "s", "created_unix": 1.0,
            "config": {"n": 8}, "values": {"wall_seconds": 2.0, "gflops": 10.0, "flops": 5.0},
            "metrics": {"counters": [{"name": "comm_bytes", "tags": {"span": "a"}, "value": 8.0}],
                        "gauges": [], "histograms": []},
            "spans": [], "ft": {"detected": 3.0, "corrected": 1.0}, "ir": {"solves": 0.0}}
    slow = copy.deepcopy(base)
    slow["values"]["wall_seconds"] = 4.0
    lost = copy.deepcopy(base)
    lost["ft"]["detected"] = 0.0
    neutral = copy.deepcopy(base)
    neutral["values"]["flops"] = 50.0
    other = copy.deepcopy(base)
    other["config"] = {"n": 9}
    other["values"] = {"x_seconds": 1.0}
    sectioned = copy.deepcopy(base)
    sectioned["serve"] = {"ozaki_presplits": 2.0}
    flight_doc = {"schema": "slate_tpu.obs.flight_report", "values": {"sched.model_bytes": 10.0}}
    bench = {"metric": "gflops", "value": 9.0, "extras": {"wall_seconds": 2.1}}
    return [(base, base), (slow, base), (base, slow), (lost, base), (neutral, base),
            (other, base), (sectioned, base), (base, bench), (flight_doc, flight_doc),
            ({"junk": 1}, base)]


@pytest.mark.parametrize("extra", [[], ["--threshold", "3"], ["--all-metrics"],
                                   ["--ignore", "wall_*"]])
def test_check_exit_codes_match(tmp_path, extra):
    for i, (new, old) in enumerate(_synthetic_pairs()):
        pn, po = tmp_path / f"n{i}.json", tmp_path / f"o{i}.json"
        pn.write_text(json.dumps(new))
        po.write_text(json.dumps(old))
        args = ["--check", str(pn), str(po)] + extra
        with contextlib.redirect_stdout(io.StringIO()):
            got, want = report.main(args), jreport.main(args)
        assert got == want, (i, extra)
        nv = report.load_values(new, "--all-metrics" in extra) if "junk" not in new else None
        if nv is not None:
            assert nv == jreport.load_values(new, "--all-metrics" in extra)


def test_trend_exit_codes_match(tmp_path):
    ledger = tmp_path / "ledger"
    ledger.mkdir()
    base = _synthetic_pairs()[0][0]

    def rcs():
        with contextlib.redirect_stdout(io.StringIO()):
            return report.main(["--trend", str(ledger)]), jreport.main(["--trend", str(ledger)])

    assert rcs() == (2, 2)
    for i, wall in enumerate((2.0, 2.2, 1.9, 2.05)):
        doc = copy.deepcopy(base)
        doc["values"]["wall_seconds"] = wall
        (ledger / f"{i:04d}.json").write_text(json.dumps(doc))
    got, want = rcs()
    assert got == want == 0
    doc["values"]["wall_seconds"] = 9.0
    (ledger / "0009.json").write_text(json.dumps(doc))
    got, want = rcs()
    assert got == want == 1


def test_traces_validate_under_both(tmp_path):
    _port_report()
    path = perfetto.write_chrome_trace(str(tmp_path / "t.json"))
    tr = json.loads(open(path).read())
    assert perfetto.validate_chrome_trace(tr) == [] and jperfetto.validate_chrome_trace(tr) == []
    names = {e["name"] for e in tr["traceEvents"]}
    assert {"case", "potrf_dist", "ppermute[q]", "ppermute_link_bytes"} <= names
    rep = flight.run_flight("potrf", n=40, nb=5, depth=1, device="cpu")
    ftr = perfetto.flight_chrome_trace(rep["events"], rep["hop_events"], grid=(2, 4))
    jtr = jperfetto.flight_chrome_trace(rep["events"], rep["hop_events"], grid=(2, 4))
    assert ftr == jtr
    assert perfetto.validate_chrome_trace(ftr) == [] == jperfetto.validate_chrome_trace(ftr)
    assert len({e["tid"] for e in ftr["traceEvents"] if e["ph"] == "X"}) == 8
    assert any(e["ph"] == "s" for e in ftr["traceEvents"])
    bad = {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 0, "ts": -1, "dur": 1}]}
    assert perfetto.validate_chrome_trace(bad) == jperfetto.validate_chrome_trace(bad) != []


def test_write_checked_report(tmp_path):
    doc, errs, rc = report.write_checked_report(str(tmp_path), "r.json", "smk",
                                                values={"x_error": 1e-9})
    assert errs == [] and rc == 0 and os.path.exists(tmp_path / "r.json")
    assert jreport.validate_report(doc) == []
    doc, errs, rc = report.write_checked_report(None, "r.json", "smk", values={})
    assert errs == [] and rc == 2  # nothing shared to compare
