"""The port's live telemetry surface against slate_tpu's obs/live.py: the
bus, the one Prometheus formatter and its validator, the offline snapshot,
the ledger and ``report --trend``, the scrape endpoint and the ``--ci``
acceptance run.

Held exactly against slate_tpu: ``prometheus_text`` byte for byte on the
same snapshot dicts, ``validate_prometheus_text``'s errors on valid and
broken texts, ``snapshot_from_report`` on the same reports, and the
two-tenant ``--ci`` workload's request outcomes, classes and ``serve.*``
counter deltas (its mesh round on the 8 forced CPU devices and on the port's
virtual 2 x 4 mesh).  Every HTTP call has its own timeout and every server
is shut down in ``finally``; they bind 127.0.0.1 on port 0.
"""

import gc
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from torch_queue_common import live_obs, pair, spd_np  # noqa: F401 (fixture)
from torch_serve_common import clear_admission_memos, counter_deltas

from slate_tpu import obs as jobs
from slate_tpu.obs import live as jlive
from slate_tpu.serve import trace as jtrace
from slate_tpu_torch import obs
from slate_tpu_torch.obs import live
from slate_tpu_torch.obs import report as obs_report
from slate_tpu_torch.obs.metrics import REGISTRY
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.controller import ServiceController
from slate_tpu_torch.serve.router import Router

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def _hex16(s):
    return isinstance(s, str) and len(s) == 16 and all(c in "0123456789abcdef" for c in s)


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------


def test_bus_bounded_ring_semantics():
    """A bounded ring: capped length, the dropped count, monotonic seqs,
    ``since`` filtering, as slate_tpu's."""
    for cls in (live.TelemetryBus, jlive.TelemetryBus):
        bus = cls(cap=8)
        seqs = [bus.publish("t", {"i": i}) for i in range(12)]
        assert seqs == sorted(seqs) and len(set(seqs)) == 12
        assert len(bus) == 8 and bus.dropped == 4
        assert [e["data"]["i"] for e in bus.events()] == list(range(4, 12))
        assert [e["data"]["i"] for e in bus.events(since=seqs[-3])] == [10, 11]
        assert [e["data"]["i"] for e in bus.events(limit=2)] == [10, 11]
        assert bus.events(since=bus.last_seq()) == []
        bus.clear()
        assert len(bus) == 0 and bus.dropped == 0


def test_bus_carries_every_event_kind(rng, live_obs):  # noqa: F811
    """With obs.live loaded, span exits, finished requests, memory samples,
    window closes and controller actuations all reach the bus; the request's
    spans and memory samples carry its trace_id."""
    from slate_tpu_torch.obs import memory

    since = live.BUS.last_seq()
    with pair("t_bus", max_batch=2) as p, memory.force_sampling(True):
        p.tq.submit("posv", spd_np(rng), rng.standard_normal(16), tenant="acme")
        p.tq.submit("posv", spd_np(rng), rng.standard_normal(16), tenant="acme")
        tr = rtrace.finished_traces()[-1]
        ctrl = ServiceController(p.tq, slo_p95_s=0.25, arm=1, cooldown=0)
        REGISTRY.observe("serve.latency_s", 2.0, op="posv", klass="friendly", outcome="served")
        assert [a["action"] for a in ctrl.step()] == ["shrink_window"]
    evs = live.BUS.events(since=since)
    assert {"span", "request", "mem", "queue", "controller"} <= {e["kind"] for e in evs}
    assert any(e["kind"] == "request" and e["data"]["trace_id"] == tr.trace_id for e in evs)
    assert any(e["kind"] == "span" and e["data"]["tags"].get("trace_id") == tr.trace_id
               for e in evs)
    assert any(e["kind"] == "mem" and e["data"].get("trace_id") == tr.trace_id for e in evs)
    win = [e["data"] for e in evs if e["kind"] == "queue"]
    assert win == [{"queue": "t_bus", "key": "posv/friendly/n16/rhs1/float64", "count": 2,
                    "tenants": ["acme"], "event": "window"}]


def test_bus_budget_reject_event(rng, live_obs):  # noqa: F811
    since = live.BUS.last_seq()
    with pair("t_bus_budget", budgets={"tiny": 100}) as p:
        p.submit_raises("posv", spd_np(rng), rng.standard_normal(16), tenant="tiny",
                        match="budget")
    (ev,) = [e["data"] for e in live.BUS.events(since=since) if e["kind"] == "queue"]
    assert ev["event"] == "budget_reject" and ev["tenant"] == "tiny" and ev["n"] == 16
    assert (ev["cost_bytes"], ev["headroom_bytes"]) == (3.5 * 16 * 16 * 8, 100)


# ---------------------------------------------------------------------------
# the one formatter, its validator and the offline snapshot
# ---------------------------------------------------------------------------


def _snapshot(seed):
    """A snapshot dict of every section the formatter reads, seeded."""
    g = np.random.default_rng(seed)

    def v():
        return float(g.choice([0.0, 1.0, 3.0, 1e-15, 2.5e9, 0.125])) * (1 + g.random())

    tags = [{}, {"op": "posv", "klass": "friendly"}, {"op": "gesv", "tenant": "a-b.c"},
            {"queue": "svc", "tenant": "zeta"}]
    return {
        "serve": {"requests": v(), "latency_p99_posv_friendly_s": v(),
                  "outcome_rate_served": v(), "queue_windows": v(), "dtype:float64": v()},
        "num": {"growth_max": v(), "chol_margin_min": v(), "monitored": v(),
                "condest_last": v(), "ir_iters_total": v()},
        "mem": {"live_bytes_max": v(), "samples": v(), "oom_events": v()},
        "sched": {"sched.link_bytes": v(), "sched.overlap_eff": v()},
        "metrics": {
            "counters": [{"name": "serve.requests", "tags": tg, "value": v()} for tg in tags],
            "gauges": ([{"name": "serve.queue_depth", "tags": tg, "value": v()}
                        for tg in tags[2:]]
                       + [{"name": "mem.live_bytes", "tags": {}, "value": v()}]),
            "histograms": [{"name": "serve.latency_s", "tags": tg,
                            "count": int(g.integers(1, 9)), "sum": v(), "p50": v(),
                            "p95": v() if i else None, "p99": v()}
                           for i, tg in enumerate(tags)],
        },
    }


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prometheus_text_byte_identical_to_jax(seed):
    snap = _snapshot(seed)
    text = live.prometheus_text(snap)
    assert text == jlive.prometheus_text(json.loads(json.dumps(snap)))
    assert live.validate_prometheus_text(text) == []
    assert text.count("# TYPE slate_tpu_serve_latency_s summary") == 1


_BROKEN = [
    "",
    "slate_tpu_x 1\n",
    "# TYPE slate_tpu_x counter\n# TYPE slate_tpu_x counter\nslate_tpu_x 1\n",
    "# TYPE slate_tpu_x gauge\nslate_tpu_x one\n",
    "# HELP slate_tpu_x words\n",
    "# TYPE slate_tpu_y summary\nslate_tpu_y_count 3\nslate_tpu_y_sum 1.5\n"
    'slate_tpu_y{quantile="0.5"} 0.5\nslate_tpu_z_total 1\n',
    "# TYPE slate_tpu_x counter\nslate_tpu_x{a=\"b\"} +Inf\nslate_tpu_x NaN\n",
]


@pytest.mark.parametrize("text", _BROKEN)
def test_validate_prometheus_text_matches_jax(text):
    assert live.validate_prometheus_text(text) == jlive.validate_prometheus_text(text)


def test_validator_flags_what_it_should():
    assert live.validate_prometheus_text(_BROKEN[1])[0].endswith("precedes its TYPE header")
    assert "repeated TYPE" in live.validate_prometheus_text(_BROKEN[2])[0]
    assert "unparsable sample" in live.validate_prometheus_text(_BROKEN[3])[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_snapshot_from_report_matches_jax(seed):
    snap = _snapshot(seed)
    rep = {"serve": snap["serve"], "num": {"monitored": 2.0}, "mem": snap["mem"],
           "values": {"num.qr_orth_margin_fused": 1e-15, "sched.model_bytes": 61440.0,
                      "other": 1.0, "num.label": "text"},
           "metrics": {k: v + [{"name": "flight.rows", "tags": {}, "value": 1.0}]
                       for k, v in snap["metrics"].items() if k != "histograms"}}
    got = live.snapshot_from_report(rep)
    assert got == jlive.snapshot_from_report(json.loads(json.dumps(rep)))
    assert live.prometheus_text(got) == jlive.prometheus_text(got)


def test_stats_export_grows_num_and_sched_families():
    """One scrape surfaces latency, schedule and health together: the text
    grows num / sched families from the live registry and from a report."""
    from slate_tpu_torch.obs import numerics
    from slate_tpu_torch.serve import stats

    numerics.reset()
    numerics.record_qr_orth("geqrf", 3e-15)
    text = stats.prometheus_text()
    assert "slate_tpu_num_qr_orth_loss_max" in text
    assert "# TYPE slate_tpu_num_qr_orth_loss_max gauge" in text
    assert "slate_tpu_num_qr_orth_margin" in text
    numerics.reset()
    rep = {"values": {"num.qr_orth_margin_fused": 1e-15, "sched.model_bytes": 61440.0},
           "num": {"monitored": 2.0}}
    off = stats.prometheus_text(stats.snapshot_from_report(rep))
    for fam in ("slate_tpu_num_qr_orth_margin_fused", "slate_tpu_sched_model_bytes",
                "slate_tpu_num_monitored"):
        assert fam in off


def test_stats_shim_delegates_to_live():
    """serve.stats delegates: one formatter, in obs.live."""
    from slate_tpu_torch.serve import stats

    assert stats.prometheus_text is live.prometheus_text
    assert stats.stats_snapshot is live.stats_snapshot
    assert stats.validate_prometheus_text is live.validate_prometheus_text
    assert stats.snapshot_from_report is live.snapshot_from_report


def test_stats_cli_formats_a_report_as_jax_does(tmp_path, capsys):
    from slate_tpu.serve import stats as jstats
    from slate_tpu_torch.serve import stats

    path = tmp_path / "rep.json"
    path.write_text(json.dumps({"serve": _snapshot(5)["serve"],
                                "values": {"sched.model_bytes": 1.0}}))
    assert stats.main([str(path), "--json", str(tmp_path / "snap.json")]) == 0
    mine = capsys.readouterr().out
    assert jstats.main([str(path)]) == 0
    assert mine == capsys.readouterr().out
    assert json.loads((tmp_path / "snap.json").read_text())["sched"] == {
        "sched.model_bytes": 1.0}
    assert stats.main([str(tmp_path / "missing.json")]) == 2


# ---------------------------------------------------------------------------
# the ledger and --trend
# ---------------------------------------------------------------------------


def _mini_report(i, values):
    return {"schema": obs_report.SCHEMA, "version": obs_report.VERSION, "name": "spine_t",
            "created_unix": 1000.0 + i, "env": {}, "config": {}, "values": dict(values),
            "metrics": {"counters": [], "gauges": [], "histograms": []}, "spans": []}


def test_ledger_rotation_and_trace_id_stamp(tmp_path):
    d = str(tmp_path / "ledger")
    for i in range(5):
        live.ledger_append(_mini_report(i, {"x": float(i)}), d, cap=3)
    paths = live.ledger_paths(d)
    assert len(paths) == 3
    docs = live.ledger_load(d)
    assert [doc["values"]["x"] for doc in docs] == [2.0, 3.0, 4.0]
    assert [doc["values"]["x"] for doc in live.ledger_load(d, last=2)] == [3.0, 4.0]
    for doc in docs:
        assert _hex16(doc["config"]["trace_id"])
        assert doc["config"]["trace_id"][:8] in doc["_ledger_path"]
    # the same file names as slate_tpu's for the same report and id
    rep = _mini_report(7, {})
    rep["config"]["trace_id"] = "0123456789abcdef"
    mine = live.ledger_append(json.loads(json.dumps(rep)), str(tmp_path / "a"))
    theirs = jlive.ledger_append(json.loads(json.dumps(rep)), str(tmp_path / "b"))
    assert mine.rsplit("/", 1)[1] == theirs.rsplit("/", 1)[1]
    assert live.ledger_paths(str(tmp_path / "none")) == []


def test_trend_gate_exit_codes(tmp_path, capsys):
    """--trend reads live.ledger_load: < 3 usable entries 2, a stable
    history 0, a regressed newest entry 1."""
    d = str(tmp_path / "ledger")
    vals = {"spine_seconds": 1.0, "spine_gflops": 10.0}
    live.ledger_append(_mini_report(0, vals), d)
    live.ledger_append(_mini_report(1, vals), d)
    assert obs_report.main(["--trend", d]) == 2
    live.ledger_append(_mini_report(2, vals), d)
    live.ledger_append(_mini_report(3, vals), d)
    assert obs_report.main(["--trend", d]) == 0
    live.ledger_append(_mini_report(4, {"spine_seconds": 10.0, "spine_gflops": 10.0}), d)
    assert obs_report.main(["--trend", d]) == 1
    out = capsys.readouterr().out
    assert "spine_seconds" in out and "regression" in out
    assert not hasattr(obs_report, "ledger_load")  # one copy, in obs.live


def test_trend_new_key_inconclusive_not_fatal(tmp_path, capsys):
    d = str(tmp_path / "ledger")
    for i in range(3):
        live.ledger_append(_mini_report(i, {"spine_seconds": 1.0}), d)
    live.ledger_append(_mini_report(3, {"spine_seconds": 1.0, "fresh_bytes": 5.0}), d)
    assert obs_report.main(["--trend", d]) == 0
    assert "fresh_bytes" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the scrape endpoint and the --ci run
# ---------------------------------------------------------------------------


def test_scrape_endpoint_serves_validated_text(rng):
    n = 32
    router = Router(bins=(32,), hbm_budget=1 << 30, device="cpu")
    good = torch.from_numpy(rng.standard_normal((n, n)) + n * np.eye(n))
    b = torch.from_numpy(rng.standard_normal((n, 2)))
    since = live.BUS.last_seq()
    with obs.force_enabled(True):
        router.solve("gesv", good, b, tenant="acme")
    srv, _thread, port = live.start_server(port=0)
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
                return r.read().decode()

        text = get("/metrics")
        assert live.validate_prometheus_text(text) == []
        assert "slate_tpu_serve_requests" in text and 'tenant="acme"' in text
        assert json.loads(get("/snapshot.json"))["finished_requests"] >= 1
        page = json.loads(get(f"/events.json?since={since}"))
        assert page["events"] and page["last_seq"] > since
        body = get("/healthz")
        assert body.splitlines()[0] == "ok" and "open_windows" in body
        assert "queues" in json.loads(get("/queue.json"))
        with pytest.raises(urllib.error.HTTPError):
            get("/nope")
    finally:
        srv.shutdown()
        srv.server_close()


def _workload_record(traces):
    return [(tr.op, tr.n, tr.klass, tr.tenant, tr.outcome, tr.bin, tuple(tr.notes))
            for tr in traces]


def test_ci_workload_matches_jax():
    """The --ci workload (two tenants meshless, then the checkpointed and
    monitored mesh gesv): the same requests, classes, tenants and outcomes,
    and the same serve.* counter deltas, in both packages."""
    from slate_tpu.serve.cache import executable_cache as jcache
    from slate_tpu_torch.serve.cache import executable_cache

    clear_admission_memos()
    jcache.clear()
    executable_cache.clear()
    jobs.reset()
    obs.reset()
    with counter_deltas() as d, jobs.force_enabled(True), obs.force_enabled(True):
        jtr = jlive._run_workload(mesh_round=True)
        ttr = live._run_workload(mesh_round=True, device="cpu")
    assert len(ttr) == 5
    assert _workload_record(ttr) == _workload_record(jtr)
    assert d["torch"] == d["jax"]
    jtrace.reset()
    jobs.reset()
    obs.reset()


def test_run_ci_passes_on_the_host(tmp_path, capsys):
    """``obs.live --ci --device cpu``: exit 0, the scrape, the unified trace
    and one ledger entry (seeded from an existing ledger)."""
    seed = tmp_path / "seed"
    live.ledger_append(_mini_report(0, {"x": 1.0}), str(seed))
    try:
        rc = live.main(["--ci", "--device", "cpu", "--out", str(tmp_path / "out"),
                        "--ledger-seed", str(seed)])
    finally:
        obs.disable()
        obs.reset()
    assert rc == 0, capsys.readouterr().out
    out = tmp_path / "out"
    assert live.validate_prometheus_text((out / "scrape.prom").read_text()) == []
    assert json.loads((out / "unified.trace.json").read_text())["traceEvents"]
    docs = live.ledger_load(str(out / "ledger"))
    assert [d_["name"] for d_ in docs] == ["spine_t", "obs_live_ci"]
    assert docs[-1]["values"]["live.finished_requests"] == 5.0
