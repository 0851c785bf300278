"""The port's Service (queue + worker + controller) and its HTTP front door
against slate_tpu's.

On the host, n = 16 in one bin.  The worker thread runs on the wall clock
here, so every wait is bounded: ``Ticket.wait`` through the service's
``request_timeout_s``, ``urlopen(timeout=...)``, ``Thread.join(timeout=...)``,
and ``Service.stop()`` / ``server.shutdown(); server.server_close()`` in
``finally``.  The servers bind 127.0.0.1 on port 0.  Held: answers bitwise
the port's one-at-a-time Router.solve (and within 1e-12 of slate_tpu's), every
trace served, no pump error, and the front door's status codes equal to
slate_tpu's on the same bodies.
"""

import gc
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from torch_queue_common import BIN, N, live_obs, spd_np, t  # noqa: F401 (fixture)

from slate_tpu.serve.cache import ExecutableCache as JCache
from slate_tpu.serve.router import Router as JRouter
from slate_tpu.serve.service import Service as JService
from slate_tpu.serve.service import start_http as jstart_http
from slate_tpu_torch import obs
from slate_tpu_torch.obs import live
from slate_tpu_torch.obs.metrics import serve_counts
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.cache import ExecutableCache
from slate_tpu_torch.serve.router import Router
from slate_tpu_torch.serve.service import Service, main, start_http

torch.set_num_threads(1)

TIMEOUT = 30.0


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def router():
    return Router(bins=(BIN,), hbm_budget=1 << 30, cache=ExecutableCache(), device="cpu")


def test_worker_survives_pump_exception(rng, live_obs):  # noqa: F811
    """A non-SlateError escaping pump() does not kill the worker: it counts
    serve.queue_pump_errors, and the next pump still serves."""
    svc = Service(router=router(), max_batch=2, window_s=0.001, name="t_svc_survive",
                  request_timeout_s=TIMEOUT)
    orig_pump = svc.queue.pump
    state = {"boomed": False}

    def flaky_pump():
        if not state["boomed"]:
            state["boomed"] = True
            raise ValueError("boom")
        return orig_pump()

    svc.queue.pump = flaky_pump
    before = serve_counts()["queue_pump_errors"]
    svc.start()
    try:
        a, b = spd_np(rng), rng.standard_normal(N)
        x = svc.solve("posv", t(a), t(b))
        assert x.shape == (N,) and state["boomed"]
        assert serve_counts()["queue_pump_errors"] - before == 1
        assert torch.equal(x, router().solve("posv", t(a), t(b)))
    finally:
        svc.stop()


def test_concurrent_submitters_share_windows(rng, live_obs):  # noqa: F811
    """Four client threads, three requests each, two tenants, on the wall
    clock: every answer bitwise the one-at-a-time Router.solve, every trace
    served, fewer windows than requests, no pump error, no window left."""
    probs = [(spd_np(rng), rng.standard_normal((N, 1))) for _ in range(12)]
    svc = Service(router=router(), max_batch=4, window_s=0.05, name="t_svc_concurrent",
                  weights={"acme": 2.0}, request_timeout_s=TIMEOUT)
    got, errors = {}, []
    c0 = serve_counts()

    def client(k):
        try:
            for i in range(k, len(probs), 4):
                a, b = probs[i]
                got[i] = svc.solve("posv", t(a), t(b), tenant="acme" if k % 2 else "zeta")
        except Exception as e:  # surfaced below
            errors.append(e)

    svc.start()
    try:
        threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=2 * TIMEOUT)
        assert not any(th.is_alive() for th in threads)
    finally:
        svc.stop()
    assert not errors and sorted(got) == list(range(12))
    ref = router()
    for i, (a, b) in enumerate(probs):
        assert torch.equal(got[i], ref.solve("posv", t(a), t(b)))
    d = {k: v - c0[k] for k, v in serve_counts().items() if v != c0[k]}
    assert d["queue_submitted"] == d["queue_dispatched"] == 12
    assert d.get("queue_pump_errors", 0) == 0 and d["queue_windows"] < 12
    assert {tr.outcome for tr in rtrace.finished_traces()} == {"served"}
    assert svc.queue.depth() == 0 and svc.queue.stats()["open_windows"] == 0


def _post(port, body, path="/solve"):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return r.read().decode()


def test_http_front_door_matches_jax(rng, live_obs):  # noqa: F811
    """The same bodies to both front doors: the same status codes (200, 400
    for malformed JSON / a missing key / a ragged list, 429 for a budget
    refusal, 422 for a non-square operand and an over-bin size, 404), the
    answer within 1e-12 of slate_tpu's and bitwise the port's Router.solve;
    /queue.json, /healthz and validator-clean /metrics."""
    a, b = spd_np(rng), rng.standard_normal(N)
    bodies = [
        {"op": "posv", "a": a.tolist(), "b": b.tolist(), "tenant": "acme"},
        b"{",
        {"op": "posv", "a": a.tolist()},
        {"op": "posv", "a": [[1.0, 2.0], [3.0]], "b": [1.0, 2.0]},
        {"op": "posv", "a": a.tolist(), "b": b.tolist(), "tenant": "tiny"},
        {"op": "posv", "a": np.ones((N, N - 4)).tolist(), "b": b.tolist()},
        {"op": "posv", "a": spd_np(rng, 2 * N).tolist(), "b": np.ones(2 * N).tolist()},
    ]
    kw = dict(max_batch=2, window_s=0.005, budgets={"tiny": 1000}, request_timeout_s=TIMEOUT)
    jsvc = JService(router=JRouter(bins=(BIN,), hbm_budget=1 << 30, cache=JCache()),
                    name="t_http_j", **kw)
    tsvc = Service(router=router(), name="t_http_t", **kw)
    servers = []
    try:
        for svc, start in ((jsvc, jstart_http), (tsvc, start_http)):
            svc.start()
            servers.append(start(svc, port=0))
        (_js, _jt, jport), (_ts, _tt, tport) = servers
        jres = [_post(jport, body) for body in bodies]
        tres = [_post(tport, body) for body in bodies]
        assert [c for c, _ in tres] == [c for c, _ in jres] == [200, 400, 400, 400, 429, 422,
                                                                422]
        assert _post(tport, {}, path="/nope")[0] == 404 == _post(jport, {}, path="/nope")[0]
        xt = np.asarray(tres[0][1]["x"])
        np.testing.assert_allclose(xt, np.asarray(jres[0][1]["x"]), rtol=1e-12, atol=1e-12)
        assert np.array_equal(xt, router().solve("posv", t(a), t(b)).numpy())
        assert tres[0][1]["tenant"] == "acme"
        doc = json.loads(_get(tport, "/queue.json"))
        assert doc["queues"]["t_http_t"]["depth"] == 0
        assert doc["queues"]["t_http_t"]["tenants"]["tiny"]["budget_bytes"] == 1000
        lines = _get(tport, "/healthz").splitlines()
        assert lines[0] == "ok" and lines[1].startswith("queues ")
        text = _get(tport, "/metrics")
        assert live.validate_prometheus_text(text) == []
        assert "slate_tpu_serve_queue_submitted" in text
    finally:
        for srv, _th, _port in servers:
            srv.shutdown()
            srv.server_close()
        jsvc.stop()
        tsvc.stop()


def test_service_main_rejects_zero_weight(monkeypatch):
    """``--weight t=0`` fails fast with a clean exit, as in slate_tpu."""
    monkeypatch.setenv("SLATE_TPU_HBM_BYTES", str(1 << 30))
    try:
        with pytest.raises(SystemExit, match="weight"):
            main(["--weight", "t=0", "--device", "cpu", "--port", "0"])
        with pytest.raises(SystemExit, match="TENANT=VALUE"):
            main(["--budget", "nobytes", "--device", "cpu", "--port", "0"])
    finally:
        obs.disable()


def test_service_default_router_is_on_the_card(monkeypatch):
    """Without a router the service builds one on the card (without a card
    and without a host budget it refuses rather than fall back)."""
    monkeypatch.delenv("SLATE_TPU_HBM_BYTES", raising=False)
    if torch.cuda.is_available():
        svc = Service(name="t_default_router")
        try:
            assert svc.router.device.type == "cuda"
        finally:
            svc.stop()
        return
    with pytest.raises((ValueError, AssertionError, RuntimeError)):
        Service(name="t_default_router")


def test_comm_audit_channels_are_per_thread():
    """Two dispatch threads open their spans' audits interleaved (A opens,
    B opens, A records and closes, B records and closes): each capture
    holds its own thread's records and the enclosing capture of each thread
    receives them (with process-wide channels A's exit handed B's list to
    A and left B to extend None)."""
    from slate_tpu_torch.parallel import comm

    steps = [threading.Event() for _ in range(4)]
    got, errors = {}, []

    def run(name, wait_open, opened, wait_close, closed):
        try:
            with comm.comm_audit() as outer:
                wait_open and wait_open.wait(TIMEOUT)
                with comm.comm_audit(propagate=True) as inner:
                    opened.set()
                    wait_close and wait_close.wait(TIMEOUT)
                    comm.audit(f"{name}_op", 8 if name == "a" else 16)
                closed.set()
            got[name] = (list(inner), list(outer))
        except Exception as e:  # surfaced below
            errors.append(e)

    ta = threading.Thread(target=run, args=("a", None, steps[0], steps[1], steps[2]))
    tb = threading.Thread(target=run, args=("b", steps[0], steps[1], steps[2], steps[3]))
    for th in (ta, tb):
        th.start()
    for th in (ta, tb):
        th.join(timeout=TIMEOUT)
    assert not errors and not ta.is_alive() and not tb.is_alive()
    assert got["a"] == ([("a_op", 8, 1)], [("a_op", 8, 1)])
    assert got["b"] == ([("b_op", 16, 1)], [("b_op", 16, 1)])


def test_shared_serve_state_under_thread_contention(rng):
    """More threads than cores bumping the flat serve counters and
    classifying one stationary operator through a shared Router's condest
    memo, with a short switch interval: no lost count, no memo error, one
    class per call."""
    import sys

    from slate_tpu_torch.obs.metrics import serve_count

    r = router()
    a = t(rng.standard_normal((N, N)) + N * np.eye(N))
    errors = []
    c0 = serve_counts()

    def work():
        try:
            for _ in range(500):
                serve_count("queue_windows")
            for _ in range(5):
                assert r.classify("gesv", a) == "friendly"
        except Exception as e:  # surfaced below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, daemon=True) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    d = {k: v - c0[k] for k, v in serve_counts().items() if v != c0[k]}
    assert d["queue_windows"] == 16 * 500
    assert d["class_friendly"] == 16 * 5
    assert d["condest_cache_hits"] >= 16 * 4
