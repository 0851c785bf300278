"""The port's SLA control loop against slate_tpu's: the Hysteresis latch's
edges, and the ServiceController's actuations on the same signals.

The latch is fed the same seeded value sequences in both packages and must
give the same edges tick by tick.  The controller reads the SLA surface
(``serve.trace.sla_values``) and the queue's depth: both are patched to the
same per-tick values in both packages (the latency quantiles are wall
clock, so a real stream cannot be compared), and the actuation records
(tick, action, B, T, tier map, signals), the routers' tier maps, the
``serve.controller_actuations`` deltas and the window gauges must match.
"""

import gc

import jax
import numpy as np
import pytest
import torch

from torch_queue_common import (
    counter_deltas,
    live_obs,  # noqa: F401 (fixture)
    pair,
    spd_np,
)

from slate_tpu.obs import REGISTRY as JREGISTRY
from slate_tpu.serve import trace as jtrace
from slate_tpu.serve.controller import Hysteresis as JHysteresis
from slate_tpu.serve.controller import ServiceController as JServiceController
from slate_tpu_torch.obs import REGISTRY
from slate_tpu_torch.obs import live
from slate_tpu_torch.serve import trace as rtrace
from slate_tpu_torch.serve.controller import Hysteresis, ServiceController

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


# ---------------------------------------------------------------------------
# the latch
# ---------------------------------------------------------------------------


def edges(cls, values, *args, **kw):
    h = cls(*args, **kw)
    return [h.observe(v) for v in values], h.tripped


def test_hysteresis_trips_once_and_releases():
    seq = [11, 12, 15, 1, 1, 1]
    got = edges(Hysteresis, seq, 10.0, 2.0, arm=2, cooldown=2)
    assert got == edges(JHysteresis, seq, 10.0, 2.0, arm=2, cooldown=2)
    assert got[0] == [None, "trip", None, None, "release", None]


def test_hysteresis_no_flap_on_square_wave():
    seq = [11, 1] * 4
    got = edges(Hysteresis, seq, 10.0, 2.0, arm=2, cooldown=1)
    assert got == edges(JHysteresis, seq, 10.0, 2.0, arm=2, cooldown=1)
    assert got[0] == [None] * 8  # the streaks never arm


@pytest.mark.parametrize("arm,cooldown", [(1, 0), (2, 3), (3, 1), (1, 4)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hysteresis_edges_match_jax_on_seeded_sequences(seed, arm, cooldown):
    """A seeded walk across both thresholds (and the band between): the
    same edges tick by tick, and at least one actuation."""
    rng = np.random.default_rng(seed)
    seq = [float(v) for v in rng.choice([0.5, 1.5, 2.0, 5.0, 10.0, 12.0], size=60)]
    got = edges(Hysteresis, seq, 10.0, 2.0, arm=arm, cooldown=cooldown)
    assert got == edges(JHysteresis, seq, 10.0, 2.0, arm=arm, cooldown=cooldown)
    assert any(e is not None for e in got[0])


def test_hysteresis_rejects_lo_above_hi():
    with pytest.raises(ValueError, match="hysteresis"):
        Hysteresis(1.0, 2.0)
    with pytest.raises(ValueError, match="hysteresis"):
        JHysteresis(1.0, 2.0)


# ---------------------------------------------------------------------------
# the controller on patched signals
# ---------------------------------------------------------------------------


def drive(p, monkeypatch, ticks, **ctrl_kw):
    """Both packages' controllers over ``ticks`` = [(depth, sla dict)]: each
    tick patches both packages' sla_values and both queues' depth to the
    tick's values and steps both controllers (``p.cur`` keeps the patched
    values for later steps).  Returns the two controllers."""
    cur = p.cur = {}
    monkeypatch.setattr(jtrace, "sla_values", lambda: dict(cur["sla"]))
    monkeypatch.setattr(rtrace, "sla_values", lambda: dict(cur["sla"]))
    for q in (p.jq, p.tq):
        q.depth = lambda: cur["depth"]
    jc, tc = JServiceController(p.jq, **ctrl_kw), ServiceController(p.tq, **ctrl_kw)
    for depth, sla in ticks:
        cur["depth"], cur["sla"] = depth, sla
        ja, ta = jc.step(), tc.step()
        assert ta == ja
    return jc, tc


def sla(p95=0.0, fail=0.0):
    """An SLA surface: one (op, class) cell's p95, and a reject rate."""
    return {"latency_p95_posv_friendly_s": p95, "latency_p50_posv_friendly_s": p95 / 2,
            "outcome_rate_served": 1.0 - fail, "outcome_rate_reject_budget": fail}


def test_controller_shrinks_window_on_latency_breach(rng, live_obs, monkeypatch):  # noqa: F811
    """A held p95 breach trips the latency latch after ``arm`` ticks: one
    shrink_window (T halved, B untouched), no flapping while it holds, and a
    release once p95 is back under 80% of the SLO."""
    ticks = [(0, sla(2.0))] * 6 + [(0, sla(0.1))] * 6
    with pair("t_ctrl", max_batch=4, window_s=0.004) as p, counter_deltas() as d:
        jc, tc = drive(p, monkeypatch, ticks, slo_p95_s=0.25, arm=2, cooldown=2,
                       failure_rate_hi=100.0, failure_rate_lo=0.0)
        assert tc.actuations == jc.actuations
        assert [a["action"] for a in tc.actuations] == ["shrink_window", "restore_window"]
        assert tc.actuations[0]["window_s"] == pytest.approx(0.002)
        assert tc.actuations[0]["batch"] == 4
        assert (p.tq.max_batch, p.tq.window_s) == (p.jq.max_batch, p.jq.window_s) == (4, 0.004)
    assert d["torch"] == d["jax"] == {"controller_actuations": 2}


def test_controller_depth_latch_widens_and_restores(rng, live_obs, monkeypatch):  # noqa: F811
    """Depth held over 2 B widens the window to (2 B, 2 T); depth held under
    B / 2 restores the baseline."""
    ticks = [(20, sla())] * 5 + [(9, sla())] * 2 + [(0, sla())] * 6
    with pair("t_depth", max_batch=4, window_s=0.005) as p, counter_deltas() as d:
        jc, tc = drive(p, monkeypatch, ticks, arm=2, cooldown=1)
        assert tc.actuations == jc.actuations
        assert [(a["action"], a["batch"], a["window_s"]) for a in tc.actuations] == [
            ("widen_window", 8, 0.01), ("restore_window", 4, 0.005)]
    assert d["torch"] == d["jax"]


def test_failure_tail_escalates_the_tier(rng, live_obs, monkeypatch):  # noqa: F811
    """A held failure tail escalates friendly operators to the hostile tier
    (the next submit is windowed under it in both packages); a clean tail
    releases it."""
    ticks = [(0, sla(fail=0.2))] * 3
    with pair("t_tier_ctrl", max_batch=8) as p:
        jc, tc = drive(p, monkeypatch, ticks, arm=2, cooldown=1)
        assert [a["action"] for a in tc.actuations] == ["escalate_tier"]
        assert p.tq.router.tier_map == p.jq.router.tier_map == {"friendly": "hostile"}
        p.submit("posv", spd_np(rng), rng.standard_normal(16))
        assert [k[1] for k in p.tq._windows] == [k[1] for k in p.jq._windows] == ["hostile"]
        p.advance(0.01)
        p.pump()
        assert p.ttk[0].trace.klass == "hostile" == p.jtk[0].trace.klass
        p.cur["sla"] = sla()
        for _ in range(3):
            for c in (jc, tc):
                c.step()
        assert tc.actuations == jc.actuations
        assert tc.actuations[-1]["action"] == "release_tier" and p.tq.router.tier_map == {}


@pytest.mark.parametrize("seed", [3, 4])
def test_controller_actuations_match_jax_on_seeded_signals(rng, live_obs, monkeypatch,  # noqa: F811
                                                          seed):
    """Every latch at once on a seeded random walk of depth, p95 and failure
    rate: the same actuation records tick by tick, the same knobs after."""
    g = np.random.default_rng(seed)
    ticks = [(int(g.choice([0, 3, 9, 20])), sla(float(g.choice([0.05, 0.22, 0.3, 2.0])),
                                                 float(g.choice([0.0, 0.01, 0.2]))))
             for _ in range(80)]
    with pair(f"t_walk{seed}", max_batch=4, window_s=0.005) as p:
        jc, tc = drive(p, monkeypatch, ticks, arm=2, cooldown=2)
        assert tc.actuations == jc.actuations and len(tc.actuations) >= 3
        assert (p.tq.max_batch, p.tq.window_s, p.tq.router.tier_map) == (
            p.jq.max_batch, p.jq.window_s, p.jq.router.tier_map)


def test_actuation_gauges_and_bus_event(rng, live_obs, monkeypatch):  # noqa: F811
    """An actuation sets the serve.queue_window_batch / _s gauges (as in
    slate_tpu's registry) and publishes its record as a controller event."""
    since = live.BUS.last_seq()
    with pair("t_gauge", max_batch=4, window_s=0.004) as p:
        _jc, tc = drive(p, monkeypatch, [(0, sla(2.0))] * 3, slo_p95_s=0.25, arm=2, cooldown=2)
        for name in ("serve.queue_window_batch", "serve.queue_window_s"):
            got = [(e["tags"], e["value"]) for e in REGISTRY.snapshot()["gauges"]
                   if e["name"] == name and e["tags"].get("queue") == "t_gauge"]
            want = [(e["tags"], e["value"]) for e in JREGISTRY.snapshot()["gauges"]
                    if e["name"] == name and e["tags"].get("queue") == "t_gauge"]
            assert got == want and got
    evs = [e for e in live.BUS.events(since=since) if e["kind"] == "controller"]
    assert [e["data"] for e in evs] == tc.actuations


def test_signals_read_the_queue_and_the_sla_surface(rng, live_obs):  # noqa: F811
    """Unpatched: the depth is the queue's, p95 the worst cell's, and the
    failure rate the sum of the non-served outcome rates."""
    with pair("t_sig", max_batch=8) as p:
        p.submit("posv", spd_np(rng), rng.standard_normal(16))
        REGISTRY.observe("serve.latency_s", 2.0, op="posv", klass="friendly", outcome="served")
        sig = ServiceController(p.tq).signals()
        assert sig["depth"] == 1.0 and sig["p95_s"] >= 2.0 and sig["failure_rate"] == 0.0
        p.tq.drain()
        p.jq.drain()
