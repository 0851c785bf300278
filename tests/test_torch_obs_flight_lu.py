"""The port's flight recorder against ``slate_tpu``'s: getrf_nopiv, geqrf
and he2hb (tests/torch_obs_common.py holds the rules), at n = 72, nb = 9
(8 tile steps, a tile size no other test traces).  The strict chains
(geqrf, he2hb) have no lookahead: their rows are the depth-0 order at
every depth, and the overlap lens reads 0.
"""

import pytest
import torch

from torch_obs_common import hold_flights, jflight, keys, no_obs_env  # noqa: F401

from slate_tpu_torch.obs import flight, schedule

torch.set_num_threads(1)

N, NB = 72, 9


@pytest.mark.parametrize("op", ["getrf_nopiv", "geqrf", "he2hb"])
def test_flight_matches_slate_tpu(op):
    hold_flights(op, N, NB)


@pytest.mark.parametrize("op", ["geqrf", "he2hb"])
def test_strict_chains_ignore_the_depth(op):
    reps = [flight.run_flight(op, n=N, nb=NB, depth=d, device="cpu") for d in (0, 2)]
    assert [r["config"]["lookahead"] for r in reps] == [0, 0]
    for rep in reps:
        assert rep["bitwise_plain"]
        assert rep["sched"]["overlap_eff"] == rep["sched"]["overlap_eff_la0"] == 0.0
        assert flight.validate_flight_report(rep) == jflight.validate_flight_report(rep) == []
    rows = [keys(schedule.rows_from_events([flight.StepEvent(
        e["op"], e["k"], e["phase"], tuple(e["device"]), e["t0_s"], e["t1_s"], e["bytes"],
        e["flops"]) for e in r["events"]])) for r in reps]
    assert rows[0] == rows[1]


def test_geqrf_tall_case():
    rep = flight.run_flight("geqrf", n=36, nb=NB, m=72, device="cpu")
    assert rep["config"]["m"] == 72 and rep["bitwise_plain"]
    assert rep["values"]["resid"] < 1e-4
    with pytest.raises(ValueError):
        flight.run_flight("potrf", n=36, nb=NB, m=72, device="cpu")
