"""The port's flight recorder against ``slate_tpu``'s: summa, potrf and
trsm (tests/torch_obs_common.py holds the rules).

Each op flies n = 56, nb = 7 (8 tile steps on the 2 x 4 mesh, a tile size
no other test traces) at lookahead 0, 1 and 2; the issue order, the
schedule model and the factors are held against ``slate_tpu``, the flown
result bitwise against the port's plain driver.  Also: the potrf flight's
closed-form flops sum to n^3 / 3, the rows of a bucketed loop keep
``slate_tpu``'s unbucketed order, the prologue broadcasts carry
``slate_tpu``'s concrete hop pairs, and the FlightReport passes both
validators.
"""

import numpy as np
import pytest
import torch

from torch_obs_common import hold_flights, jflight, jcomm, jmesh, keys, no_obs_env  # noqa: F401

from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import flight, schedule
from slate_tpu_torch.parallel import comm as tcomm

torch.set_num_threads(1)

N, NB = 56, 7


@pytest.mark.parametrize("op", ["summa", "potrf", "trsm"])
def test_flight_matches_slate_tpu(op):
    hold_flights(op, N, NB)


def test_potrf_flops_sum_to_n_cubed_over_three():
    rep = flight.run_flight("potrf", n=N, nb=NB, depth=1, device="cpu")
    assert sum(e["flops"] for e in rep["events"]) == pytest.approx(N ** 3 / 3, rel=1e-12)
    # padding: n = 52 runs on the same 8 x 7 tiles, the flops on the padded size
    rep = flight.run_flight("potrf", n=52, nb=NB, depth=1, device="cpu")
    assert sum(e["flops"] for e in rep["events"]) == pytest.approx(N ** 3 / 3, rel=1e-12)
    assert abs(N ** 3 / 52 ** 3 - 1) < 3 * NB / 52  # the padding's share


def test_lu_and_summa_flops_closed_forms():
    rep = flight.run_flight("getrf_nopiv", n=N, nb=NB, depth=1, device="cpu")
    assert sum(e["flops"] for e in rep["events"]) == pytest.approx(2 * N ** 3 / 3, rel=1e-12)
    rep = flight.run_flight("summa", n=N, nb=NB, depth=2, device="cpu")
    assert sum(e["flops"] for e in rep["events"]) == pytest.approx(2 * N ** 3, rel=1e-12)
    rep = flight.run_flight("trsm", n=N, nb=NB, depth=0, device="cpu")
    assert sum(e["flops"] for e in rep["events"]) == pytest.approx(N ** 3, rel=1e-12)


def test_bucket_boundaries_merge_into_slate_tpu_rows():
    # 4 buckets of 2 steps: the drain of step 1 and the zero-payload narrow
    # of step 2 are one (1, bulk) row, the zero-payload bulk another
    mesh = tp.make_mesh(2, 4, device="cpu")
    run, _, nt = flight._build_case("potrf", N, NB, mesh, flight._Gen("numpy", 0, "cpu"))
    assert [b[:2] for b in tcomm.bucket_plan(nt, 2, 4)] == [(0, 2), (2, 4), (4, 6), (6, 8)]
    with flight.flight_scope() as rec:
        run(1, "auto")
    rows = keys(schedule.rows_from_events(rec.events))
    want = [("potrf", 0, "panel"), ("potrf", 0, "bcast")]
    for k in range(1, nt):
        want += [("potrf", k - 1, "bulk"), ("potrf", k, "panel"), ("potrf", k, "bcast"),
                 ("potrf", k - 1, "bulk")]
    want.append(("potrf", nt - 1, "bulk"))
    assert rows == want
    assert rec.runs == [{"op": "potrf", "grid": (2, 4), "nt": nt, "depth": 1, "impl": "auto"}]


@pytest.mark.parametrize("op", ["summa", "trsm"])
def test_prologue_records_carry_the_concrete_pairs(op):
    # slate_tpu's prologue fetches run with a concrete k: their records carry
    # the step and the owner's own pairs, as every port record does
    import jax

    run_j, _, _ = jflight._build_case(op, N, 9 if op == "summa" else NB, jmesh(),
                                      np.random.default_rng(0))
    with jflight.no_flight(), jcomm.sched_audit() as jrecs:
        jax.make_jaxpr(lambda: run_j(2, "ring"))()
    mesh = tp.make_mesh(2, 4, device="cpu")
    run_t, _, _ = flight._build_case(op, N, 9 if op == "summa" else NB, mesh,
                                     flight._Gen("numpy", 0, "cpu"))
    with flight.no_flight(), tcomm.sched_audit() as trecs:
        run_t(2, "ring")
    pro_j = [r for r in jrecs if r[4] is not None]
    assert pro_j and {r[4] for r in pro_j} == {0, 1}
    pro_t = [r for r in trecs if r[4] in (0, 1) and r[3] == "bcast"]
    assert pro_t == pro_j


def test_flight_report_passes_both_validators():
    rep = flight.run_flight("trsm", n=N, nb=NB, depth=1, device="cpu", hops=True)
    assert flight.validate_flight_report(rep) == []
    assert jflight.validate_flight_report(rep) == []
    assert rep["bitwise_plain"] and rep["model"]["note"] == "exact"
    assert rep["sched"]["overlap_eff_la0"] == 0.0 and 0.0 < rep["sched"]["overlap_eff"] <= 1.0
    assert "hop_latency_s" in rep["sched"]
    bad = dict(rep, events=[dict(rep["events"][0], phase="update")])
    assert flight.validate_flight_report(bad) == jflight.validate_flight_report(bad) != []
