"""Shared flight cases of the port's flight-recorder tests
(tests/test_torch_obs_flight*.py).

Both packages build each flight op's operands with their own
``obs.flight._build_case`` from numpy's generator (seed 0), so the
operands are the same draws.  ``slate_tpu`` runs on its 8 forced CPU
devices, the port on a virtual 2 x 4 mesh on the CPU.

- ``slate_tpu``'s schedule model is a fresh trace of the plain driver under
  ``sched_audit`` (``jax.make_jaxpr``: no compile, no ``jax.clear_caches``);
  its audit records only at trace time, so each test file flies a tile size
  no other test uses (nb = 7 and 9).
- its measured timeline is its step dispatch under ``flight_scope``;
- the port's model is the plain driver under ``sched_audit`` and its
  timeline the same driver under ``flight_scope``.

Held bitwise between the packages: the rows' (op, k, phase) issue order
and ``ScheduleModel.phase_bytes`` / ``total_bytes`` / ``phase_execs`` /
``hops_per_step``; within the port, the flown result and the plain one.
The factors agree within the f32 parity class, 100 n eps32 max|ref|.
"""

import jax
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.obs import flight as jflight
from slate_tpu.obs import schedule as jschedule
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.obs import flight, schedule
from slate_tpu_torch.parallel import comm as tcomm

IMPL = "auto"
EPS32 = float(np.finfo(np.float32).eps)
# the depths whose flights differ (the strict chains have none)
DEPTHS = {"summa": (0, 1, 2), "potrf": (0, 1, 2), "getrf_nopiv": (0, 1, 2), "trsm": (0, 1, 2),
          "geqrf": (0,), "he2hb": (0,)}


@pytest.fixture(autouse=True)
def no_obs_env(monkeypatch):
    for env in ("SLATE_TPU_OBS", flight.DEEP_ENV, "SLATE_TPU_PANEL_IMPL",
                "SLATE_TPU_UPDATE_IMPL", "SLATE_TPU_BCAST_IMPL"):
        monkeypatch.delenv(env, raising=False)


def jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def keys(rows):
    return [(r["op"], r["k"], r["phase"]) for r in rows]


def ref_flights(op: str, n: int, nb: int) -> dict:
    """``slate_tpu``'s side at every depth of DEPTHS[op]: {depth: (model,
    rows, result)}."""
    run, _verify, nt = jflight._build_case(op, n, nb, jmesh(), np.random.default_rng(0))
    out = {}
    for d in DEPTHS[op]:
        with jflight.no_flight(), jcomm.sched_audit() as recs:
            jax.make_jaxpr(lambda: run(d, IMPL))()
        model = jschedule.ScheduleModel(op, nt, 2, 4, IMPL, list(recs))
        with jflight.flight_scope() as rec:
            res = run(d, IMPL)
        out[d] = (model, jschedule.rows_from_events(rec.events), res)
    return out


def port_flights(op: str, n: int, nb: int) -> dict:
    """The port's side: {depth: (model, rows, flown result, plain result,
    recorder)}."""
    mesh = tp.make_mesh(2, 4, device="cpu")
    run, _verify, nt = flight._build_case(op, n, nb, mesh, flight._Gen("numpy", 0, mesh.device))
    out = {}
    for d in DEPTHS[op]:
        with flight.no_flight(), tcomm.sched_audit() as recs:
            plain = run(d, IMPL)
        model = schedule.ScheduleModel(op, nt, 2, 4, IMPL, list(recs))
        with flight.flight_scope() as rec:
            res = run(d, IMPL)
        out[d] = (model, schedule.rows_from_events(rec.events), res, plain, rec)
    return out


def dense_result(op: str, res, torch_side: bool) -> np.ndarray:
    """The factor a flight op's result holds, dense (numpy)."""
    to_dense = tp.to_dense if torch_side else jto_dense

    def arr(x):
        return x.numpy() if torch_side else np.asarray(x)

    if op in ("potrf", "getrf_nopiv"):
        return arr(to_dense(res[0]))
    if op == "geqrf":
        return arr(to_dense(res.fact))
    if op == "he2hb":
        return arr(to_dense(res.band))
    return arr(to_dense(res))


def hold_flights(op: str, n: int, nb: int) -> None:
    """Every rule of the module docstring for one op."""
    ref, port = ref_flights(op, n, nb), port_flights(op, n, nb)
    for d in DEPTHS[op]:
        jmodel, jrows, jres = ref[d]
        tmodel, trows, tres, tplain, rec = port[d]
        assert keys(trows) == keys(jrows), (op, d)
        assert tmodel.phase_bytes == jmodel.phase_bytes, (op, d)
        assert tmodel.total_bytes == jmodel.total_bytes
        assert tmodel.phase_execs == jmodel.phase_execs
        assert tmodel.hops_per_step() == jmodel.hops_per_step()
        assert flight.bitwise_equal(tres, tplain), (op, d)
        # the flight's measured bytes are the model's (it is the plain loop)
        assert sum(r["bytes"] for r in trows) == tmodel.total_bytes
        assert len(rec.events) == 8 * len(trows)
        got, want = dense_result(op, tres, True), dense_result(op, jres, False)
        assert np.abs(got - want).max() <= 100 * n * EPS32 * np.abs(want).max(), (op, d)
