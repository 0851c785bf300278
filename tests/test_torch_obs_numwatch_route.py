"""The mixed ladder's health tier (Option.NumMonitor=on) on numwatch's
cond-1e8 input (``generate("svd", 48, seed=7, cond=1e8)``), against
slate_tpu's routing inputs on the same numpy operand.  The f32 factors of
this operand take different pivot sequences in the two packages (a
near-tie rounds apart), so their gauges are held to their order and the
routing decision exactly.

The port's f64 ``gesv_mesh`` enters at GMRES-IR (``num.routed_gmres`` +1),
runs no IR solve (``ir.solves`` unchanged) and counts no escalation; at
cond 1e8 that tier does not converge and the f64 fallback solves, as in
slate_tpu (ROADMAP §3).  The decision's inputs against slate_tpu's: the
monitored f32 partial-pivot factor's max|A| exactly and its growth within
2x, both condition estimates past CONDEST_THRESHOLD, and
``route_entry_tier`` deciding the same on each package's inputs.  A healthy input (numwatch's ``dominant``)
takes the IR tier with its trajectory recorded.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.obs import numerics as jnum
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel.dist_aux import gecondest_dist as jgecondest
from slate_tpu.parallel.dist_aux import norm_dist as jnorm
from slate_tpu.parallel.dist_lu import getrf_pp_dist as jpp
from slate_tpu.types import Norm as JNorm
from slate_tpu.utils.testing import generate
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.linalg import refine
from slate_tpu_torch.obs import numerics as tnum
from slate_tpu_torch.types import Norm, Option

torch.set_num_threads(1)

N, NB = 48, 8


@pytest.fixture(scope="module", autouse=True)
def _x64_and_release():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in ("SLATE_TPU_OBS", tnum.NUM_ENV, "SLATE_TPU_MIXED"):
        monkeypatch.delenv(env, raising=False)
    tnum.reset()
    jnum.reset()


def test_cond_1e8_ladder_routes_to_gmres_as_slate_tpu():
    ill = generate("svd", N, seed=7, cond=1e8)
    b = np.random.default_rng(6).standard_normal((N, 2))
    # slate_tpu's routing inputs: the monitored f32 factor and its condest
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    jlu, jperm, _ = jpp(jfrom_dense(jnp.asarray(ill, jnp.float32), jm, NB, diag_pad_one=True),
                        num_monitor="on")
    jg = jnum.last_gauges("getrf_pp")
    jrc = float(jgecondest(jlu, jperm, jnorm(JNorm.One, jfrom_dense(jnp.asarray(ill), jm, NB,
                                                                     diag_pad_one=True))))
    # the port's inputs on the same f32 factor
    tm = tp.make_mesh(2, 4, device="cpu")
    tlu, tperm, _ = tp.getrf_pp_dist(tp.from_dense(torch.from_numpy(ill).float(), tm, NB,
                                                   diag_pad_one=True), num_monitor="on")
    tg = tnum.last_gauges("getrf_pp")
    trc = float(tp.gecondest_dist(tlu, tperm, tp.norm_dist(
        Norm.One, tp.from_dense(torch.from_numpy(ill), tm, NB, diag_pad_one=True))))
    # the port's ladder, end to end
    ir0, num0 = refine.ir_counter_values(), tnum.num_counter_values()
    x, info = tp.gesv_mesh(torch.from_numpy(ill), torch.from_numpy(b), tm, NB,
                           opts={Option.NumMonitor: "on"})
    d = {k: v - ir0[k] for k, v in refine.ir_counter_values().items() if v != ir0[k]}
    assert int(info) == 0
    assert tnum.num_counter_values()["routed_gmres"] - num0["routed_gmres"] == 1
    assert d == {"gmres_solves": 1.0, "fallback": 1.0}, d  # no IR solve, no escalation
    # max|A| of the same f32 operand exactly; the working values are not
    # comparable entry by entry (the two factors' pivot sequences part at a
    # near-tie of this cond-1e8 f32 factor), so the running max is held
    # only to its order (within 2x) and the decision exactly
    assert tg["amax"] == jg["amax"]
    assert 0.5 <= tg["growth"] / jg["growth"] <= 2.0, (tg, jg)
    assert 1 / trc > tnum.CONDEST_THRESHOLD and 1 / jrc > jnum.CONDEST_THRESHOLD
    assert tnum.route_entry_tier("gesv", tg, trc) == jnum.route_entry_tier("gesv", jg, jrc) is True
    r = b - ill @ x.numpy()
    assert np.abs(r).max() <= 1e-12 * np.abs(ill).sum(1).max() * np.abs(x.numpy()).max()


def test_healthy_input_stays_on_ir_with_its_trajectory():
    a = generate("dominant", N, seed=8)
    b = np.random.default_rng(6).standard_normal((N, 2))
    ir0 = refine.ir_counter_values()
    with tnum.use_num_monitor("on"):
        x, info = tp.gesv_mesh(torch.from_numpy(a), torch.from_numpy(b),
                               tp.make_mesh(2, 4, device="cpu"), NB)
    d = {k: v - ir0[k] for k, v in refine.ir_counter_values().items() if v != ir0[k]}
    assert int(info) == 0 and d.get("solves") == 1 and d.get("converged") == 1
    assert tnum.num_counter_values()["routed_gmres"] == 0
    hist = tnum.last_history("gesv")
    assert len(hist) >= 2 and hist[-1][0] < hist[0][0]
