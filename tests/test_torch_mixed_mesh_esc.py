"""The port's escalation ladder (IR -> GMRES-IR -> the full-f64 fallback)
and its distributed GMRES-IR against slate_tpu's.

An f64 system of condition 1e12 (n = 96, nb = 16, two right-hand sides, the
2 x 4 mesh) is beyond the f32 factor: IR alone reports iters -1 in both
packages, and the routed gesv_mesh walks the whole ladder with equal
``ir.escalated_gmres``, ``ir.fallback``, ``ir.solves`` and
``ir.gmres_solves`` deltas, returning the direct f64 solve (bitwise the
port's ``_gesv_mesh_plain``).  GMRES-IR on a well-conditioned system meets
its own tolerance ||M^-1 (b - A x)|| <= eps sqrt(n) ||b|| in both; a
``gmres``-pinned solve is a requested tier, not an escalation.

Option.MaxIterations = 4 bounds both the IR trips and the GMRES restarts
(30 by default), so each ladder runs 5 trips and 5 cycles: slate_tpu
compiles the same programs, and the file stays inside its time.
PanelImpl ``xla`` and NumMonitor ``off`` are pinned on the slate_tpu side.
"""

import numpy as np
import pytest
import torch

from conftest import cpu_devices

import jax.numpy as jnp
from slate_tpu.obs import REGISTRY as JREGISTRY
from slate_tpu.parallel import drivers as jdrv
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.types import Option as JOption
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.linalg.refine import ir_counter_values
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_refine as trefine
from slate_tpu_torch.parallel import drivers as tdrv
from slate_tpu_torch.types import Option
from slate_tpu_torch.utils.testing import refine_gate_ok as _gate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N, NB, NRHS = 96, 16, 2
J_OPTS = {JOption.PanelImpl: "xla", JOption.NumMonitor: "off", JOption.MaxIterations: 4}
T_OPTS = {Option.PanelImpl: "xla", Option.MaxIterations: 4}
COUNTERS = ("solves", "converged", "escalated_gmres", "fallback", "gmres_solves")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env in (tcomm.BCAST_IMPL_ENV, trefine.MIXED_ENV, trefine.RESIDUAL_ENV, "SLATE_TPU_NUM",
                "SLATE_TPU_PANEL_IMPL", "SLATE_TPU_UPDATE_IMPL"):
        monkeypatch.delenv(env, raising=False)
    trefine.clear_prefactor_cache()


def _t(x):
    return torch.from_numpy(np.array(x))


def _jcounts():
    return {k: JREGISTRY.counter_value(f"ir.{k}", op="gesv") for k in COUNTERS}


def _tcounts():
    vals = ir_counter_values()
    return {k: vals[k] for k in COUNTERS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in COUNTERS}


def test_escalation_ladder_matches_the_reference():
    rng = np.random.default_rng(42)
    q1, _ = np.linalg.qr(rng.standard_normal((N, N)))
    q2, _ = np.linalg.qr(rng.standard_normal((N, N)))
    a = q1 @ np.diag(np.logspace(0, -12, N)) @ q2
    b = rng.standard_normal((N, NRHS))
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    tm = tp.make_mesh(2, 4, device="cpu")
    # tier 1 alone reports non-convergence in both
    _x, itj, infoj = jdrv.gesv_mixed_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB, opts=J_OPTS)
    _x, it, info = tp.gesv_mixed_mesh(_t(a), _t(b), tm, NB, opts=T_OPTS)
    assert int(it) == int(itj) == -1 and int(info) == int(infoj) == 0
    j0, t0 = _jcounts(), _tcounts()
    xj, infoj = jdrv.gesv_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB, opts=J_OPTS)
    x, info = tp.gesv_mesh(_t(a), _t(b), tm, NB, opts=T_OPTS)
    dj, dt = _delta(_jcounts(), j0), _delta(_tcounts(), t0)
    assert dt == dj
    assert dt["escalated_gmres"] == 1 and dt["fallback"] == 1 and dt["converged"] == 0
    assert int(info) == int(infoj) == 0
    # the fallback tier is the direct f64 solve
    xf, _ = tdrv._gesv_mesh_plain(_t(a), _t(b), tm, NB, opts=T_OPTS)
    assert torch.equal(x, xf)
    assert _gate(a, x.numpy(), b) and _gate(a, np.asarray(xj), b)


def test_gmres_tier_matches_the_reference():
    rng = np.random.default_rng(43)
    a = rng.standard_normal((N, N)) + N * np.eye(N)
    b = rng.standard_normal((N, NRHS))
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    tm = tp.make_mesh(2, 4, device="cpu")
    xj, rj, infoj = jdrv.gesv_mixed_gmres_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB,
                                               opts=J_OPTS)
    g0 = _tcounts()["gmres_solves"]
    x, r, info = tp.gesv_mixed_gmres_mesh(_t(a), _t(b), tm, NB, opts=T_OPTS)
    assert _tcounts()["gmres_solves"] == g0 + 1
    tol = np.finfo(np.float64).eps * np.sqrt(N) * np.linalg.norm(b, axis=0).max()
    assert int(info) == int(infoj) == 0
    assert float(r) <= tol and float(rj) <= tol
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-12 * np.abs(np.asarray(xj)).max()
    res = b - a @ x.numpy()
    assert np.abs(res).max() / (np.abs(a).sum(axis=1).max() * np.abs(x.numpy()).max()) < 1e-11
    # a gmres-pinned solve is the requested tier, not an escalation
    pin = {Option.MixedPrecision: "gmres"}
    j0, t0 = _jcounts(), _tcounts()
    xgj, _ = jdrv.gesv_mesh(jnp.asarray(a), jnp.asarray(b[:, :1]), jm, NB,
                            opts={**J_OPTS, JOption.MixedPrecision: "gmres"})
    xg, info = tp.gesv_mesh(_t(a), _t(b[:, :1]), tm, NB, opts={**T_OPTS, **pin})
    assert int(info) == 0
    assert np.abs(xg.numpy() - np.asarray(xgj)).max() <= 1e-12 * np.abs(np.asarray(xgj)).max()
    dj, dt = _delta(_jcounts(), j0), _delta(_tcounts(), t0)
    assert dt == dj and dt["escalated_gmres"] == 0 and dt["gmres_solves"] == 1
