"""The port's mixed-precision SPD mesh solve against slate_tpu's: f64
``posv_mesh`` under the default ``auto`` ladder, plain and under
Option.FaultTolerance (the ladder's f32 factor is then the ABFT
``potrf_ft`` in both packages).

n = 96, nb = 16, two right-hand sides on the 2 x 4 mesh; PanelImpl pinned
``xla`` and NumMonitor ``off`` on the slate_tpu side, PanelImpl ``xla`` on
the port's (ROADMAP §3).  Bitwise: info, ``iters`` and the ``ir.*`` /
``ft.*`` decisions; x within the refinement gate in both, and the two x
within 1e-12 relative of each other.
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
from slate_tpu_torch.ft import abft
from slate_tpu_torch.ft.policy import ft_counter_values
from slate_tpu_torch.linalg.refine import ir_counter_values
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_refine as trefine
from slate_tpu_torch.types import Option
from slate_tpu_torch.utils.testing import refine_gate_ok as _gate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N, NB, NRHS = 96, 16, 2
J_OPTS = {JOption.PanelImpl: "xla", JOption.NumMonitor: "off"}
T_OPTS = {Option.PanelImpl: "xla"}


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV, trefine.MIXED_ENV,
                trefine.RESIDUAL_ENV, "SLATE_TPU_NUM"):
        monkeypatch.delenv(env, raising=False)
    trefine.clear_prefactor_cache()


def _t(x):
    return torch.from_numpy(np.array(x))


def _operands(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((N, N))
    return g @ g.T / N + 2 * np.eye(N), rng.standard_normal((N, NRHS))


def _jcount(name):
    return JREGISTRY.counter_value(name, op="posv")


def test_auto_posv_matches_the_reference():
    a, b = _operands(42)
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    tm = tp.make_mesh(2, 4, device="cpu")
    xj, itj, infoj = jdrv.posv_mixed_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB, opts=J_OPTS)
    j0 = {k: _jcount(k) for k in ("ir.solves", "ir.converged", "ir.escalated_gmres")}
    xjr, _ = jdrv.posv_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB, opts=J_OPTS)
    jd = {k: _jcount(k) - v for k, v in j0.items()}
    t0 = ir_counter_values()
    x, info = tp.posv_mesh(_t(a), _t(b), tm, NB, opts=T_OPTS)
    t1 = ir_counter_values()
    assert jd == {"ir.solves": t1["solves"] - t0["solves"],
                  "ir.converged": t1["converged"] - t0["converged"],
                  "ir.escalated_gmres": t1["escalated_gmres"] - t0["escalated_gmres"]}
    x2, it, info2 = tp.posv_mixed_mesh(_t(a), _t(b), tm, NB, opts=T_OPTS)
    assert torch.equal(x, x2)
    assert int(it) == int(itj) >= 0 and int(info) == int(info2) == int(infoj) == 0
    # iters_total moved by the same count in both packages
    assert t1["iters_total"] - t0["iters_total"] == int(itj)
    assert _gate(a, x.numpy(), b) and _gate(a, np.asarray(xjr), b)
    assert np.abs(x.numpy() - np.asarray(xjr)).max() <= 1e-12 * np.abs(np.asarray(xjr)).max()


@pytest.mark.parametrize("policy", ["detect", "correct"])
def test_fault_tolerant_posv_routes_the_ladder_in_both_packages(policy, monkeypatch):
    """f64 posv_mesh under FaultTolerance: the ladder's f32 factor is the
    ABFT potrf_ft, then the same refinement; clean runs record no fault."""
    a, b = _operands(7)
    jm = jmake_mesh(2, 4, devices=cpu_devices(8))
    tm = tp.make_mesh(2, 4, device="cpu")
    jopts = {**J_OPTS, JOption.FaultTolerance: policy}
    topts = {**T_OPTS, Option.FaultTolerance: policy}
    factors = []
    real = abft.potrf_ft
    monkeypatch.setattr(abft, "potrf_ft", lambda a_, *r, **k: factors.append(a_.dtype) or real(a_, *r, **k))
    j0 = _jcount("ir.solves")
    xj, infoj = jdrv.posv_mesh(jnp.asarray(a), jnp.asarray(b), jm, NB, opts=jopts)
    t0, f0 = ir_counter_values(), ft_counter_values()
    x, info = tp.posv_mesh(_t(a), _t(b), tm, NB, opts=topts)
    t1, f1 = ir_counter_values(), ft_counter_values()
    assert _jcount("ir.solves") - j0 == t1["solves"] - t0["solves"] == 1
    assert t1["fallback"] == t0["fallback"] and t1["converged"] - t0["converged"] == 1
    assert factors == [torch.float32]  # the ladder's one factor, checksummed
    assert f1 == f0  # a clean run: no detection, correction or recompute
    assert int(info) == int(infoj) == 0
    assert _gate(a, x.numpy(), b) and _gate(a, np.asarray(xj), b)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-12 * np.abs(np.asarray(xj)).max()
