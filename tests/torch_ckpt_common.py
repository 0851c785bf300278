"""Shared operands, meshes and comparisons of the port's checkpoint /
restart tests (tests/test_torch_ckpt*.py, tests/test_torch_elastic.py).

The shapes are tests/test_ckpt.py's: n = 64, nb = 8 (8 tile steps), a
snapshot every 3 steps (boundaries 3 and 6), ``slate_tpu`` on the 8 forced
CPU devices and the port on virtual 2 x 4 / 4 x 2 meshes on the CPU, both
fed the same numpy operands.  Within the port everything is bitwise;
against ``slate_tpu`` the factors are held to the LU / Cholesky parity
class, 100 n eps max|A| (f64), and info, pivots and snapshot metadata are
bitwise.  Both packages run with the panel lowering pinned to ``xla``
(the info-parity rule of ROADMAP.md §3) and NumMonitor off.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu.ft import ckpt as jckpt
from slate_tpu.ft import elastic as jelastic
from slate_tpu.ft import inject as jinject
from slate_tpu.ops.pallas_ops import use_panel_impl as j_use_panel_impl
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.ft import ckpt, elastic, inject
from slate_tpu_torch.ft.ckpt_smoke import result_tensors
from slate_tpu_torch.ops.kernels import use_panel_impl

N, NB = 64, 8
NT = N // NB
EVERY = 3  # boundaries 3 and 6: a kill at 4 loses exactly 1 step
EPS = float(np.finfo(np.float64).eps)
TILE_OPS = ("potrf", "getrf_nopiv", "getrf_pp")
MULTI_OPS = ("geqrf", "he2hb")

# op -> (operand kind, identity-padded diagonal, plain driver, checkpointed driver)
CASES = {
    "potrf": ("spd", True, tp.potrf_dist, ckpt.potrf_ckpt),
    "getrf_nopiv": ("dom", True, tp.getrf_nopiv_dist, ckpt.getrf_nopiv_ckpt),
    "getrf_pp": ("general", True, tp.getrf_pp_dist, ckpt.getrf_pp_ckpt),
    "geqrf": ("general", False, tp.geqrf_dist, ckpt.geqrf_ckpt),
    "he2hb": ("spd", False, tp.he2hb_dist, ckpt.he2hb_ckpt),
}


@pytest.fixture(autouse=True)
def no_ckpt_env(monkeypatch):
    """The env chain off unless a test arms it."""
    for env in (ckpt.CKPT_ENV, ckpt.CKPT_ASYNC_ENV, "SLATE_TPU_PANEL_IMPL",
                "SLATE_TPU_UPDATE_IMPL", "SLATE_TPU_BCAST_IMPL"):
        monkeypatch.delenv(env, raising=False)


def operand(kind: str, seed: int = 7) -> np.ndarray:
    """tests/test_ckpt.py's operands."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((N, N))
    if kind == "spd":
        a = a @ a.T / N + 2 * np.eye(N)
    elif kind == "dom":
        a = np.tril(a) + N * np.eye(N) + np.triu(rng.standard_normal((N, N)), 1)
    return a


def tmesh(p: int = 2, q: int = 4, devices=None):
    return tp.make_mesh(p, q, device="cpu", devices=devices)


def tdist(op: str, mesh=None, a=None):
    kind, pad, _, _ = CASES[op]
    a = operand(kind) if a is None else a
    return tp.from_dense(torch.from_numpy(a), mesh or tmesh(), NB, diag_pad_one=pad)


def jmesh(p: int = 2, q: int = 4):
    return jmake_mesh(p, q, devices=cpu_devices(8))


def jdist(op: str, mesh=None, a=None):
    kind, pad, _, _ = CASES[op]
    a = operand(kind) if a is None else a
    return jfrom_dense(jnp.asarray(a), mesh or jmesh(), NB, diag_pad_one=pad)


JCKPT = {op: getattr(jckpt, f"{op}_ckpt") for op in CASES}


def assert_bitwise(ref, got, what: str = "") -> None:
    """Every tensor of two driver results equal bit for bit, and the
    DistMatrix metadata equal."""
    lr, lg = result_tensors(ref), result_tensors(got)
    assert len(lr) == len(lg), what
    for r, g in zip(lr, lg):
        assert r.dtype == g.dtype and r.shape == g.shape, what
        assert torch.equal(r, g), what
    for r, g in zip(_dms(ref), _dms(got)):
        assert (r.m, r.n, r.nb, r.diag_pad, r.mesh) == (g.m, g.n, g.nb, g.diag_pad, g.mesh), what


def _dms(x):
    if isinstance(x, tp.DistMatrix):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _dms(v)


def kill(op: str, fn, k: int, in_segment: bool = False, persist: bool = False):
    """Run ``fn`` under one armed kill at step ``k``; its Preempted's
    checkpoint."""
    with inject.fault_scope(inject.FaultPlan([inject.KillFault(op, k, persist, in_segment)])):
        with pytest.raises(ckpt.Preempted) as ei:
            fn()
    assert ei.value.op == op and ei.value.killed_at == k
    return ei.value.checkpoint


def jkill(op: str, fn, k: int):
    with jinject.fault_scope(jinject.FaultPlan([jinject.KillFault(op, k)])):
        with pytest.raises(jckpt.Preempted) as ei:
            fn()
    return ei.value.checkpoint


def within_class(got: np.ndarray, ref: np.ndarray, scale: float) -> float:
    """max|got - ref| as a share of 100 n eps scale (<= 1 passes)."""
    return float(np.abs(np.asarray(got) - np.asarray(ref)).max()) / (100 * N * EPS * scale)


@contextlib.contextmanager
def xla_panels():
    """Both packages' panel lowering pinned to xla."""
    with use_panel_impl("xla"), j_use_panel_impl("xla"):
        yield


def meta(ck) -> tuple:
    return (ck.op, ck.step, ck.every, tuple(ck.grid), ck.nbytes, ck.m, ck.n, ck.nb)

