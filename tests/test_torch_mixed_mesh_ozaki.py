"""The port's refinement loop with the Ozaki int8 residual
(Option.ResidualImpl=ozaki) against slate_tpu's: iterations, the gate,
and the comm audit of the loop.

``slate_tpu`` records the loop's collectives once, when it traces the
``lax.while_loop`` body, at the multiplicity max_iter + 1; the port's host
loop records its first trip at that multiplicity and the others at 0, so
the per-op audited totals are equal: the int8 digit-plane broadcasts are
exactly (max_iter + 1) x ``residual_comm_bytes`` under psum, and the norm
pair's psum rides the same scope.  The ``ir.residual_gemm_bytes`` counter
scales the per-trip volume by the trips actually run.

The audit comparison uses nb = 12 (n = 96), a tile size no other test
compiles, so that this is slate_tpu's first trace of these programs
without clearing its caches.
"""

import numpy as np
import pytest
import torch

from conftest import cpu_devices

import jax.numpy as jnp
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel.comm import comm_audit as jcomm_audit
from slate_tpu.parallel.dist_refine import gesv_mixed_mesh as jgesv_mixed_mesh
from slate_tpu.types import Option as JOption
from slate_tpu_torch import parallel as tp
from slate_tpu_torch.linalg.refine import ir_counter_values
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import dist_refine as trefine
from slate_tpu_torch.parallel import summa as tsumma
from slate_tpu_torch.types import Option
from slate_tpu_torch.utils.testing import refine_gate_ok as _gate

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N, NB, NRHS, MAX_ITER = 96, 12, 2, 5


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for env in (tcomm.BCAST_IMPL_ENV, trefine.MIXED_ENV, trefine.RESIDUAL_ENV, "SLATE_TPU_NUM",
                "SLATE_TPU_PANEL_IMPL", "SLATE_TPU_UPDATE_IMPL"):
        monkeypatch.delenv(env, raising=False)
    trefine.clear_prefactor_cache()
    tsumma.clear_ozaki_split_cache()


def _t(x):
    return torch.from_numpy(np.array(x))


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


def test_ozaki_refinement_matches_the_reference_and_its_audit():
    rng = np.random.default_rng(42)
    a = rng.standard_normal((N, N)) + N * np.eye(N)
    b = rng.standard_normal((N, NRHS))
    p, q = 2, 4
    jm = jmake_mesh(p, q, devices=cpu_devices(8))
    tm = tp.make_mesh(p, q, device="cpu")
    with jcomm_audit() as jrecs:
        xj, itj, infoj = jgesv_mixed_mesh(
            jnp.asarray(a), jnp.asarray(b), jm, NB, max_iter=MAX_ITER,
            opts={JOption.ResidualImpl: "ozaki", JOption.BcastImpl: "psum",
                  JOption.PanelImpl: "xla", JOption.NumMonitor: "off"})
    ir0 = ir_counter_values()
    with tcomm.comm_audit() as trecs:
        x, it, info = tp.gesv_mixed_mesh(
            _t(a), _t(b), tm, NB, max_iter=MAX_ITER,
            opts={Option.ResidualImpl: "ozaki", Option.BcastImpl: "psum",
                  Option.PanelImpl: "xla"})
    ir1 = ir_counter_values()
    assert int(info) == int(infoj) == 0 and int(it) == int(itj) >= 0
    assert _gate(a, x.numpy(), b) and _gate(a, np.asarray(xj), b)
    assert np.abs(x.numpy() - np.asarray(xj)).max() <= 1e-12 * np.abs(np.asarray(xj)).max()
    # the whole solve's audit, per op, is slate_tpu's (factor, loop, norms)
    assert _totals(trecs) == _totals(jrecs)
    # the int8 plane payloads at the loop multiplicity
    ad = tp.from_dense(_t(a), tm, NB, diag_pad_one=True)
    bd = tp.from_dense(_t(b), tm, NB)
    mt, ntb, kt = ad.tiles.shape[0], bd.tiles.shape[1], ad.nt
    mtl, ntl = mt // p, ntb // q
    planes = (9 * mtl * NB * NB, 9 * ntl * NB * NB)
    got = sum(nb_ * m for op, nb_, m in trecs if op.startswith("psum") and nb_ in planes)
    per_trip = trefine.residual_comm_bytes(mt, ntb, kt, NB, p, q, "psum", "ozaki")
    assert got == (MAX_ITER + 1) * per_trip
    norm_bytes = 2 * mtl * NB * 8  # the stacked (2, mtl, nb) row sums
    assert (f"psum[{tcomm.COL_AXIS}]", norm_bytes, MAX_ITER + 1) in trecs
    # ir.residual_gemm_bytes counts the trips run: iters + 1
    assert ir1["residual_gemm_bytes"] - ir0["residual_gemm_bytes"] == per_trip * (int(it) + 1)
    assert ir1["iters_total"] - ir0["iters_total"] == int(it)


def test_ozaki_ladder_reuses_the_operator_planes():
    """The routed solve splits A once per operator (the plane cache keys on
    the prefactor memo's distributed A): a second solve against the same A
    is a hit."""
    from slate_tpu_torch.obs.metrics import serve_counts

    rng = np.random.default_rng(3)
    a = _t(rng.standard_normal((N, N)) + N * np.eye(N))
    tm = tp.make_mesh(2, 4, device="cpu")
    opts = {Option.ResidualImpl: "ozaki"}
    c0 = serve_counts()
    for seed in (1, 2):
        b = rng.standard_normal((N, NRHS))
        x, info = tp.gesv_mesh(a, _t(b), tm, NB, opts=opts)
        assert int(info) == 0 and _gate(a.numpy(), x.numpy(), b)
    c1 = serve_counts()
    assert c1["ozaki_presplits"] - c0["ozaki_presplits"] == 1
    assert c1["ozaki_presplit_hits"] - c0["ozaki_presplit_hits"] == 1
