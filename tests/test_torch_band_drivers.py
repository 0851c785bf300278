"""The port's mesh band drivers pbsv_mesh and tbsm_mesh against
slate_tpu.parallel (gbsv_mesh: test_torch_band_drivers_lu.py).

The same seeded numpy operands go through ``slate_tpu``'s drivers on the 8
forced CPU devices of conftest.py (a 2 x 4 mesh) and through the port's on
a virtual 2 x 4 mesh on the CPU, at n = 64 and a padded n = 60, nb = 8,
bands narrower than a tile and wider than two.

Bitwise: info codes, and the audited comm bytes per op of each whole
driver (on tile sizes no other test traces: ``slate_tpu`` records each
jitted stage at its first trace).  Stated tolerances: the solutions by
their difference's image, max|A (X - X_ref)| <= C_SOLVE n eps max|A|
max|X| (c = 1: both solves are backward stable; random general bands are
not well conditioned, so X - X_ref itself is no yardstick), and both under
the backward-error gate eta < 100 n eps.  Option.Checkpoint and
Option.NumMonitor ``on`` is ignored in pbsv_mesh (the same bits as off, no gauge,
as slate_tpu's band drivers).
"""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import parallel as jp
from slate_tpu import types as jt
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import drivers as jdrv
from slate_tpu_torch import parallel as tp
from slate_tpu_torch import types as tt
from slate_tpu_torch.obs import numerics as tnum
from slate_tpu_torch.parallel import comm as tcomm

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop the module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that keeps them for the whole
    run can reach the per-process map limit (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()


NB = 8
C_SOLVE = 1.0


def _jmesh():
    return jp.make_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return tp.make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _project(a, kl, ku):
    i, j = np.indices(a.shape)
    return np.where((i - j <= kl) & (j - i <= ku), a, 0).astype(a.dtype)


def _spd_band(n, kd, dtype, seed):
    g = _rand((n, n), dtype, seed)
    return _project(g @ g.conj().T + n * np.eye(n), kd, kd).astype(dtype)


def _eta(a, x, b):
    n = a.shape[0]
    return np.abs(a @ x - b).max() / (np.abs(a).max() * np.abs(x).max() * n + np.abs(b).max())


def _solves_agree(a, x, x_ref):
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    d = a.astype(wide) @ (np.asarray(x).astype(wide) - np.asarray(x_ref).astype(wide))
    n = a.shape[0]
    return np.abs(d).max() <= C_SOLVE * n * _eps(a.dtype) * np.abs(a).max() * np.abs(x_ref).max()


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


@pytest.mark.parametrize("n,kd,dtype", [(64, 3, "float64"), (60, 18, "float64"),
                                        (64, 16, "float32")])
def test_pbsv_mesh_matches_jax(n, kd, dtype):
    a = _spd_band(n, kd, dtype, n + kd)
    b = _rand((n, 3), dtype, n)
    x_ref, info_ref = jdrv.pbsv_mesh(jnp.asarray(a), jnp.asarray(b), kd, _jmesh(), NB,
                                     opts={jt.Option.BcastImpl: "psum"})
    x, info = tp.pbsv_mesh(_t(a), _t(b), kd, _tmesh(), NB)
    assert int(info) == int(info_ref) == 0
    assert x.shape == (n, 3)
    assert _solves_agree(a, x.numpy(), x_ref)
    for res in (np.asarray(x_ref), x.numpy()):
        assert _eta(a.astype(np.float64), res.astype(np.float64), b) < 100 * n * _eps(dtype)


@pytest.mark.parametrize("uplo,diag,with_perm", [("Lower", "NonUnit", False), ("Lower", "Unit", True),
                                                 ("Upper", "NonUnit", True)])
def test_tbsm_mesh_matches_jax(uplo, diag, with_perm):
    n, kd = 60, 10
    kl, ku = (kd, 0) if uplo == "Lower" else (0, kd)
    a = _project(_rand((n, n), np.float64, 5), kl, ku) + 8 * np.eye(n)
    b = _rand((n, 4), np.float64, 6)
    perm = None
    if with_perm:  # a permutation of the padded row space (64 rows); pad rows fixed
        perm = np.arange(64)
        perm[:n] = np.random.default_rng(8).permutation(n)
    ref = jdrv.tbsm_mesh(jnp.asarray(a), kd, jnp.asarray(b), _jmesh(), NB, jt.Uplo[uplo],
                         jt.Diag[diag], None if perm is None else jnp.asarray(perm))
    got = tp.tbsm_mesh(_t(a), kd, _t(b), _tmesh(), NB, tt.Uplo[uplo], tt.Diag[diag],
                       None if perm is None else _t(perm))
    eff = _project(a, kl, ku)
    if diag == "Unit":
        np.fill_diagonal(eff, 1)
    assert _solves_agree(eff, got.numpy(), ref)
    pb = b if perm is None else b[perm[:n]]
    assert _eta(eff, got.numpy(), pb) < 100 * n * _eps(np.float64)


@pytest.mark.parametrize("driver,nb,n", [("pbsv", 9, 50), ("tbsm", 11, 70)])
def test_band_driver_audit_bytes_match_jax(driver, nb, n):
    """The whole driver's audited bytes per op, on shapes no other test
    traces."""
    kd = 12
    a = _spd_band(n, kd, "float64", 23)
    b = _rand((n, 2), np.float64, 24)
    jm, tm = _jmesh(), _tmesh()
    mglob = jp.from_dense(jnp.asarray(b), jm, nb).mt * nb
    perm = np.arange(mglob)[::-1].copy()
    with jcomm.comm_audit() as jrec:
        if driver == "pbsv":
            jdrv.pbsv_mesh(jnp.asarray(a), jnp.asarray(b), kd, jm, nb,
                           opts={jt.Option.BcastImpl: "ring"})
        else:
            jdrv.tbsm_mesh(jnp.asarray(np.tril(a)), kd, jnp.asarray(b), jm, nb,
                           perm=jnp.asarray(perm))
    with tcomm.comm_audit() as trec:
        if driver == "pbsv":
            tp.pbsv_mesh(_t(a), _t(b), kd, tm, nb, opts={tt.Option.BcastImpl: "ring"})
        else:
            tp.tbsm_mesh(_t(np.tril(a)), kd, _t(b), tm, nb, perm=_t(perm))
    want = _totals(jrec)
    assert want and _totals(trec) == want


@pytest.mark.parametrize("opt,value", [("Checkpoint", 2), ("NumMonitor", "on")])
def test_pbsv_mesh_raises_on_unported_options(opt, value):
    a = _spd_band(64, 3, "float64", 1)
    if opt == "Checkpoint":
        with pytest.raises(NotImplementedError, match=opt):
            tp.pbsv_mesh(_t(a), _t(a[:, :2]), 3, _tmesh(), NB, opts={tt.Option[opt]: value})
        return
    # Option.NumMonitor is ignored, as slate_tpu's band drivers ignore it:
    # the same bits as off, and no gauge recorded
    tnum.reset()
    x_off, info_off = tp.pbsv_mesh(_t(a), _t(a[:, :2]), 3, _tmesh(), NB)
    x_on, info_on = tp.pbsv_mesh(_t(a), _t(a[:, :2]), 3, _tmesh(), NB, opts={tt.Option[opt]: value})
    assert torch.equal(x_on, x_off) and int(info_on) == int(info_off) == 0
    assert tnum.num_counter_values()["monitored"] == 0
