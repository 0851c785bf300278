"""The port's mesh band LU solve (slate_tpu_torch.parallel.gbsv_mesh)
against slate_tpu.parallel.

The same seeded numpy operands go through ``slate_tpu``'s drivers on the 8
forced CPU devices of conftest.py (a 2 x 4 mesh) and through the port's on
a virtual 2 x 4 mesh on the CPU, at n = 64 and a padded n = 60, nb = 8,
bands narrower than a tile and of two tiles, in f32, f64 and complex128.

Bitwise: info codes, and the audited comm bytes per op of each whole
driver (on tile sizes no other test traces: ``slate_tpu`` records each
jitted stage at its first trace).  Stated tolerances: the solutions by
their difference's image, max|A (X - X_ref)| <= C_SOLVE n eps max|A|
max|X| (c = 1: both solves are backward stable; random general bands are
not well conditioned, so X - X_ref itself is no yardstick), and both under
the backward-error gate eta < 100 n eps.  Option.Checkpoint raises;
Option.NumMonitor ``on`` is ignored (the same bits as off, no gauge), as
slate_tpu's band drivers ignore it.  At n = 128 the windows are narrower than
the grid, where slate_tpu's factor keeps stale multipliers
(test_torch_band_mesh_lu.py): there the port's solve passes the gate and
slate_tpu's does not.
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


@pytest.mark.parametrize("n,kl,ku,dtype", [(60, 16, 16, "float64"), (64, 3, 11, "float32"),
                                           (64, 5, 2, "complex128")])
def test_gbsv_mesh_matches_jax(n, kl, ku, dtype):
    a = _project(_rand((n, n), dtype, 3 * n + kl), kl, ku)
    b = _rand((n, 2), dtype, n + 1)
    x_ref, info_ref = jdrv.gbsv_mesh(jnp.asarray(a), jnp.asarray(b), kl, ku, _jmesh(), NB,
                                     opts={jt.Option.BcastImpl: "psum"})
    x, info = tp.gbsv_mesh(_t(a), _t(b), kl, ku, _tmesh(), NB)
    assert int(info) == int(info_ref) == 0
    assert _solves_agree(a, x.numpy(), x_ref)
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    for res in (np.asarray(x_ref), x.numpy()):
        assert _eta(a.astype(wide), res.astype(wide), b) < 100 * n * _eps(dtype)


def test_gbsv_mesh_audit_bytes_match_jax():
    """The whole driver's audited bytes per op (nb = 13: a tile size no
    other test traces)."""
    nb, n, kl, ku = 13, 78, 12, 5
    a = _project(_rand((n, n), np.float64, 23), kl, ku)
    b = _rand((n, 2), np.float64, 24)
    with jcomm.comm_audit() as jrec:
        jdrv.gbsv_mesh(jnp.asarray(a), jnp.asarray(b), kl, ku, _jmesh(), nb,
                       opts={jt.Option.BcastImpl: "doubling"})
    with tcomm.comm_audit() as trec:
        tp.gbsv_mesh(_t(a), _t(b), kl, ku, _tmesh(), nb, opts={tt.Option.BcastImpl: "doubling"})
    want = _totals(jrec)
    assert want and _totals(trec) == want


@pytest.mark.parametrize("opt,value", [("Checkpoint", 2), ("NumMonitor", "on")])
def test_gbsv_mesh_raises_on_unported_options(opt, value):
    a = _project(_rand((64, 64), np.float64, 1), 3, 3)
    if opt == "Checkpoint":
        with pytest.raises(NotImplementedError, match=opt):
            tp.gbsv_mesh(_t(a), _t(a[:, :2]), 3, 3, _tmesh(), NB, opts={tt.Option[opt]: value})
        return
    # Option.NumMonitor is ignored, as slate_tpu's band drivers ignore it:
    # the same bits as off, and no gauge recorded
    tnum.reset()
    x_off, info_off = tp.gbsv_mesh(_t(a), _t(a[:, :2]), 3, 3, _tmesh(), NB)
    x_on, info_on = tp.gbsv_mesh(_t(a), _t(a[:, :2]), 3, 3, _tmesh(), NB, opts={tt.Option[opt]: value})
    assert torch.equal(x_on, x_off) and int(info_on) == int(info_off) == 0
    assert tnum.num_counter_values()["monitored"] == 0


def test_gbsv_mesh_narrow_windows_solve():
    """n = 128, nb = 8 (16 tiles: windows narrower than the grid): the
    port's solve passes the gate; slate_tpu's, whose factor keeps stale
    multipliers there (test_torch_band_mesh_lu.py), does not."""
    n, kl, ku = 128, 2, 2
    a = _project(_rand((n, n), np.float64, 77), kl, ku)
    b = _rand((n, 2), np.float64, 78)
    x_ref, info_ref = jdrv.gbsv_mesh(jnp.asarray(a), jnp.asarray(b), kl, ku, _jmesh(), NB,
                                     opts={jt.Option.BcastImpl: "psum"})
    x, info = tp.gbsv_mesh(_t(a), _t(b), kl, ku, _tmesh(), NB)
    assert int(info) == int(info_ref) == 0
    gate = 100 * n * _eps(np.float64)
    assert _eta(a, x.numpy(), b) < gate
    assert _eta(a, np.asarray(x_ref), b) > gate
