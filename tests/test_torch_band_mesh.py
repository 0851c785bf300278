"""The port's mesh band Cholesky (slate_tpu_torch.parallel.pbtrf_band_dist)
against slate_tpu.parallel (the band drivers: test_torch_band_drivers.py).

The same seeded numpy operands go through ``slate_tpu`` on the 8 forced CPU
devices of conftest.py (a 2 x 4 mesh) and through the port on a virtual
2 x 4 mesh on the CPU: n = 64 and a padded n = 60, nb = 8, with bands
narrower than a tile (kd = 3), of two tiles (kd = 16 = 2 nb) and wider
(kd = 18), in f32, f64 and complex128.

Bitwise: info codes (a non-SPD band included), the audited comm bytes per
op under each lowering (a fresh trace of ``slate_tpu``'s kernel on a tile
size no other test uses, as ``slate_tpu`` records at trace time), and the
port's factor across lookahead 0 / 1 / 2 and every broadcast lowering.
Window parity: finite garbage at the operand's scale in every tile outside
the band envelope of the operand handed to ``pbtrf_band_dist``; the port's
output matches ``slate_tpu``'s over the whole grid (the garbage tiles
either untouched in both or read by the same slot-rounded windows).
Stated tolerance: the factor within C_FACTOR n eps max|A| of
``slate_tpu``'s (c = 1: the same windowed algorithm, whose sums of at most
wd nb terms run in another order; measured <= 1e-2 of it).
"""

import gc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import parallel as jp
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_chol as jdc
from slate_tpu_torch import parallel as tp
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
C_FACTOR = 1.0
PB_CASES = [(64, 3, "float64"), (64, 16, "float64"), (64, 18, "float64"), (60, 18, "float64"),
            (64, 3, "float32"), (64, 18, "complex128")]


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
    """Hermitian positive definite with bandwidth kd: the band of G G^H + n I."""
    g = _rand((n, n), dtype, seed)
    return _project(g @ g.conj().T + n * np.eye(n), kd, kd).astype(dtype)


def _outside_band_tiles(n, nb, kd_lo, kd_hi):
    """Mask of the entries in tiles that hold no entry of the band
    -kd_hi <= j - i <= kd_lo... (i - j <= kd_lo and j - i <= kd_hi)."""
    nt = -(-n // nb)
    ti, tj = np.indices((nt, nt))
    # tile (I, J) holds band entries iff some i - j in [-kd_hi, kd_lo] lies in it
    lo = (ti - tj) * nb - (nb - 1)  # min of i - j over the tile
    hi = (ti - tj) * nb + (nb - 1)
    empty = (hi < -kd_hi) | (lo > kd_lo)
    return np.kron(empty, np.ones((nb, nb), bool))[:n, :n]


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


@functools.lru_cache(maxsize=None)
def _jax_pbtrf(n, kd, dtype, garbage=False):
    a = _spd_band(n, kd, dtype, n + kd)
    if garbage:
        a = _with_garbage(a, kd, n)
    l, info = jdc.pbtrf_band_dist(jp.from_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=True),
                                  kd, bcast_impl="psum")
    return np.asarray(jp.to_dense(l)), int(info)


def _with_garbage(a, kd, seed):
    mask = _outside_band_tiles(a.shape[0], NB, kd, kd)
    g = _rand(a.shape, a.dtype, seed) * np.abs(a).max()
    return np.where(mask, g, a).astype(a.dtype)


@pytest.mark.parametrize("n,kd,dtype", PB_CASES)
def test_pbtrf_band_dist_matches_jax(n, kd, dtype):
    l_ref, info_ref = _jax_pbtrf(n, kd, dtype)
    a = _spd_band(n, kd, dtype, n + kd)
    l, info = tp.pbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True), kd)
    assert info.dtype == torch.int32 and int(info) == info_ref == 0
    assert np.abs(tp.to_dense(l).numpy() - l_ref).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()


@pytest.mark.parametrize("n,kd,dtype", [(64, 3, "float64"), (64, 18, "float64"),
                                        (60, 18, "complex128")])
def test_pbtrf_band_dist_window_parity_with_garbage(n, kd, dtype):
    """Garbage in every tile outside the band envelope, handed straight to
    the factor: the tiles no window reaches come back untouched and the
    ones the slot-rounded windows reach enter both packages' arithmetic the
    same way, so the whole grid matches (NaN where a garbage tile broke
    positive definiteness, at the same places)."""
    l_ref, info_ref = _jax_pbtrf(n, kd, dtype, garbage=True)
    a = _with_garbage(_spd_band(n, kd, dtype, n + kd), kd, n)
    l, info = tp.pbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True), kd)
    got = tp.to_dense(l).numpy()
    assert int(info) == info_ref
    np.testing.assert_array_equal(np.isnan(got), np.isnan(l_ref))
    fin = ~np.isnan(l_ref)
    assert np.abs(got[fin] - l_ref[fin]).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()
    # the tiles of the upper triangle are never touched: bitwise the operand's
    mask = _outside_band_tiles(n, NB, kd, kd) & (np.indices((n, n))[1] > np.indices((n, n))[0])
    np.testing.assert_array_equal(got[mask], a[mask])


@pytest.mark.parametrize("j", [0, 29, 63])
def test_pbtrf_band_dist_non_spd_info_matches_jax(j):
    n, kd = 64, 18
    a = _spd_band(n, kd, "float64", 3)
    a[j, j] = -1.0
    _, info_ref = jdc.pbtrf_band_dist(jp.from_dense(jnp.asarray(a), _jmesh(), NB, diag_pad_one=True),
                                      kd, bcast_impl="psum")
    _, info = tp.pbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True), kd)
    assert int(info) == int(info_ref) > 0


def test_pbtrf_band_dist_bitwise_across_lookahead_and_lowerings():
    n, kd = 64, 18
    a = _spd_band(n, kd, "float64", 41)
    ad = tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True)
    base = tp.pbtrf_band_dist(ad, kd, lookahead=1)[0].tiles
    for la in (0, 2):
        assert torch.equal(tp.pbtrf_band_dist(ad, kd, lookahead=la)[0].tiles, base), la
    for impl in ("psum", "ring", "doubling", "auto"):
        for la in (0, 1):
            got = tp.pbtrf_band_dist(ad, kd, lookahead=la, bcast_impl=impl)[0].tiles
            assert torch.equal(got, base), (impl, la)
    # the operand is not modified (overwrite_a False)
    assert torch.equal(ad.tiles, tp.from_dense(_t(a), _tmesh(), NB, diag_pad_one=True).tiles)


@pytest.mark.parametrize("impl,nb,n,kd", [("psum", 5, 40, 4), ("ring", 5, 45, 11),
                                          ("doubling", 7, 56, 15)])
def test_pbtrf_band_dist_audit_bytes_match_jax(impl, nb, n, kd):
    """A fresh trace of slate_tpu's kernel (tile sizes no other test uses)."""
    a = _spd_band(n, kd, "float64", 17)
    jm = _jmesh()
    ja = jp.from_dense(jnp.asarray(a), jm, nb, diag_pad_one=True)
    wd = min(((nb - 1) + kd) // nb + 1, ja.nt)
    with jcomm.comm_audit() as jrec:
        jax.make_jaxpr(jdc._pbtrf_band_jit.__wrapped__, static_argnums=(1, 2, 3, 4, 5, 6, 7))(
            ja.tiles, jm, 2, 4, ja.nt, wd, 1, impl)
    with tcomm.comm_audit() as trec:
        tp.pbtrf_band_dist(tp.from_dense(_t(a), _tmesh(), nb, diag_pad_one=True), kd, lookahead=1,
                           bcast_impl=impl)
    want = _totals(jrec)
    assert want and _totals(trec) == want
    assert any(op.startswith("ppermute") for op in want) is (impl != "psum")
