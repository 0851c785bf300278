"""The port's single-chip band Cholesky (slate_tpu_torch.linalg.band's
pbtrf_band / pbtrs_band / pbsv_band, chol.pbtrf_array / pbtrs_array /
pbsv_array / pbsv), tbsm and the triangular_solve facade against
slate_tpu.

The same seeded numpy operands go through ``slate_tpu`` (under ``jax.jit``,
so each shape compiles once; results cached per case) and through the port
on the CPU, in f32, f64, complex64 and complex128, at n in {1, 64, 90,
100, 257} and kd in {1, 5, 16, 32}.

Bitwise: info codes (a non-SPD band included), the narrow / wide routing
decision, and the port's factor with and without finite garbage outside
the declared band.  Stated tolerances: the factor within C_FACTOR n eps
max|A| of ``slate_tpu``'s and the solution within C_SOLVE n eps max|X|
(both packages run the same windowed algorithm; the two frameworks differ
only in the summation order of sums of at most kd + nb terms, which the
measured differences, <= 1e-3 of n eps max|A|, reflect; c = 1 leaves a
wide margin and still fails any change of window or block).
"""

import gc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu import api as japi
from slate_tpu.blas3 import blas3 as jb3
from slate_tpu.linalg import band as jband
from slate_tpu.linalg import chol as jchol
from slate_tpu_torch import api as tapi
from slate_tpu_torch import types as tt
from slate_tpu_torch.blas3 import blas3 as tb3
from slate_tpu_torch.core import matrix as tm
from slate_tpu_torch.linalg import band as tband
from slate_tpu_torch.linalg import chol as tchol

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop the module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that keeps them for the whole
    run can reach the per-process map limit (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()


C_FACTOR = 1.0  # factors within C_FACTOR n eps max|A| of slate_tpu's
C_SOLVE = 1.0  # solutions within C_SOLVE n eps max|X|

# (n, kd, dtype): every n and kd, f64 throughout, the other dtypes on a few
PB_CASES = [(1, 1, "float64"), (64, 1, "float64"), (64, 16, "float64"), (90, 5, "float64"),
            (100, 5, "float64"), (257, 16, "float64"), (257, 32, "float64"),
            (90, 5, "float32"), (257, 16, "float32"), (100, 32, "complex64"),
            (64, 16, "complex128")]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _band(n, kl, ku, dtype, seed):
    """Random entries on the diagonals -kl..ku, zeros elsewhere."""
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.dtype(dtype))
    for d in range(-kl, ku + 1):
        v = rng.standard_normal(n - abs(d))
        if np.dtype(dtype).kind == "c":
            v = v + 1j * rng.standard_normal(n - abs(d))
        a += np.diag(v, d).astype(dtype)
    return a


def _spd_band(n, kd, dtype, seed):
    """G G^H + n I, G of bandwidth kd // 2 each side: Hermitian positive
    definite with bandwidth kd (kd = 1: a diagonally dominant tridiagonal)."""
    h = kd // 2
    if h == 0:
        a = _band(n, 1, 1, dtype, seed)
        a = (a + a.conj().T) / 2 + 4 * np.eye(n, dtype=dtype)
        return a.astype(dtype)
    g = _band(n, h, h, dtype, seed)
    return (g @ g.conj().T + n * np.eye(n)).astype(dtype)


def _rhs(n, dtype, seed, nrhs=3):
    return _band(max(n, nrhs), 0, max(n, nrhs), dtype, seed)[:n, :nrhs].copy()


def _garbage(a, keep, seed, scale=None):
    """``a`` with finite garbage, at its own scale, wherever ``keep`` is
    False."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(a.shape) * (np.abs(a).max() if scale is None else scale)
    return np.where(keep, a, g.astype(a.real.dtype)).astype(a.dtype)


def _offsets(n):
    i, j = np.indices((n, n))
    return i - j


@functools.lru_cache(maxsize=None)
def _jax_pbsv(n, kd, dtype):
    a, b = _spd_band(n, kd, dtype, n + kd), _rhs(n, dtype, 7 * n + kd)
    x, f, info = jax.jit(lambda a, b: jband.pbsv_band(a, b, kd))(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(x), np.asarray(f.l), int(info), int(f.nb)


@pytest.mark.parametrize("n,kd,dtype", PB_CASES)
def test_pbsv_band_matches_jax(n, kd, dtype):
    a, b = _spd_band(n, kd, dtype, n + kd), _rhs(n, dtype, 7 * n + kd)
    x_ref, l_ref, info_ref, nb_ref = _jax_pbsv(n, kd, dtype)
    x, f, info = tband.pbsv_band(_t(a), _t(b), kd)
    assert info.dtype == torch.int32 and int(info) == info_ref == 0
    assert f.nb == nb_ref and f.kd == kd
    eps = _eps(dtype)
    assert np.abs(f.l.numpy() - l_ref).max() <= C_FACTOR * n * eps * np.abs(a).max()
    assert np.abs(x.numpy() - x_ref).max() <= C_SOLVE * n * eps * np.abs(x_ref).max()
    # pbtrs_band alone on the factor, and a 1-D right-hand side
    np.testing.assert_array_equal(tband.pbtrs_band(f, _t(b)).numpy(), x.numpy())
    x1 = tband.pbtrs_band(f, _t(b[:, 0])).numpy()
    assert x1.shape == (n,)
    assert np.abs(x1 - x_ref[:, 0]).max() <= C_SOLVE * n * eps * np.abs(x_ref).max()


@pytest.mark.parametrize("n,kd,dtype", [(100, 5, "float64"), (257, 16, "float32"),
                                        (64, 16, "complex128")])
def test_pbtrf_band_window_parity_with_garbage(n, kd, dtype):
    """Finite garbage outside the declared band (above the diagonal, and
    between kd and the rounded band): both packages project it away, so the
    port's factor matches slate_tpu's over the whole grid and is bitwise the
    port's factor of the clean operand."""
    a = _spd_band(n, kd, dtype, n + kd)
    d = _offsets(n)
    ag = _garbage(a, (d >= 0) & (d <= kd), seed=n)
    l_ref = np.asarray(jax.jit(lambda x: jband.pbtrf_band(x, kd).l)(jnp.asarray(ag)))
    fg = tband.pbtrf_band(_t(ag), kd)
    assert np.abs(fg.l.numpy() - l_ref).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()
    np.testing.assert_array_equal(fg.l.numpy(), tband.pbtrf_band(_t(a), kd).l.numpy())


@pytest.mark.parametrize("j", [0, 40, 99])
def test_pbtrf_band_non_spd_info_matches_jax(j):
    n, kd = 100, 5
    a = _spd_band(n, kd, "float64", 3)
    a[j, j] = -1.0
    info_ref = int(jax.jit(lambda x: jband.pbtrf_band(x, kd).info)(jnp.asarray(a)))
    got = tband.pbtrf_band(_t(a), kd)
    assert got.info.dtype == torch.int32
    assert int(got.info) == info_ref > 0
    np.testing.assert_array_equal(np.isnan(got.l.numpy()),
                                  np.isnan(np.asarray(jband.pbtrf_band(jnp.asarray(a), kd).l)))


def test_band_routing_matches_jax():
    """``band_worthwhile`` and the pick of nb, bitwise over a grid."""
    for n in (1, 2, 7, 64, 90, 100, 257, 1024):
        for band in (0, 1, 2, 5, 16, 25, 32, 64, 257):
            assert tband.band_worthwhile(n, band) is jband.band_worthwhile(n, band)
            assert tband._pick_nb(band) == jband._pick_nb(band)
            assert tchol._band_worthwhile(n, band) is jchol._band_worthwhile(n, band)


# ---------------------------------------------------------------------------
# the drivers: pbtrf_array / pbtrs_array / pbsv_array / pbsv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,kd,uplo,dtype", [(100, 5, "Lower", "float64"),  # narrow: windowed
                                             (64, 32, "Lower", "float64"),  # wide: dense
                                             (90, 5, "Upper", "float32"),  # upper: dense
                                             (64, 16, "Lower", "complex128")])
def test_pbsv_array_matches_jax(n, kd, uplo, dtype):
    a, b = _spd_band(n, kd, dtype, n + kd), _rhs(n, dtype, 7 * n + kd)
    stored = np.tril(a) if uplo == "Lower" else np.triu(a)
    juplo = st.Uplo[uplo]
    x_ref, f_ref, info_ref = jax.jit(lambda a, b: jchol.pbsv_array(a, b, kd, juplo))(
        jnp.asarray(stored), jnp.asarray(b))
    x, f, info = tchol.pbsv_array(_t(stored), _t(b), kd, tt.Uplo[uplo])
    eps = _eps(dtype)
    assert int(info) == int(info_ref) == 0
    assert np.abs(f.numpy() - np.asarray(f_ref)).max() <= C_FACTOR * n * eps * np.abs(a).max()
    assert np.abs(x.numpy() - np.asarray(x_ref)).max() <= C_SOLVE * n * eps * np.abs(x_ref).max()
    # the pieces: pbtrf_array's factor and info, pbtrs_array on it
    f2, info2 = tchol.pbtrf_array(_t(stored), kd, tt.Uplo[uplo])
    np.testing.assert_array_equal(f2.numpy(), f.numpy())
    assert int(info2) == 0
    np.testing.assert_array_equal(tchol.pbtrs_array(f2, _t(b), kd, tt.Uplo[uplo]).numpy(), x.numpy())


def test_pbsv_view_matches_jax():
    n, kd = 90, 5
    a, b = _spd_band(n, kd, "float64", 11), _rhs(n, "float64", 12)
    xj, fj, ij = st.linalg.pbsv(st.HermitianBandMatrix.from_array(jnp.asarray(a), st.Uplo.Lower, kd),
                                st.Matrix.from_array(jnp.asarray(b)))
    xt, ft, it = tchol.pbsv(tm.HermitianBandMatrix.from_array(_t(a), tt.Uplo.Lower, kd),
                            tm.Matrix.from_array(_t(b)))
    assert isinstance(xt, tm.Matrix) and isinstance(ft, tm.TriangularBandMatrix)
    assert (ft.kl, ft.ku, ft.uplo) == (fj.kl, fj.ku, tt.Uplo.Lower) == (kd, 0, tt.Uplo.Lower)
    assert int(it) == int(ij) == 0
    eps = _eps("float64")
    assert np.abs(ft.data.numpy() - np.asarray(fj.data)).max() <= C_FACTOR * n * eps * np.abs(a).max()
    xr = np.asarray(xj.data)
    assert np.abs(xt.data.numpy() - xr).max() <= C_SOLVE * n * eps * np.abs(xr).max()


def test_pbtrf_array_wide_non_spd_info_matches_jax():
    n, kd = 64, 32  # 4 kd > n: the dense route
    a = _spd_band(n, kd, "float64", 5)
    a[37, 37] = -1.0
    _, info_ref = jchol.pbtrf_array(jnp.asarray(np.tril(a)), kd)
    _, info = tchol.pbtrf_array(_t(np.tril(a)), kd)
    assert int(info) == int(info_ref) > 0


# ---------------------------------------------------------------------------
# tbsm and the triangular_solve facade
# ---------------------------------------------------------------------------


def _ipiv(n, seed):
    """LAPACK-style interchanges: pivots[i] >= i."""
    rng = np.random.default_rng(seed)
    return np.array([rng.integers(i, n) for i in range(n)], np.int32)


@pytest.mark.parametrize("uplo,side,dtype", [("Lower", "Left", "float64"),
                                             ("Upper", "Left", "float32"),
                                             ("Lower", "Right", "complex128")])
@pytest.mark.parametrize("pivots", [False, True])
def test_tbsm_matches_jax(uplo, side, dtype, pivots):
    n, kd = 70, 6
    kl, ku = (kd, 0) if uplo == "Lower" else (0, kd)
    a = _band(n, kl, ku, dtype, 21) + 8 * np.eye(n, dtype=dtype)
    b = _band(n, n, n, dtype, 22)[:, :5].copy()
    if side == "Right":
        b = b.T.copy()
    piv = _ipiv(n, 23) if pivots and side == "Left" else None
    jview = st.TriangularBandMatrix.from_array(jnp.asarray(a), st.Uplo[uplo], kd)
    tview = tm.TriangularBandMatrix.from_array(_t(a), tt.Uplo[uplo], kd)
    ref = np.asarray(jb3.tbsm(st.Side[side], 2.0, jview, jnp.asarray(b),
                              None if piv is None else jnp.asarray(piv)))
    got = tb3.tbsm(tt.Side[side], 2.0, tview, _t(b), None if piv is None else _t(piv)).numpy()
    assert np.abs(got - ref).max() <= C_SOLVE * n * _eps(dtype) * np.abs(ref).max()


def test_apply_pivots_sequential_matches_jax():
    """laswp: the interchanges one after another, both directions (not one
    gather by the pivot vector, which would be a different permutation)."""
    n = 40
    piv = _ipiv(n, 5)
    b = np.arange(n * 3, dtype=np.float64).reshape(n, 3)
    for forward in (True, False):
        ref = np.asarray(jb3._apply_pivots(jnp.asarray(b), jnp.asarray(piv), forward))
        got = tb3._apply_pivots(_t(b), _t(piv), forward).numpy()
        np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(ref, b[piv])


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_triangular_solve_facade_matches_jax(side, uplo):
    n, dtype = 48, "float64"
    a = _band(n, n, n, dtype, 31)
    a = (np.tril(a) if uplo == "Lower" else np.triu(a)) + n * np.eye(n)
    b = _band(n, n, n, dtype, 32)[:, :6].copy()
    if side == "Right":
        b = b.T.copy()
    ref = np.asarray(japi.triangular_solve(
        st.Side[side], 0.5, st.TriangularMatrix.from_array(jnp.asarray(a), st.Uplo[uplo]),
        jnp.asarray(b)))
    got = tapi.triangular_solve(tt.Side[side], 0.5,
                                tm.TriangularMatrix.from_array(_t(a), tt.Uplo[uplo]), _t(b))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.abs(got.numpy() - ref).max() <= C_SOLVE * n * _eps(dtype) * np.abs(ref).max()
