"""The port's single-chip band LU (slate_tpu_torch.linalg.band's gbtrf_band
/ gbtrs_band / gbsv_band, lu.gbtrf_array / gbtrs_array / gbsv_array)
against slate_tpu.

The same seeded numpy operands go through ``slate_tpu`` (under ``jax.jit``,
results cached per case) and through the port on the CPU, in f32, f64,
complex64 and complex128, at n in {1, 64, 90, 100, 257} and (kl, ku) in
{(1, 1), (4, 3), (16, 8), (3, 2) with a[0, 0] = 1e-14} (random, not
diagonally dominant: the windows pivot).

Bitwise: ``BandLU.perms`` (window-local, LAPACK gbtrf semantics), every
info code (a zero pivot included), the narrow / wide routing decision, and
the port's factor with and without finite garbage outside the declared
band.  Stated tolerances: the packed factor within C_FACTOR n eps max|A| of
``slate_tpu``'s (c = 1: the same pivots make the same eliminations in both
packages, which then differ only in the summation order of sums of at most
kl + ku + nb terms; the differences measured are <= 0.09 n eps max|A|),
and the solutions by their difference's image, max|A (X - X_ref)| <=
C_SOLVE n eps max|A| max|X| (c = 1: both solves are backward stable, so
A X - B is that small for each; random bands are not well conditioned, so
X - X_ref itself grows with the condition number and is no yardstick).
"""

import gc
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import band as jband
from slate_tpu.linalg import lu as jlu
from slate_tpu_torch.linalg import band as tband
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.types import Op

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop the module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that keeps them for the whole
    run can reach the per-process map limit (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()


C_FACTOR = 1.0  # packed factors within C_FACTOR n eps max|A| of slate_tpu's
C_SOLVE = 1.0  # max|A (X - X_ref)| within C_SOLVE n eps max|A| max|X|

# (n, kl, ku, dtype, tiny): tiny puts 1e-14 at a[0, 0] (a forced pivot)
GB_CASES = [(1, 1, 1, "float64", False), (64, 1, 1, "float64", False),
            (90, 1, 1, "float64", False), (100, 4, 3, "float64", False),
            (257, 4, 3, "float64", False), (257, 16, 8, "float64", False),
            (64, 16, 8, "float64", False), (64, 3, 2, "float64", True),
            (100, 3, 2, "float32", True), (257, 16, 8, "float32", False),
            (90, 1, 1, "complex64", False), (100, 4, 3, "complex128", False)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _band(n, kl, ku, dtype, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.dtype(dtype))
    for d in range(-kl, ku + 1):
        v = rng.standard_normal(n - abs(d))
        if np.dtype(dtype).kind == "c":
            v = v + 1j * rng.standard_normal(n - abs(d))
        a += np.diag(v, d).astype(dtype)
    return a


def _operands(n, kl, ku, dtype, tiny):
    a = _band(n, kl, ku, dtype, 100 * n + 10 * kl + ku)
    if tiny:
        a[0, 0] = 1e-14
    b = _band(n, n, n, dtype, 5 * n + kl)[:, :2].copy()
    return a, b


def _solves_agree(a, x, x_ref):
    """max|A (X - X_ref)| <= C_SOLVE n eps max|A| max|X_ref|, in f64 / c128."""
    n = a.shape[0]
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    diff = a.astype(wide) @ (np.asarray(x).astype(wide) - np.asarray(x_ref).astype(wide))
    return np.abs(diff).max() <= C_SOLVE * n * _eps(a.dtype) * np.abs(a).max() * np.abs(x_ref).max()


@functools.lru_cache(maxsize=None)
def _jax_gbsv(n, kl, ku, dtype, tiny):
    a, b = _operands(n, kl, ku, dtype, tiny)
    x, f, info = jax.jit(lambda a, b: jband.gbsv_band(a, b, kl, ku))(jnp.asarray(a), jnp.asarray(b))
    return np.asarray(x), np.asarray(f.lu), np.asarray(f.perms), int(info), int(f.nb)


@pytest.mark.parametrize("n,kl,ku,dtype,tiny", GB_CASES)
def test_gbsv_band_matches_jax(n, kl, ku, dtype, tiny):
    a, b = _operands(n, kl, ku, dtype, tiny)
    x_ref, lu_ref, perms_ref, info_ref, nb_ref = _jax_gbsv(n, kl, ku, dtype, tiny)
    x, f, info = tband.gbsv_band(_t(a), _t(b), kl, ku)
    assert info.dtype == torch.int32 and int(info) == info_ref == 0
    assert (f.kl, f.ku, f.nb) == (kl, ku, nb_ref)
    assert f.perms.dtype == torch.int32
    np.testing.assert_array_equal(f.perms.numpy(), perms_ref)
    if not tiny:
        assert not np.array_equal(perms_ref, np.broadcast_to(np.arange(perms_ref.shape[1]),
                                                             perms_ref.shape)) or n == 1
    assert np.abs(f.lu.numpy() - lu_ref).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()
    assert _solves_agree(a, x.numpy(), x_ref)
    np.testing.assert_array_equal(tband.gbtrs_band(f, _t(b)).numpy(), x.numpy())


def test_tiny_leading_pivot_is_pivoted():
    """a[0, 0] = 1e-14: the first window must pick another row."""
    _, _, perms, _, _ = _jax_gbsv(64, 3, 2, "float64", True)
    assert perms[0, 0] != 0


@pytest.mark.parametrize("n,kl,ku,dtype", [(100, 4, 3, "float64"), (257, 16, 8, "float32"),
                                           (90, 1, 1, "complex128")])
def test_gbtrf_band_window_parity_with_garbage(n, kl, ku, dtype):
    """Finite garbage outside the declared (kl, ku) band, at the operand's
    scale: both packages project it away, so the factor and the pivots
    match slate_tpu's over the whole grid, and the port's are bitwise its
    factor of the clean operand."""
    a, _ = _operands(n, kl, ku, dtype, False)
    i, j = np.indices((n, n))
    keep = (i - j <= kl) & (j - i <= ku)
    g = np.random.default_rng(n).standard_normal((n, n)) * np.abs(a).max()
    ag = np.where(keep, a, g.astype(a.real.dtype)).astype(a.dtype)
    ref = jax.jit(lambda x: jband.gbtrf_band(x, kl, ku))(jnp.asarray(ag))
    got = tband.gbtrf_band(_t(ag), kl, ku)
    np.testing.assert_array_equal(got.perms.numpy(), np.asarray(ref.perms))
    assert np.abs(got.lu.numpy() - np.asarray(ref.lu)).max() <= \
        C_FACTOR * n * _eps(dtype) * np.abs(a).max()
    clean = tband.gbtrf_band(_t(a), kl, ku)
    np.testing.assert_array_equal(got.lu.numpy(), clean.lu.numpy())
    np.testing.assert_array_equal(got.perms.numpy(), clean.perms.numpy())


@pytest.mark.parametrize("j", [0, 37, 63])
def test_gbtrf_band_zero_pivot_info_matches_jax(j):
    """A zero column of the band: no pivot in its window, info 1 + j in both
    packages (the first zero U diagonal)."""
    n, kl, ku = 64, 4, 3
    a, _ = _operands(n, kl, ku, "float64", False)
    a[:, j] = 0
    ref = jax.jit(lambda x: jband.gbtrf_band(x, kl, ku))(jnp.asarray(a))
    got = tband.gbtrf_band(_t(a), kl, ku)
    assert int(got.info) == int(ref.info) == j + 1
    np.testing.assert_array_equal(got.perms.numpy(), np.asarray(ref.perms))


# ---------------------------------------------------------------------------
# the drivers: gbtrf_array / gbtrs_array / gbsv_array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,kl,ku,dtype", [(100, 4, 3, "float64"),  # narrow: windowed
                                           (64, 16, 8, "float64"),  # wide: dense
                                           (90, 1, 1, "float32"),
                                           (64, 20, 20, "complex128")])
def test_gbsv_array_matches_jax(n, kl, ku, dtype):
    a, b = _operands(n, kl, ku, dtype, False)
    x_ref, f_ref = jax.jit(lambda a, b: jlu.gbsv_array(a, b, kl, ku))(jnp.asarray(a), jnp.asarray(b))
    x, f = tlu.gbsv_array(_t(a), _t(b), kl, ku)
    narrow = tband.band_worthwhile(n, max(kl, 1) + max(ku, 1))
    assert narrow is jband.band_worthwhile(n, max(kl, 1) + max(ku, 1))
    assert type(f).__name__ == type(f_ref).__name__ == ("BandLU" if narrow else "LUFactors")
    assert int(f.info) == int(f_ref.info) == 0
    if narrow:
        np.testing.assert_array_equal(f.perms.numpy(), np.asarray(f_ref.perms))
    else:
        np.testing.assert_array_equal(f.perm.numpy(), np.asarray(f_ref.perm))
    assert np.abs(f.lu.numpy() - np.asarray(f_ref.lu)).max() <= \
        C_FACTOR * n * _eps(dtype) * np.abs(a).max()
    assert _solves_agree(a, x.numpy(), np.asarray(x_ref))


@pytest.mark.parametrize("op", [Op.NoTrans, Op.Trans, Op.ConjTrans])
def test_gbtrf_array_dense_route_matches_jax(op):
    """gbtrf_array is the dense factor of the projected band: U projected
    to kl + ku, L's strictly-lower part kept dense; gbtrs_array solves
    every op with it."""
    n, kl, ku, dtype = 72, 5, 2, "complex128"
    a, b = _operands(n, kl, ku, dtype, False)
    jop = {Op.NoTrans: "NoTrans", Op.Trans: "Trans", Op.ConjTrans: "ConjTrans"}[op]
    import slate_tpu as st

    fj = jax.jit(lambda a: jlu.gbtrf_array(a, kl, ku))(jnp.asarray(a))
    ft = tlu.gbtrf_array(_t(a), kl, ku)
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    assert int(ft.info) == int(fj.info) == 0
    assert np.abs(ft.lu.numpy() - np.asarray(fj.lu)).max() <= C_FACTOR * n * _eps(dtype) * np.abs(a).max()
    i, j = np.indices((n, n))
    assert not np.any(ft.lu.numpy()[(j - i) > kl + ku])  # U projected to kl + ku
    xr = np.asarray(jlu.gbtrs_array(fj, jnp.asarray(b), kl, ku, st.Op[jop]))
    xt = tlu.gbtrs_array(ft, _t(b), kl, ku, op).numpy()
    assert _solves_agree(a if op == Op.NoTrans else (a.T if op == Op.Trans else a.conj().T), xt, xr)


def test_gbtrs_array_windowed_factor_refuses_transpose():
    a, b = _operands(100, 4, 3, "float64", False)
    _, f = tlu.gbsv_array(_t(a), _t(b), 4, 3)
    with pytest.raises(ValueError, match="NoTrans"):
        tlu.gbtrs_array(f, _t(b), 4, 3, Op.Trans)
    np.testing.assert_array_equal(tlu.gbtrs_array(f, _t(b), 4, 3).numpy(),
                                  tband.gbtrs_band(f, _t(b)).numpy())
