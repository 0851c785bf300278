"""The port's tridiagonal solve (slate_tpu_torch.linalg.indefinite.gtsv_array)
and hetrf's info codes against slate_tpu.linalg.indefinite on the CPU, on
the same seeded numpy operands (hesv / hetrs, the sy* aliases and the api
facades: tests/test_torch_indefinite_hesv.py).

Stated tolerances (eps of the dtype): gtsv's info bitwise, its X within
8 n eps max|X| of slate_tpu's (the same pivot decisions and eliminations,
the products rounded in another order), and the solve's residual within
100 n eps |T| |X|; hetrf's info bitwise (always 0), and a singular T's
info from the solve bitwise.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import indefinite as jind
from slate_tpu_torch.linalg import indefinite as tind
from slate_tpu_torch.utils.testing import gtsv_swaps

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


N = 64


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _tridiag(kind, n, dtype, seed):
    dl, d, du = (_rand((k,), seed + i, dtype) for i, k in enumerate((n - 1, n, n - 1)))
    if kind == "every_swap":  # near tridiag(2.2, 0, 1.9): l_k beats every carried pivot
        dl = (2.2 + 0.05 * np.abs(dl)).astype(dtype)
        du = (1.9 + 0.05 * np.abs(du)).astype(dtype)
        d = d * 1e-3
    elif kind == "small_diag":  # some swaps, some not
        d = d * 1e-2
    elif kind == "zero_pivot":  # U(7, 7) = 0 exactly: info 8
        dl[:] = 0
        du[:] = 0
        d[7] = 0
    return dl, d, du


GTSV_DTYPES = [np.float32, np.float64, np.complex128]


@pytest.mark.parametrize("dtype", GTSV_DTYPES)
@pytest.mark.parametrize("kind", ["random", "every_swap", "small_diag", "zero_pivot", "vector_b"])
def test_gtsv_matches_jax(kind, dtype):
    n = 48
    dl, d, du = _tridiag("random" if kind == "vector_b" else kind, n, dtype, 3)
    b = _rand((n,) if kind == "vector_b" else (n, 3), 9, dtype)
    xj, ij = jind.gtsv_array(*(jnp.asarray(v) for v in (dl, d, du, b)))
    xt, it = tind.gtsv_array(*(_t(v) for v in (dl, d, du, b)))
    assert it.dtype == torch.int32 and it.shape == ()
    assert int(it) == int(ij) == (8 if kind == "zero_pivot" else 0)
    assert xt.shape == b.shape and xt.dtype == _t(b).dtype
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 8 * n * _eps(dtype) * np.abs(xj).max()
    if kind == "every_swap":
        assert all(gtsv_swaps(dl.tolist(), d.tolist(), du.tolist()))
    if kind == "small_diag":
        assert 0 < sum(gtsv_swaps(dl.tolist(), d.tolist(), du.tolist())) < n - 1
    if kind in ("random", "every_swap"):  # the solve itself, in f64
        t = np.diag(d) + np.diag(dl, -1) + np.diag(du, 1)
        r = np.abs(t.astype(np.complex128) @ xt.numpy() - b).max()
        assert r <= 100 * n * _eps(dtype) * np.abs(t).max() * np.abs(xt.numpy()).max()


def test_gtsv_nonfinite_and_trivial_sizes():
    d = np.ones(6)
    d[3] = np.inf
    z = np.zeros(5)
    _, ij = jind.gtsv_array(*(jnp.asarray(v) for v in (z, d, z, np.ones(6))))
    _, it = tind.gtsv_array(*(_t(v) for v in (z, d, z, np.ones(6))))
    assert int(it) == int(ij) == 4
    for n in (1, 2):
        dl, d, du = _tridiag("random", n, np.float64, 5)
        b = _rand((n, 2), 6, np.float64)
        xj, ij = jind.gtsv_array(*(jnp.asarray(v) for v in (dl, d, du, b)))
        xt, it = tind.gtsv_array(*(_t(v) for v in (dl, d, du, b)))
        assert int(it) == int(ij) == 0
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=8 * n * _eps(np.float64)
                                   * np.abs(np.asarray(xj)).max())


def _indefinite(n, dtype, seed):
    """Hermitian with eigenvalues of both signs, O(1) entries."""
    g = _rand((n, n), seed, dtype)
    return ((g + g.conj().T) / 2).astype(dtype)


def _eta(a, x, b):
    w = np.complex128 if np.iscomplexobj(a) else np.float64
    a, x, b = (v.astype(w) for v in (a, x, b))
    r = np.abs(a @ x - b).max()
    return r / (np.abs(a).max() * np.abs(x).max() * a.shape[0] + np.abs(b).max())


def test_hetrf_info_and_singular_t_match_jax():
    a = _indefinite(N, np.float64, 14)
    fj, ij = jind.hetrf_array(jnp.asarray(a), 16)
    ft, it = tind.hetrf_array(_t(a), 16)
    assert int(it) == int(ij) == 0 and it.dtype == torch.int32
    # the zero matrix: T singular at its first pivot, reported by the solve
    z = np.zeros((N, N))
    b = _rand((N, 2), 15, np.float64)
    _, _, ij = jind.hesv_array(jnp.asarray(z), jnp.asarray(b), nb=16)
    _, _, it = tind.hesv_array(_t(z), _t(b), nb=16)
    assert int(it) == int(ij) == 1
