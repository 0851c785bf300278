"""The port's hesv / hetrs and the sy* aliases and api facades
(slate_tpu_torch.linalg.indefinite) against slate_tpu.linalg.indefinite on
the CPU, on the same seeded numpy operands (gtsv and hetrf's info:
tests/test_torch_indefinite.py, whose helpers this file reads).

Stated tolerances (eps of the dtype): T's (d, e) as tests/test_torch_eig.py
holds hb2st's, elementwise within 100 n eps max|band|, and T's spectrum
within 10 n eps ||A||_2 of A's (Weyl); X within n eps kappa_2(A) max|X| of
slate_tpu's; eta < 100 n eps on both sides; info bitwise.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_indefinite import N, _eps, _eta, _indefinite, _rand, _t

from slate_tpu import api as japi
from slate_tpu.linalg import indefinite as jind
from slate_tpu_torch import api as tapi
from slate_tpu_torch.linalg import indefinite as tind

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("nb", [8, 16])
def test_hesv_matches_jax(nb, dtype):
    a = _indefinite(N, dtype, 11)
    b = _rand((N, 4), 12, dtype)
    w = np.linalg.eigvalsh(a)
    assert w.min() < 0 < w.max()
    xj, fj, ij = jind.hesv_array(jnp.asarray(a), jnp.asarray(b), nb=nb)
    xt, ft, it = tind.hesv_array(_t(a), _t(b), nb=nb)
    assert isinstance(ft, tind.HetrfFactors)
    assert int(it) == int(ij) == 0
    eps = _eps(dtype)
    # T = Q^H A Q: (d, e) against the reference's, and its spectrum A's
    scale = np.abs(np.asarray(fj.stage1.band)).max()
    assert ft.d.dtype == ft.e.dtype == _t(np.zeros(1, np.finfo(dtype).dtype)).dtype
    assert np.abs(ft.d.numpy() - np.asarray(fj.d)).max() <= 100 * N * eps * scale
    assert np.abs(ft.e.numpy() - np.asarray(fj.e)).max() <= 100 * N * eps * scale
    tri = np.diag(ft.d.numpy()) + np.diag(ft.e.numpy(), 1) + np.diag(ft.e.numpy(), -1)
    assert np.abs(np.linalg.eigvalsh(tri) - w).max() <= 10 * N * eps * np.abs(w).max()
    xj = np.asarray(xj)
    kappa = np.abs(w).max() / np.abs(w).min()
    assert np.abs(xt.numpy() - xj).max() <= N * eps * kappa * np.abs(xj).max()
    gate = 100 * N * eps
    assert _eta(a, xt.numpy(), b) < gate and _eta(a, xj, b) < gate
    # the factors solve a fresh right-hand side, 1-D
    b1 = _rand((N,), 13, dtype)
    x1, i1 = tind.hetrs_array(ft, _t(b1))
    assert x1.shape == (N,) and int(i1) == 0
    assert _eta(a, x1.numpy()[:, None], b1[:, None]) < gate


def test_sysv_aliases_and_api_match_jax():
    assert tind.sytrf_array is tind.hetrf_array
    assert tind.sytrs_array is tind.hetrs_array
    assert tind.sysv_array is tind.hesv_array
    a = _indefinite(N, np.float32, 16)
    b = _rand((N, 3), 17, np.float32)
    f, info = tind.sytrf_array(_t(a), 16)
    x = tind.sytrs_array(f, _t(b))[0]
    xs, _, _ = tind.sysv_array(_t(a), _t(b), 16)
    assert torch.equal(x, xs) and int(info) == 0
    assert _eta(a, x.numpy(), b) < 100 * N * _eps(np.float32)
    # the facades: the same solve as the array form, on the operand's device
    xa, ia = tapi.indefinite_solve(_t(a), _t(b), nb=16)
    xja, ija = japi.indefinite_solve(jnp.asarray(a), jnp.asarray(b), nb=16)
    assert torch.equal(xa, xs) and int(ia) == int(ija) == 0
    w = np.linalg.eigvalsh(a.astype(np.float64))
    tol = N * _eps(np.float32) * np.abs(w).max() / np.abs(w).min() * np.abs(np.asarray(xja)).max()
    assert np.abs(xa.numpy() - np.asarray(xja)).max() <= tol
    fa, ifa = tapi.indefinite_factor(_t(a), nb=16, device="cpu")
    fja, ifja = japi.indefinite_factor(jnp.asarray(a), nb=16)
    assert torch.equal(fa.d, f.d) and int(ifa) == int(ifja) == 0
    assert isinstance(fa, tind.HetrfFactors) and xa.device.type == "cpu"


def test_indefinite_facades_device_rule():
    """A numpy operand computes on the card (refused without one); a CPU
    tensor or device="cpu" on the host, with the same numbers."""
    a = _indefinite(16, np.float64, 18)
    b = _rand((16, 2), 19, np.float64)
    if torch.cuda.is_available():
        assert tapi.indefinite_solve(a, b, nb=8)[0].is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tapi.indefinite_solve(a, b, nb=8)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tapi.indefinite_factor(a, nb=8)
    x1, i1 = tapi.indefinite_solve(a, b, nb=8, device="cpu")
    x2, i2 = tapi.indefinite_solve(_t(a), _t(b), nb=8)
    assert x1.device.type == x2.device.type == "cpu" and torch.equal(x1, x2)
    assert int(i1) == int(i2) == 0
