"""The port's Random Butterfly Transform solve (slate_tpu_torch.linalg.rbt)
against slate_tpu.linalg.rbt on the CPU.

``jax.random`` and ``torch.Generator`` draw different streams, so the
diagonals are not a parity class: the parity tests draw slate_tpu's
(``jax.random.PRNGKey(seed)``, through its own ``gerbt_array``) and feed
them to the port's ``_gerbt_apply`` / ``_gesv_rbt_with``, the functions the
port's public entry points call after their own draw.  Stated tolerances
(eps of the dtype):

- ``apply_butterfly`` and U^T A V within 4 depth eps max|x| of slate_tpu's
  (each level rounds two products and a sum, in another order);
- x within n eps kappa_2(A) max|x| of slate_tpu's (the same no-pivot LU of
  the same transformed matrix and one refinement step), eta < 100 n eps;
- the port's own draws: one seed gives the same diagonals twice, two
  ``generator=None`` calls differ, every entry in [e^-0.05, e^0.05].
"""

import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import rbt as jrbt
from slate_tpu.types import Option as JOption
from slate_tpu_torch.linalg import rbt as trbt
from slate_tpu_torch.linalg.lu import LUFactors
from slate_tpu_torch.types import Option

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()
    gc.collect()


def _eps(dtype):
    return float(np.finfo(np.dtype(dtype)).eps)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand(shape, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _eta(a, x, b):
    a, x, b = (np.asarray(v, np.float64) for v in (a, x, b))
    r = np.abs(a @ x - b).max()
    return r / (np.abs(a).max() * np.abs(x).max() * a.shape[0] + np.abs(b).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("trans", [False, True])
def test_apply_butterfly_matches_jax(trans, depth, dtype):
    n = 64
    diags = jrbt.generate_butterfly(jax.random.PRNGKey(depth), n, depth, dtype)
    x = _rand((n, 3), 1, dtype)
    want = np.asarray(jrbt.apply_butterfly(jnp.asarray(x), diags, trans))
    got = trbt.apply_butterfly(_t(x), _t(diags), trans)
    assert got.dtype == _t(x).dtype and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= 4 * depth * _eps(dtype) * np.abs(x).max()
    got1 = trbt.apply_butterfly(_t(x[:, 0]), _t(diags), trans)  # a vector
    assert got1.shape == (n,) and torch.equal(got1, got[:, 0])


@pytest.mark.parametrize("n", [64, 61])
@pytest.mark.parametrize("depth", [1, 2])
def test_gerbt_apply_matches_jax(n, depth):
    a = _rand((n, n), 2)
    uav, ud, vd, npad = jrbt.gerbt_array(jnp.asarray(a), key=jax.random.PRNGKey(7), depth=depth)
    assert npad == trbt._pad_pow2(n, depth) == ud.shape[1]
    got = trbt._gerbt_apply(_t(a), _t(ud), _t(vd))
    assert got.shape == (npad, npad)
    assert np.abs(got.numpy() - np.asarray(uav)).max() <= 4 * depth * _eps(np.float64) * np.abs(a).max()
    assert _t(a).equal(torch.from_numpy(a))  # the operand is left as it was


@pytest.mark.parametrize("depth,n,dtype", [(1, 64, np.float64), (2, 64, np.float32),
                                           (1, 61, np.float32), (2, 61, np.float64)])
def test_gesv_rbt_with_reference_diagonals_matches_jax(depth, n, dtype):
    a = _rand((n, n), 3, dtype)
    b = _rand((n, 4), 4, dtype)
    key = jax.random.PRNGKey(11 + depth)
    opts = {JOption.Depth: depth}
    xj, fj = jrbt.gesv_rbt_array(jnp.asarray(a), jnp.asarray(b), opts=opts, key=key)
    _, ud, vd, _ = jrbt.gerbt_array(jnp.asarray(a), key=key, depth=depth)  # the diagonals it drew
    xt, ft = trbt._gesv_rbt_with(_t(a), _t(b), _t(ud), _t(vd))
    assert isinstance(ft, trbt.RBTFactors) and isinstance(ft.lu_factors, LUFactors)
    assert (ft.n, ft.npad) == (fj.n, fj.npad) == (n, trbt._pad_pow2(n, depth))
    assert int(ft.info) == int(fj.info) == 0
    eps = _eps(dtype)
    kappa = np.linalg.cond(a.astype(np.float64))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= n * eps * kappa * np.abs(xj).max()
    assert _eta(a, xt.numpy(), b) < 100 * n * eps and _eta(a, xj, b) < 100 * n * eps
    # the factors against a fresh right-hand side, as a matrix and as a vector
    b2 = _rand((n, 2), 5, dtype)
    x2, x2j = ft.solve(_t(b2)), np.asarray(fj.solve(jnp.asarray(b2)))
    assert np.abs(x2.numpy() - x2j).max() <= n * eps * kappa * np.abs(x2j).max()
    assert _eta(a, x2.numpy(), b2) < 100 * n * eps
    x1 = ft.solve(_t(b2[:, 0]))
    assert x1.shape == (n,)
    assert np.abs(x1.numpy() - x2j[:, 0]).max() <= n * eps * kappa * np.abs(x2j).max()


def test_gesv_rbt_vector_rhs_and_singular_transform():
    n = 32
    a = _rand((n, n), 6)
    b = _rand((n,), 7)
    key = jax.random.PRNGKey(3)
    xj, _ = jrbt.gesv_rbt_array(jnp.asarray(a), jnp.asarray(b), key=key)
    _, ud, vd, _ = jrbt.gerbt_array(jnp.asarray(a), key=key, depth=2)
    xt, _ = trbt._gesv_rbt_with(_t(a), _t(b), _t(ud), _t(vd))
    assert xt.shape == (n,)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= n * _eps(np.float64) * np.linalg.cond(a) \
        * np.abs(np.asarray(xj)).max()
    # a singular A: the no-pivot LU of U^T A V reports it as slate_tpu does
    z = np.zeros((n, n))
    _, fz = jrbt.gesv_rbt_array(jnp.asarray(z), jnp.asarray(b), key=key)
    _, ftz = trbt._gesv_rbt_with(_t(z), _t(b), _t(ud), _t(vd))
    assert int(ftz.info) == int(fz.info) != 0


def test_port_draws():
    n, depth = 61, 2
    a = torch.from_numpy(_rand((n, n), 8))
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    uav1, ud1, vd1, np1 = trbt.gerbt_array(a, generator=g1, depth=depth)
    uav2, ud2, vd2, np2 = trbt.gerbt_array(a, generator=g2, depth=depth)
    assert np1 == np2 == 64 and ud1.shape == vd1.shape == (depth, 64)
    assert torch.equal(ud1, ud2) and torch.equal(vd1, vd2) and torch.equal(uav1, uav2)
    assert not torch.equal(ud1, vd1)
    assert torch.equal(uav1, trbt._gerbt_apply(a, ud1, vd1))
    _, uf1, _, _ = trbt.gerbt_array(a)
    _, uf2, _, _ = trbt.gerbt_array(a)
    assert not torch.equal(uf1, uf2)  # generator=None: fresh entropy each call
    lo, hi = math.exp(-0.05), math.exp(0.05)
    for dt in (torch.float32, torch.float64, torch.complex64):
        d = trbt.generate_butterfly(torch.Generator().manual_seed(1), 4096, 3, dt)
        assert d.dtype == dt and d.shape == (3, 4096)
        re = d.real.double() if d.is_complex() else d.double()
        if d.is_complex():
            assert not d.imag.any()
        # the bounds themselves round to the dtype: one f32 ulp of slack
        assert lo - 1e-7 <= float(re.min()) and float(re.max()) <= hi + 1e-7
        assert float(re.max() - re.min()) > 0.09  # the draw spans its range
    # the public solve draws, then takes the path the parity tests hold
    b = torch.from_numpy(_rand((n, 3), 9))
    x, f = trbt.gesv_rbt_array(a, b, opts={Option.Depth: 1}, generator=torch.Generator().manual_seed(2))
    assert f.ud.shape == (1, 62) and int(f.info) == 0
    xw, _ = trbt._gesv_rbt_with(a, b, f.ud, f.vd)
    assert torch.equal(x, xw)
    assert _eta(a.numpy(), x.numpy(), b.numpy()) < 100 * n * _eps(np.float64)
