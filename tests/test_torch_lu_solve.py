"""The port's LU solves, inverses and LU verbs (slate_tpu_torch.linalg.lu,
linalg.tri, api) against slate_tpu.

The same seeded numpy operands on the CPU.  ``getrs_array`` (NoTrans,
Trans, ConjTrans) and ``getri_array`` run on the same factors in both
packages: ``slate_tpu``'s ``LUFactors`` carried into the port by
``utils.testing.lufactors_from_numpy``.  Each solution passes the normwise
gate eta < 100 n eps and the componentwise omega < 10 sqrt(n) eps (the
residual in f64 / c128); the two packages' solutions agree to 100 n eps
max|x|.  ``gesv_array`` for every MethodLU, with perm and info bitwise (RBT, whose
butterflies are random in each package: the solve gates, agreement within
100 n eps kappa and its RBTFactors); ``getri_oop_array``; ``trtri_array``
and ``trtrm_array`` across the recursion; and the api's LU verbs with the
device rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu import api as japi
from slate_tpu.linalg import lu as jlu
from slate_tpu.linalg import tri as jtri
from slate_tpu.types import Diag as JDiag
from slate_tpu.types import MethodLU as JMethod
from slate_tpu.types import Op as JOp
from slate_tpu.types import Uplo as JUplo
from slate_tpu.utils.testing import generate
from slate_tpu_torch import api as tapi
from slate_tpu_torch.core.matrix import Matrix
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.linalg import tri as ttri
from slate_tpu_torch.types import Diag, MethodLU, Op, Option, Uplo
from slate_tpu_torch.utils.testing import lufactors_from_numpy

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N = 64


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _wide(dtype):
    return np.complex128 if np.issubdtype(dtype, np.complexfloating) else np.float64


def _gates(a, x, b):
    """(eta, omega) in units of their gates 100 n eps and 10 sqrt(n) eps,
    eps of the working precision, the residual in f64 / c128."""
    n, eps = a.shape[0], _eps(a.dtype)
    a, x, b = (v.astype(_wide(a.dtype)) for v in (a, x, b))
    r = np.abs(a @ x - b)
    eta = r.max() / (np.abs(a).max() * np.abs(x).max() * n + np.abs(b).max())
    omega = (r / (np.abs(a) @ np.abs(x) + np.abs(b))).max()
    return eta / (100 * n * eps), omega / (10 * np.sqrt(n) * eps)


def _operands(dtype, seed, nrhs=4):
    a = generate("rands", N, dtype=dtype, seed=seed)
    b = generate("rands", N, nrhs, dtype=dtype, seed=seed + 1)
    return a, b


def _op_matrix(a, op):
    return {Op.NoTrans: a, Op.Trans: a.T, Op.ConjTrans: a.conj().T}[op]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_getrs_on_carried_factors(dtype):
    a, b = _operands(dtype, 3)
    jf = jlu.getrf_array(jnp.asarray(a))
    tf = lufactors_from_numpy(np.asarray(jf.lu), np.asarray(jf.perm), jf.info, device="cpu")
    eps = _eps(dtype)
    for op in (Op.NoTrans, Op.Trans, Op.ConjTrans):
        xj = np.asarray(jlu.getrs_array(jf, jnp.asarray(b), JOp[op.name]))
        xt = tlu.getrs_array(tf, torch.from_numpy(b), op).numpy()
        eta, omega = _gates(_op_matrix(a, op), xt, b)
        assert eta < 1 and omega < 1, (op, eta, omega)
        assert np.abs(xt - xj).max() <= 100 * N * eps * np.abs(xj).max()


@pytest.mark.parametrize("method", [MethodLU.PartialPiv, MethodLU.CALU, MethodLU.NoPiv])
@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_gesv_methods_match_jax(method, dtype):
    a, b = _operands(dtype, 5)
    if method == MethodLU.NoPiv:
        a = a + N * np.eye(N, dtype=dtype)
    xj, fj = jlu.gesv_array(jnp.asarray(a), jnp.asarray(b), JMethod[method.name])
    xt, ft = tlu.gesv_array(torch.from_numpy(a), torch.from_numpy(b), method)
    np.testing.assert_array_equal(ft.perm.numpy(), np.asarray(fj.perm))
    assert int(ft.info) == int(fj.info) == 0
    eps = _eps(dtype)
    eta, omega = _gates(a, xt.numpy(), b)
    assert eta < 1 and omega < 1, (eta, omega)
    assert np.abs(xt.numpy() - np.asarray(xj)).max() <= 100 * N * eps * np.abs(np.asarray(xj)).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gesv_rbt_method_matches_jax(dtype):
    """MethodLU.RBT solves through linalg.rbt in both packages, each with
    its own random butterflies: both pass the solve gates, agree to
    100 n eps kappa max|x|, and return RBTFactors that solve a fresh
    right-hand side against the original A."""
    from slate_tpu_torch.linalg.rbt import RBTFactors

    a, b = _operands(dtype, 7)
    xj, fj = jlu.gesv_array(jnp.asarray(a), jnp.asarray(b), JMethod.RBT)
    xt, ft = tlu.gesv_array(torch.from_numpy(a), torch.from_numpy(b), MethodLU.RBT)
    assert isinstance(ft, RBTFactors) and type(fj).__name__ == "RBTFactors"
    assert int(ft.info) == int(fj.info) == 0
    eta, _ = _gates(a, xt.numpy(), b)
    assert eta < 1, eta
    eps, kappa = _eps(dtype), np.linalg.cond(a.astype(np.float64))
    xj = np.asarray(xj)
    assert np.abs(xt.numpy() - xj).max() <= 100 * N * eps * kappa * np.abs(xj).max()
    b2 = generate("rands", N, 2, dtype=dtype, seed=9)
    assert _gates(a, ft.solve(torch.from_numpy(b2)).numpy(), b2)[0] < 1


def test_lu_solve_rbt_matches_jax():
    a, b = _operands(np.float64, 8)
    xt = tapi.lu_solve(torch.from_numpy(a), torch.from_numpy(b), MethodLU.RBT)
    xj = np.asarray(japi.lu_solve(jnp.asarray(a), jnp.asarray(b), JMethod.RBT))
    assert xt.device.type == "cpu" and xt.shape == b.shape
    assert _gates(a, xt.numpy(), b)[0] < 1
    assert np.abs(xt.numpy() - xj).max() <= 100 * N * _eps(np.float64) * np.linalg.cond(a) \
        * np.abs(xj).max()


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_getri_on_carried_factors(dtype):
    a = generate("rands", N, dtype=dtype, seed=11) + 4 * np.eye(N, dtype=dtype)
    jf = jlu.getrf_array(jnp.asarray(a))
    tf = lufactors_from_numpy(np.asarray(jf.lu), np.asarray(jf.perm), jf.info, device="cpu")
    xj = np.asarray(jlu.getri_array(jf))
    xt = tlu.getri_array(tf).numpy()
    eps = _eps(dtype)
    assert np.abs(a @ xt - np.eye(N)).max() < 100 * N * eps * np.abs(a).max() * np.abs(xt).max()
    assert np.abs(xt - xj).max() <= 100 * N * eps * np.abs(xj).max()
    inv_j, info_j = jlu.getri_oop_array(jnp.asarray(a))
    inv_t, info_t = tlu.getri_oop_array(torch.from_numpy(a))
    assert int(info_t) == int(info_j) == 0
    assert np.abs(inv_t.numpy() - np.asarray(inv_j)).max() <= 100 * N * eps * np.abs(xj).max()


@pytest.mark.parametrize("uplo,diag", [(Uplo.Lower, Diag.NonUnit), (Uplo.Upper, Diag.Unit)])
def test_trtri_trtrm_match_jax(uplo, diag):
    """n = 300 > 256: one level of the recursion and the solve leaves."""
    n = 300
    t = generate("rands", n, dtype=np.float64, seed=12) + 8 * np.eye(n)
    tj = np.asarray(jtri.trtri_array(jnp.asarray(t), JUplo[uplo.name], JDiag[diag.name]))
    tt = ttri.trtri_array(torch.from_numpy(t), uplo, diag).numpy()
    assert np.abs(tt - tj).max() <= 100 * n * _eps(np.float64) * np.abs(tj).max()
    tri = np.tril(t) if uplo == Uplo.Lower else np.triu(t)
    if diag == Diag.Unit:
        np.fill_diagonal(tri, 1)
    assert np.abs(tri @ tt - np.eye(n)).max() < 100 * n * _eps(np.float64) * np.abs(tt).max()
    mj = np.asarray(jtri.trtrm_array(jnp.asarray(t), JUplo[uplo.name]))
    mt = ttri.trtrm_array(torch.from_numpy(t), uplo).numpy()
    assert np.abs(mt - mj).max() <= 100 * n * _eps(np.float64) * np.abs(mj).max()
    np.testing.assert_array_equal(mt == 0, mj == 0)  # the same triangle


def test_object_level_getrf_and_gesv():
    a, b = _operands(np.float64, 13)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    m, f = tlu.getrf(Matrix.from_array(ta))
    assert isinstance(m, Matrix) and torch.equal(m.data, f.lu)
    assert torch.equal(f.perm, tlu.getrf_array(ta).perm)
    _, fc = tlu.getrf(ta, opts={Option.MethodLU: MethodLU.CALU, Option.MaxPanelThreads: 2})
    jfc = jlu.getrf_tntpiv_array(jnp.asarray(a), nb=128)  # 64 x 2 threads
    np.testing.assert_array_equal(fc.perm.numpy(), np.asarray(jfc.perm))
    x, f2 = tlu.gesv(Matrix.from_array(ta), Matrix.from_array(tb))
    assert isinstance(x, Matrix) and torch.equal(f2.perm, f.perm)
    xj, _ = jlu.gesv(jnp.asarray(a), jnp.asarray(b))
    limit = 100 * N * _eps(np.float64) * np.abs(a).max()
    assert np.abs(x.data.numpy() - np.asarray(xj)).max() < limit


def test_lu_verbs():
    """api.lu_factor / lu_solve / lu_solve_using_factor / lu_inverse: the
    linalg functions on CPU tensors (and against slate_tpu's verbs); a
    numpy operand goes to the card, ``device="cpu"`` keeps it on the host."""
    a, b = _operands(np.float64, 17)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    f = tapi.lu_factor(ta)
    assert torch.equal(f.perm, tlu.getrf_array(ta).perm)
    for method in (MethodLU.CALU, MethodLU.NoPiv):
        fm = tapi.lu_factor(ta, method)
        fj = japi.lu_factor(jnp.asarray(a), JMethod[method.name])
        np.testing.assert_array_equal(fm.perm.numpy(), np.asarray(fj.perm))
    x = tapi.lu_solve(ta, tb)
    assert torch.equal(x, tlu.gesv_array(ta, tb)[0])
    assert torch.equal(tapi.lu_solve_using_factor(f, tb), x)
    xt = tapi.lu_solve_using_factor(f, tb, Op.Trans)
    assert np.abs(a.T @ xt.numpy() - b).max() < 1e-10
    inv = tapi.lu_inverse(ta)
    assert np.abs(inv.numpy() - np.asarray(japi.lu_inverse(jnp.asarray(a)))).max() < 1e-10
    assert torch.equal(tapi.lu_solve(a, b, device="cpu"), x)
    if torch.cuda.is_available():
        assert tapi.lu_solve(a, b).is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tapi.lu_solve(a, b)
