"""The port's norm drivers and condition estimators (slate_tpu_torch.linalg.
norms) against slate_tpu.linalg.norms.

The same seeded numpy operands on the CPU.  ``norm`` over every matrix
kind (general with each NormScope, Hermitian, symmetric, triangular,
trapezoid, band, triangular band, Hermitian band) and ``col_norms``: Max
bitwise for real entries, the sums within n eps relative.  The
Higham-Tisseur estimator ``norm1est``: the probe index sequence (the unit
vector each power step sends through the solve) bitwise, the estimate
within n eps relative; ``gecondest`` (One and Inf, on LU factors carried
across), ``pocondest`` and ``trcondest`` within n eps relative, and the
estimate against the exact 1 / kappa_1 of a small matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.core import matrix as jm
from slate_tpu.linalg import chol as jchol
from slate_tpu.linalg import lu as jlu
from slate_tpu.linalg import norms as jnorms
from slate_tpu.types import Diag as JDiag
from slate_tpu.types import Norm as JNorm
from slate_tpu.types import NormScope as JScope
from slate_tpu.types import Op as JOp
from slate_tpu.types import Uplo as JUplo
from slate_tpu.utils.testing import generate
from slate_tpu_torch.core import matrix as tm
from slate_tpu_torch.linalg import lu as tlu
from slate_tpu_torch.linalg import norms as tnorms
from slate_tpu_torch.types import Diag, Norm, NormScope, Op, Uplo
from slate_tpu_torch.utils.testing import lufactors_from_numpy

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

N = 48


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _close(got, want, dtype, n=N):
    got, want = float(got), float(want)
    assert abs(got - want) <= n * _eps(dtype) * abs(want), (got, want)


def _kinds(a):
    """(name, slate_tpu view, port view) for every matrix kind norm takes."""
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    lo, up = (JUplo.Lower, Uplo.Lower), (JUplo.Upper, Uplo.Upper)
    return [
        ("general", jm.Matrix.from_array(ja), tm.Matrix.from_array(ta)),
        ("hermitian", jm.HermitianMatrix.from_array(ja, lo[0]),
         tm.HermitianMatrix.from_array(ta, lo[1])),
        ("symmetric", jm.SymmetricMatrix.from_array(ja, up[0]),
         tm.SymmetricMatrix.from_array(ta, up[1])),
        ("triangular", jm.TriangularMatrix.from_array(ja, up[0], JDiag.Unit),
         tm.TriangularMatrix.from_array(ta, up[1], Diag.Unit)),
        ("trapezoid", jm.TrapezoidMatrix.from_array(ja[:, :30], lo[0]),
         tm.TrapezoidMatrix.from_array(ta[:, :30], lo[1])),
        ("band", jm.BandMatrix.from_array(ja, 3, 5), tm.BandMatrix.from_array(ta, 3, 5)),
        ("triangular_band", jm.TriangularBandMatrix.from_array(ja, lo[0], 4),
         tm.TriangularBandMatrix.from_array(ta, lo[1], 4)),
        ("hermitian_band", jm.HermitianBandMatrix.from_array(ja, up[0], 2),
         tm.HermitianBandMatrix.from_array(ta, up[1], 2)),
    ]


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64, np.complex128])
def test_norm_over_every_matrix_kind(dtype):
    a = generate("randn", N, dtype=dtype, seed=3)
    for name, jv, tv in _kinds(a):
        assert type(tv).__name__ == type(jv).__name__
        np.testing.assert_array_equal(tv.data.numpy(), np.asarray(jv.data))  # the band projection
        for norm in Norm:
            got = tnorms.norm(norm, tv)
            want = jnorms.norm(JNorm[norm.name], jv)
            if norm == Norm.Max and np.isrealobj(a):
                assert float(got) == float(want), (name, norm)
            else:
                _close(got, want, dtype)
    ta = torch.from_numpy(a)
    for scope in (NormScope.Columns, NormScope.Rows):
        for norm in (Norm.Max, Norm.One):
            got = tnorms.norm(norm, ta, scope).numpy()
            want = np.asarray(jnorms.norm(JNorm[norm.name], jnp.asarray(a), JScope[scope.name]))
            assert np.all(np.abs(got - want) <= N * _eps(dtype) * np.abs(want))
    got, want = tnorms.col_norms(ta).numpy(), np.asarray(jnorms.col_norms(jnp.asarray(a)))
    assert np.all(np.abs(got - want) <= _eps(dtype) * np.abs(want))
    assert tnorms.norm(Norm.One, a, device="cpu").device.type == "cpu"


def _recorded(fn, log):
    def wrapped(x):
        log.append(int(np.argmax(np.abs(np.asarray(x)))))
        return fn(x)
    return wrapped


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
def test_norm1est_probe_sequence(dtype):
    """norm1est of A^-1 through the same factors: the unit vector of every
    power step (and the first, flat probe) bitwise, the estimate within
    n eps; it never exceeds ||A^-1||_1."""
    a = generate("rands", N, dtype=dtype, seed=5) + 2 * np.eye(N, dtype=dtype)
    jf = jlu.getrf_array(jnp.asarray(a))
    tf = lufactors_from_numpy(np.asarray(jf.lu), np.asarray(jf.perm), jf.info, device="cpu")
    jlog, tlog = [], []
    jest = jnorms.norm1est(
        _recorded(lambda x: jlu.getrs_array(jf, x[:, None])[:, 0], jlog),
        lambda x: jlu.getrs_array(jf, x[:, None], JOp.ConjTrans)[:, 0], N, dtype)
    test = tnorms.norm1est(
        _recorded(lambda x: tlu.getrs_array(tf, x[:, None])[:, 0], tlog),
        lambda x: tlu.getrs_array(tf, x[:, None], Op.ConjTrans)[:, 0], N,
        tf.lu.dtype, device="cpu")
    assert tlog == jlog and len(tlog) == 6  # five power steps + the alternating probe
    _close(test, jest, dtype)
    exact = np.abs(np.linalg.inv(a.astype(np.complex128))).sum(axis=0).max()
    assert float(test) <= exact * (1 + N * _eps(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_condition_estimates_match_jax(dtype):
    a = generate("rands", N, dtype=dtype, seed=7) + 2 * np.eye(N, dtype=dtype)
    jf = jlu.getrf_array(jnp.asarray(a))
    tf = lufactors_from_numpy(np.asarray(jf.lu), np.asarray(jf.perm), jf.info, device="cpu")
    for norm in (Norm.One, Norm.Inf):
        anorm = np.abs(a).sum(axis=0 if norm == Norm.One else 1).max()
        got = tnorms.gecondest(norm, tf, anorm)
        want = jnorms.gecondest(JNorm[norm.name], jf, anorm)
        assert got.dtype == torch.float64
        _close(got, want, dtype)
    with pytest.raises(ValueError, match="One and Inf"):
        tnorms.gecondest(Norm.Fro, tf, 1.0)
    spd = generate("spd", N, dtype=dtype, seed=8)
    anorm = np.abs(spd).sum(axis=0).max()
    lj, _ = jchol.potrf_array(jnp.asarray(spd))
    lt = torch.from_numpy(np.array(lj))
    _close(tnorms.pocondest(Norm.One, lt, anorm), jnorms.pocondest(JNorm.One, lj, anorm), dtype)
    tri = np.tril(a)
    for norm in (Norm.One, Norm.Inf):
        got = tnorms.trcondest(norm, torch.from_numpy(tri))
        want = jnorms.trcondest(JNorm[norm.name], jnp.asarray(tri))
        _close(got, want, dtype)
    tv = tm.TriangularMatrix.from_array(torch.from_numpy(np.triu(a)), Uplo.Upper)
    jv = jm.TriangularMatrix.from_array(jnp.asarray(np.triu(a)), JUplo.Upper)
    _close(tnorms.trcondest(Norm.One, tv, 3.0), jnorms.trcondest(JNorm.One, jv, 3.0), dtype)


def test_gecondest_against_the_exact_condition_number():
    """On a small, badly scaled matrix the estimate lies within a factor 3
    of the exact 1 / kappa_1 (the estimator's classic bound on such
    inputs), and a singular factor gives 0."""
    n = 24
    a = generate("svd", n, dtype=np.float64, seed=9, cond=1e6)
    tf = tlu.getrf_array(torch.from_numpy(a))
    anorm = np.abs(a).sum(axis=0).max()
    exact = 1.0 / (anorm * np.abs(np.linalg.inv(a)).sum(axis=0).max())
    est = float(tnorms.gecondest(Norm.One, tf, anorm))
    assert exact <= est <= 3 * exact
    assert float(tnorms._recondest(torch.tensor(0.0, dtype=torch.float64),
                                   torch.tensor(5.0, dtype=torch.float64))) == 0.0
