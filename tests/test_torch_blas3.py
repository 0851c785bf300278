"""The port's single-chip BLAS-3 verbs (slate_tpu_torch.blas3) and potri
against slate_tpu.

The same seeded numpy operands go through ``slate_tpu``'s hemm / symm /
herk / syrk / her2k / syr2k / trmm / gbmm / hbmm, potri and the api facades
and through the port's on the CPU, in f32, f64, complex64 and complex128.
Products hold to 10 k eps max|A| max|B| against ``slate_tpu`` and against
the f64 / c128 product (the untouched triangle of a rank-k update
bitwise); the inverse to 1e-5 (f32) / 1e-12 (f64) relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slate_tpu as st
from slate_tpu import api as japi
from slate_tpu.blas3 import blas3 as jb
from slate_tpu.linalg.chol import potrf_array as jpotrf_array
from slate_tpu.linalg.chol import potri_array as jpotri_array
from slate_tpu_torch import api as tapi
from slate_tpu_torch import types as tt
from slate_tpu_torch.blas3 import blas3 as tb
from slate_tpu_torch.core import matrix as tm
from slate_tpu_torch.linalg import chol as tchol

torch.set_num_threads(1)

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _wide(x):
    return np.asarray(x).astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _tol(k, dtype, *scales):
    return 10 * k * float(np.finfo(dtype).eps) * float(np.prod(scales))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _scalars(dtype):
    return (1.5 - 0.5j, 0.25 + 1j) if np.dtype(dtype).kind == "c" else (1.5, 0.25)


def _views(mod, kind, data, uplo_name):
    """slate_tpu's or the port's matrix view of ``data``."""
    if mod is st:
        return getattr(st, kind).from_array(jnp.asarray(data), st.Uplo[uplo_name])
    return getattr(tm, kind).from_array(_t(data), tt.Uplo[uplo_name])


# ---------------------------------------------------------------------------
# hemm / symm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("verb", ["hemm", "symm"])
def test_hemm_symm_match_jax(dtype, uplo, side, verb):
    n, k = 20, 15
    g = _rand((n, n), dtype, 4)
    conj = verb == "hemm"
    full = (g + g.conj().T) / 2 if conj else (g + g.T) / 2
    stored = np.tril(full) if uplo == "Lower" else np.triu(full)
    shape = (n, k) if side == "Left" else (k, n)
    b, c = _rand(shape, dtype, 5), _rand(shape, dtype, 6)
    alpha, beta = _scalars(dtype)
    kind = "HermitianMatrix" if conj else "SymmetricMatrix"
    j = getattr(st, verb)(st.Side[side], alpha, _views(st, kind, stored, uplo),
                          st.Matrix.from_array(jnp.asarray(b)), beta,
                          st.Matrix.from_array(jnp.asarray(c)))
    t = getattr(tb, verb)(tt.Side[side], alpha, _views(tm, kind, stored, uplo),
                          tm.Matrix.from_array(_t(b)), beta, tm.Matrix.from_array(_t(c)))
    fw = _wide(full)
    ref = alpha * (fw @ _wide(b) if side == "Left" else _wide(b) @ fw) + beta * _wide(c)
    tol = _tol(n, dtype, abs(alpha), np.abs(full).max(), np.abs(b).max()) \
        + _tol(1, dtype, abs(beta), np.abs(c).max())
    got = _np(t.array)
    assert np.abs(got - ref).max() <= tol
    assert np.abs(got - _np(j.array)).max() <= tol


# ---------------------------------------------------------------------------
# herk / syrk / her2k / syr2k: the stored triangle updated, the other untouched
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("verb", ["herk", "syrk", "her2k", "syr2k"])
def test_rank_k_updates_match_jax(dtype, uplo, verb):
    n, k = 18, 9
    a, b = _rand((n, k), dtype, 7), _rand((n, k), dtype, 8)
    c0 = _rand((n, n), dtype, 9)
    conj = verb.startswith("her")
    c0 = (c0 + c0.conj().T) / 2 if conj else (c0 + c0.T) / 2
    cstore = np.tril(c0) if uplo == "Lower" else np.triu(c0)
    cstore = cstore + (np.triu(np.full((n, n), 7.0), 1) if uplo == "Lower"
                       else np.tril(np.full((n, n), 7.0), -1)).astype(dtype)  # the other triangle
    alpha = _scalars(dtype)[0] if verb in ("her2k", "syr2k") else 2.0
    kind = "HermitianMatrix" if conj else "SymmetricMatrix"
    args = {"herk": lambda m, x, y: (alpha, m.Matrix.from_array(x(a))),
            "syrk": lambda m, x, y: (alpha, m.Matrix.from_array(x(a))),
            "her2k": lambda m, x, y: (alpha, m.Matrix.from_array(x(a)), m.Matrix.from_array(x(b))),
            "syr2k": lambda m, x, y: (alpha, m.Matrix.from_array(x(a)), m.Matrix.from_array(x(b)))}
    j = getattr(st, verb)(*args[verb](st, jnp.asarray, None), 3.0, _views(st, kind, cstore, uplo))
    t = getattr(tb, verb)(*args[verb](tm, _t, None), 3.0, _views(tm, kind, cstore, uplo))
    h = (lambda x: x.conj().T) if conj else (lambda x: x.T)
    aw, bw = _wide(a), _wide(b)
    if verb in ("herk", "syrk"):
        upd = alpha * aw @ h(aw)
    else:
        upd = alpha * aw @ h(bw) + (np.conj(alpha) if conj else alpha) * bw @ h(aw)
    ref = upd + 3.0 * _wide(c0)
    got = _np(t.data)
    keep = np.tril(np.ones((n, n), bool)) if uplo == "Lower" else np.triu(np.ones((n, n), bool))
    tol = _tol(k, dtype, 2 * abs(alpha), np.abs(a).max(), np.abs(b).max()) \
        + _tol(1, dtype, 3.0, np.abs(c0).max())
    assert np.abs(got[keep] - ref[keep]).max() <= tol
    np.testing.assert_array_equal(got[~keep], cstore[~keep])  # never written
    assert np.abs(got - _np(j.data)).max() <= tol
    assert type(t).__name__ == type(j).__name__ and t.uplo.name == j.uplo.name


def test_herk_plain_tensor_c():
    # a plain C: its (uplo) triangle is replaced, the other kept
    a, c = _rand((12, 5), np.float64, 1), _rand((12, 12), np.float64, 2)
    got = tb.herk(1.0, _t(a), 0.5, _t(c), tt.Uplo.Upper).numpy()
    want = np.asarray(jb.herk(1.0, jnp.asarray(a), 0.5, jnp.asarray(c), st.Uplo.Upper))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# trmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
@pytest.mark.parametrize("op", ["NoTrans", "Trans", "ConjTrans"])
@pytest.mark.parametrize("diag", ["NonUnit", "Unit"])
def test_trmm_array_all_variants_match_jax(dtype, side, uplo, op, diag):
    n, k = 21, 9
    a = _rand((n, n), dtype, 17)
    b = _rand((n, k) if side == "Left" else (k, n), dtype, 18)
    alpha = _scalars(dtype)[0]
    t = tb.trmm_array(tt.Side[side], tt.Uplo[uplo], tt.Op[op], tt.Diag[diag], alpha, _t(a), _t(b))
    tri = np.tril(_wide(a)) if uplo == "Lower" else np.triu(_wide(a))
    if diag == "Unit":
        np.fill_diagonal(tri, 1)
    opt = {"NoTrans": tri, "Trans": tri.T, "ConjTrans": tri.conj().T}[op]
    ref = alpha * (opt @ _wide(b) if side == "Left" else _wide(b) @ opt)
    tol = _tol(n, dtype, abs(alpha), np.abs(a).max(), np.abs(b).max())
    assert np.abs(t.numpy() - ref).max() <= tol
    if np.dtype(dtype) in (np.float32, np.complex128):  # slate_tpu on half the cases
        j = jb.trmm_array(st.Side[side], st.Uplo[uplo], st.Op[op], st.Diag[diag], alpha,
                          jnp.asarray(a), jnp.asarray(b))
        assert np.abs(t.numpy() - np.asarray(j)).max() <= tol


@pytest.mark.parametrize("uplo", ["Lower", "Upper"])
def test_trmm_recursive_blocks_match_jax(uplo):
    # n > _TRMM_DENSE_MAX: the recursive split (1100 = 1024 + 76)
    n = 1100
    a = _rand((n, n), np.float64, 19) / np.sqrt(n)
    b = _rand((n, 3), np.float64, 20)
    t = tb.trmm_array(tt.Side.Left, tt.Uplo[uplo], tt.Op.NoTrans, tt.Diag.NonUnit, 1.0, _t(a),
                      _t(b)).numpy()
    j = np.asarray(jb.trmm_array(st.Side.Left, st.Uplo[uplo], st.Op.NoTrans, st.Diag.NonUnit,
                                 1.0, jnp.asarray(a), jnp.asarray(b)))
    tri = np.tril(a) if uplo == "Lower" else np.triu(a)
    tol = _tol(n, np.float64, np.abs(a).max(), np.abs(b).max())
    assert np.abs(t - tri @ b).max() <= tol and np.abs(t - j).max() <= tol


def test_trmm_view_wraps_like_b():
    a, b = _rand((10, 10), np.float64, 1), _rand((10, 4), np.float64, 2)
    view = tm.TriangularMatrix.from_array(_t(a), tt.Uplo.Upper, tt.Diag.Unit)
    out = tb.trmm(tt.Side.Left, 2.0, view, tm.Matrix.from_array(_t(b)))
    jout = st.trmm(st.Side.Left, 2.0, st.TriangularMatrix.from_array(jnp.asarray(a), st.Uplo.Upper,
                                                                     st.Diag.Unit),
                   st.Matrix.from_array(jnp.asarray(b)))
    assert isinstance(out, tm.Matrix)
    np.testing.assert_allclose(out.array.numpy(), np.asarray(jout.array), rtol=0, atol=1e-13)


# ---------------------------------------------------------------------------
# gbmm / hbmm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_gbmm_hbmm_match_jax(dtype):
    n, kl, ku = 30, 4, 2
    a = _rand((n, n), dtype, 21)
    b, c = _rand((n, 6), dtype, 22), _rand((n, 6), dtype, 23)
    jg = st.gbmm(1.5, st.BandMatrix.from_array(jnp.asarray(a), kl, ku),
                 st.Matrix.from_array(jnp.asarray(b)), 0.5, st.Matrix.from_array(jnp.asarray(c)))
    tg = tb.gbmm(1.5, tm.BandMatrix.from_array(_t(a), kl, ku), tm.Matrix.from_array(_t(b)), 0.5,
                 tm.Matrix.from_array(_t(c)))
    i, jj = np.indices((n, n))
    band = np.where((jj - i <= ku) & (i - jj <= kl), _wide(a), 0)
    tol = _tol(n, dtype, 1.5, np.abs(a).max(), np.abs(b).max()) + _tol(1, dtype, np.abs(c).max())
    assert np.abs(tg.array.numpy() - (1.5 * band @ _wide(b) + 0.5 * _wide(c))).max() <= tol
    assert np.abs(tg.array.numpy() - np.asarray(jg.array)).max() <= tol
    kd = 3
    for side in ("Left", "Right"):
        bb = b if side == "Left" else b.T.copy()
        cc = c if side == "Left" else c.T.copy()
        jh = st.hbmm(st.Side[side], 1.5, st.HermitianBandMatrix.from_array(jnp.asarray(a),
                                                                          st.Uplo.Lower, kd),
                     st.Matrix.from_array(jnp.asarray(bb)), 0.5,
                     st.Matrix.from_array(jnp.asarray(cc)))
        th = tb.hbmm(tt.Side[side], 1.5, tm.HermitianBandMatrix.from_array(_t(a), tt.Uplo.Lower, kd),
                     tm.Matrix.from_array(_t(bb)), 0.5, tm.Matrix.from_array(_t(cc)))
        assert np.abs(th.array.numpy() - np.asarray(jh.array)).max() <= tol
    # a plain tensor: the dense product (gbmm) and the lower triangle (hbmm)
    np.testing.assert_allclose(tb.gbmm(1.0, _t(a), _t(b), 0.0, _t(c)).numpy(),
                               np.asarray(jb.gbmm(1.0, jnp.asarray(a), jnp.asarray(b), 0.0,
                                                  jnp.asarray(c))), rtol=0, atol=tol)
    np.testing.assert_allclose(tb.hbmm(tt.Side.Left, 1.0, _t(a), _t(b), 0.0, _t(c)).numpy(),
                               np.asarray(jb.hbmm(st.Side.Left, 1.0, jnp.asarray(a),
                                                  jnp.asarray(b), 0.0, jnp.asarray(c))),
                               rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# potri (tests/test_chol.py: test_potri) and the facades
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,uplo,n", [(dt, uplo, 40) for dt in DTYPES
                                          for uplo in ("Lower", "Upper")]
                         + [(np.float64, "Upper", 300), (np.complex64, "Lower", 300)])
def test_potri_matches_jax(dtype, uplo, n):  # n = 300: trtri's recursive split
    g = _rand((n, n), dtype, 7)
    a = (g @ g.conj().T / n + np.eye(n)).astype(dtype)
    stored = np.tril(a) if uplo == "Lower" else np.triu(a)
    f, info = tchol.potrf_array(_t(stored), tt.Uplo[uplo])
    assert int(info) == 0
    inv = tchol.potri_array(f, tt.Uplo[uplo]).numpy()
    jf, _ = jpotrf_array(jnp.asarray(stored), st.Uplo[uplo])
    jinv = np.asarray(jpotri_array(jf, st.Uplo[uplo]))
    tri = np.tril if uplo == "Lower" else np.triu
    full = tri(inv) + tri(inv, -1 if uplo == "Lower" else 1).conj().T
    rtol = 1e-5 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12
    wide = _wide(a)
    assert np.abs(full @ wide - np.eye(n)).max() < 100 * rtol
    assert np.abs(inv - jinv).max() / np.abs(jinv).max() < rtol
    assert np.abs(tri(inv) - inv).max() == 0  # only the uplo triangle is written
    view = tchol.potri(tm.TriangularMatrix(data=f, uplo=tt.Uplo[uplo]))
    assert isinstance(view, tm.HermitianMatrix) and torch.equal(view.data, _t(inv))
    np.testing.assert_array_equal(tapi.chol_inverse(f, tt.Uplo[uplo]).numpy(), inv)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_api_facades_match_jax(dtype):
    n = 16
    g = _rand((n, n), dtype, 31)
    h = (g + g.conj().T) / 2
    s = (g + g.T) / 2
    b = _rand((n, 5), dtype, 32)
    a = _rand((n, 7), dtype, 33)
    c = _rand((n, n), dtype, 34)
    tol = _tol(n, dtype, 4 * np.abs(g).max(), np.abs(b).max() + 1)
    lower = np.tril
    cases = [
        (tapi.hermitian_multiply(tt.Side.Left, 2.0, _t(lower(h)), _t(b), device="cpu"),
         japi.hermitian_multiply(st.Side.Left, 2.0, jnp.asarray(lower(h)), jnp.asarray(b))),
        (tapi.symmetric_multiply(tt.Side.Right, 2.0, _t(lower(s)), _t(b.T.copy()), device="cpu"),
         japi.symmetric_multiply(st.Side.Right, 2.0, jnp.asarray(lower(s)),
                                 jnp.asarray(b.T.copy()))),
        (tapi.triangular_multiply(tt.Side.Left, 2.0, _t(g), _t(b), device="cpu"),
         japi.triangular_multiply(st.Side.Left, 2.0, jnp.asarray(g), jnp.asarray(b))),
        (tapi.rank_k_update(2.0, _t(a), 0.5, _t(c), device="cpu"),
         japi.rank_k_update(2.0, jnp.asarray(a), 0.5, jnp.asarray(c))),
        (tapi.rank_2k_update(2.0, _t(a), _t(a[::-1].copy()), 0.5, _t(c), device="cpu"),
         japi.rank_2k_update(2.0, jnp.asarray(a), jnp.asarray(a[::-1].copy()), 0.5,
                             jnp.asarray(c))),
    ]
    for got, want in cases:
        assert got.device.type == "cpu"
        assert np.abs(got.numpy() - np.asarray(want)).max() <= tol


def test_facades_take_numpy_on_the_host_when_asked():
    b = _rand((8, 3), np.float64, 1)
    h = _rand((8, 8), np.float64, 2)
    out = tapi.hermitian_multiply(tt.Side.Left, 1.0, np.tril(h), b, device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    full = np.tril(h) + np.tril(h, -1).T
    np.testing.assert_allclose(out.numpy(), full @ b, rtol=0, atol=1e-13)
