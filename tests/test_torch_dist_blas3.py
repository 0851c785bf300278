"""The port's mesh BLAS-3 (slate_tpu_torch.parallel.dist_blas3) against
slate_tpu.parallel.dist_blas3.

The same seeded numpy operands go through ``slate_tpu`` on the 8 forced CPU
devices (a 2 x 4 mesh) and through the port on a virtual 2 x 4 mesh on the
CPU: transpose_dist, hemm_summa (HemmA and HemmC, both sides, Hermitian and
symmetric, either stored triangle with the other poisoned), trmm_dist and
her2k_dist / syr2k_dist, in f32, f64, complex64 and complex128 at a ragged
n = 60 (nb = 8).  Products hold to 10 k eps max|A| max|B| against
``slate_tpu`` and against the f64 / c128 product; the transpose is bitwise.
Bitwise as well: select_hemm_method, the audited comm bytes (slate_tpu's
kernels traced afresh with ``jax.make_jaxpr`` on tile sizes no other test
uses), the port's lookahead 0/1/2 and psum/ring/doubling invariance, and
TF32 off inside every product.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import types as jt
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_blas3 as jb3
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu_torch import types as tt
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import (
    from_dense,
    hemm_summa,
    her2k_dist,
    make_mesh,
    syr2k_dist,
    to_dense,
    transpose_dist,
    trmm_dist,
)

mm = importlib.import_module("slate_tpu_torch.ops.matmul")

torch.set_num_threads(1)

NB = 8
N, NRHS = 60, 20  # ragged: 60 = 7.5 tiles of 8
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _wide(x):
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


def _tol(k, dtype, *scales):
    """10 k eps times the operands' magnitudes."""
    return 10 * k * float(np.finfo(dtype).eps) * float(np.prod([max(s, 1e-300) for s in scales]))


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    monkeypatch.delenv(tcomm.BCAST_IMPL_ENV, raising=False)


# ---------------------------------------------------------------------------
# transpose_dist: bitwise
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_transpose(dtype_name, conj):
    a = _rand((N, 44), np.dtype(dtype_name).type, 1)
    return np.asarray(jto_dense(jb3.transpose_dist(jfrom_dense(jnp.asarray(a), _jmesh(), NB),
                                                   conj=conj)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("conj", [False, True])
def test_transpose_dist_bitwise(dtype, conj):
    a = _rand((N, 44), dtype, 1)
    d = transpose_dist(from_dense(_t(a), _tmesh(), NB), conj=conj)
    assert (d.m, d.n, d.diag_pad) == (44, N, False)
    out = to_dense(d).numpy()
    np.testing.assert_array_equal(out, a.conj().T if conj else a.T)
    np.testing.assert_array_equal(out, _jax_transpose(np.dtype(dtype).name, conj))


# ---------------------------------------------------------------------------
# hemm_summa / symm
# ---------------------------------------------------------------------------


def _hemm_operands(dtype, uplo_name, conj, side_name, seed=2):
    g = _rand((N, N), dtype, seed)
    herm = (g + g.conj().T) / 2 if conj else (g + g.T) / 2
    stored = herm.copy()
    dead = (np.triu(np.ones((N, N), bool), 1) if uplo_name == "Lower"
            else np.tril(np.ones((N, N), bool), -1))
    stored[dead] = 1e6  # the kernel must never read the dead triangle
    bshape = (N, NRHS) if side_name == "Left" else (NRHS, N)
    b = _rand(bshape, dtype, seed + 1)
    c = _rand(bshape, dtype, seed + 2)
    return herm.astype(dtype), stored.astype(dtype), b, c


ALPHA, BETA = 1.5 - 0.5j, 0.25 + 1j


def _scalars(dtype):
    if np.dtype(dtype).kind == "c":
        return ALPHA, BETA
    return ALPHA.real, BETA.real


@functools.lru_cache(maxsize=None)
def _jax_hemm(dtype_name, uplo_name, conj, method_name, side_name):
    dtype = np.dtype(dtype_name).type
    _, stored, b, c = _hemm_operands(dtype, uplo_name, conj, side_name)
    alpha, beta = _scalars(dtype)
    mesh = _jmesh()
    out = jb3.hemm_summa(jt.Side[side_name], alpha, jfrom_dense(jnp.asarray(stored), mesh, NB),
                         jfrom_dense(jnp.asarray(b), mesh, NB), beta,
                         jfrom_dense(jnp.asarray(c), mesh, NB), uplo=jt.Uplo[uplo_name],
                         conj=conj, method=jt.MethodHemm[method_name])
    return np.asarray(jto_dense(out))


def _port_hemm(dtype, uplo, conj, method, side, **opts):
    herm, stored, b, c = _hemm_operands(dtype, uplo.name, conj, side.name)
    alpha, beta = _scalars(dtype)
    mesh = _tmesh()
    out = hemm_summa(side, alpha, from_dense(_t(stored), mesh, NB), from_dense(_t(b), mesh, NB),
                     beta, from_dense(_t(c), mesh, NB), uplo=uplo, conj=conj, method=method,
                     **opts)
    hw, bw = _wide(herm), _wide(b)
    ref = alpha * (hw @ bw if side == tt.Side.Left else bw @ hw) + beta * _wide(c)
    tol = _tol(N, dtype, abs(alpha), np.abs(herm).max(), np.abs(b).max()) \
        + _tol(1, dtype, abs(beta), np.abs(c).max())
    return to_dense(out).numpy(), ref, tol


# slate_tpu parity on a spread of the cases (each is one more compiled mesh
# program there); every case is held to the f64 / c128 product
JAX_HEMM = {("complex128", "Lower", True, "HemmC"), ("complex128", "Upper", True, "HemmA"),
            ("complex64", "Upper", True, "HemmC"), ("complex64", "Lower", True, "HemmA"),
            ("float32", "Lower", False, "HemmC"), ("float64", "Upper", False, "HemmA")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", [tt.Uplo.Lower, tt.Uplo.Upper])
@pytest.mark.parametrize("conj", [True, False])
@pytest.mark.parametrize("method", [tt.MethodHemm.HemmC, tt.MethodHemm.HemmA])
def test_hemm_left_matches_reference(dtype, uplo, conj, method):
    got, ref, tol = _port_hemm(dtype, uplo, conj, method, tt.Side.Left)
    assert np.abs(got - ref).max() <= tol
    key = (np.dtype(dtype).name, uplo.name, conj, method.name)
    if key in JAX_HEMM:
        want = _jax_hemm(*key, "Left")
        assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("uplo", [tt.Uplo.Lower, tt.Uplo.Upper])
@pytest.mark.parametrize("method", [tt.MethodHemm.HemmC, tt.MethodHemm.HemmA])
def test_hemm_right_matches_reference(dtype, uplo, method):
    conj = np.dtype(dtype).kind == "c"
    got, ref, tol = _port_hemm(dtype, uplo, conj, method, tt.Side.Right)
    assert np.abs(got - ref).max() <= tol
    key = (np.dtype(dtype).name, uplo.name, conj, method.name)
    if key in {("complex128", "Lower", True, "HemmC"), ("float32", "Upper", False, "HemmA")}:
        assert np.abs(got - _jax_hemm(*key, "Right")).max() <= tol


@pytest.mark.parametrize("m,n", [(1, 1), (4, 1), (7, 1), (8, 2), (8, 3), (16, 4), (16, 5),
                                 (64, 4), (64, 16), (64, 17), (3, 8), (0, 0)])
def test_select_hemm_method_bitwise(m, n):
    assert tt.select_hemm_method(m, n).name == jt.select_hemm_method(m, n).name


def test_hemm_auto_selects_stationary_a_for_a_thin_panel():
    # 16 tile rows against one tile column (padded to lcm(2, 4) = 4): HemmA,
    # bitwise the pinned call
    g = _rand((128, 128), np.complex128, 5)
    h = (g + g.conj().T) / 2
    b = _rand((128, 8), np.complex128, 6)
    mesh = _tmesh()
    hd, bd = from_dense(_t(h), mesh, NB), from_dense(_t(b), mesh, NB)
    assert tt.select_hemm_method(hd.mt, bd.nt) == tt.MethodHemm.HemmA
    auto = to_dense(hemm_summa(tt.Side.Left, 2.0, hd, bd)).numpy()
    pinned = to_dense(hemm_summa(tt.Side.Left, 2.0, hd, bd, method=tt.MethodHemm.HemmA)).numpy()
    np.testing.assert_array_equal(auto, pinned)
    assert np.abs(auto - 2 * h @ b).max() <= _tol(128, np.complex128, 2, np.abs(h).max(),
                                                   np.abs(b).max())


def test_hemm_shape_mismatch_raises():
    mesh = _tmesh()
    a = from_dense(_t(_rand((16, 16), np.float64, 0)), mesh, NB)
    b = from_dense(_t(_rand((24, 8), np.float64, 1)), mesh, NB)
    with pytest.raises(ValueError):
        hemm_summa(tt.Side.Left, 1.0, a, b)


# ---------------------------------------------------------------------------
# trmm_dist
# ---------------------------------------------------------------------------


def _trmm_operands(dtype, side_name, seed=7):
    a = _rand((N, N), dtype, seed)
    b = _rand((N, NRHS) if side_name == "Left" else (NRHS, N), dtype, seed + 1)
    return a, b


@functools.lru_cache(maxsize=None)
def _jax_trmm(dtype_name, side_name, uplo_name, op_name, diag_name):
    a, b = _trmm_operands(np.dtype(dtype_name).type, side_name)
    mesh = _jmesh()
    alpha = _scalars(np.dtype(dtype_name).type)[0]
    out = jb3.trmm_dist(jt.Side[side_name], jt.Uplo[uplo_name], jt.Op[op_name],
                        jt.Diag[diag_name], alpha, jfrom_dense(jnp.asarray(a), mesh, NB),
                        jfrom_dense(jnp.asarray(b), mesh, NB))
    return np.asarray(jto_dense(out))


JAX_TRMM = {("complex128", "Left", "Lower", "ConjTrans", "Unit"),
            ("float32", "Left", "Upper", "NoTrans", "NonUnit"),
            ("complex64", "Left", "Upper", "Trans", "NonUnit"),
            ("complex128", "Right", "Lower", "ConjTrans", "NonUnit"),
            ("float64", "Right", "Upper", "NoTrans", "Unit")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("side", [tt.Side.Left, tt.Side.Right])
@pytest.mark.parametrize("uplo", [tt.Uplo.Lower, tt.Uplo.Upper])
@pytest.mark.parametrize("op", [tt.Op.NoTrans, tt.Op.Trans, tt.Op.ConjTrans])
@pytest.mark.parametrize("diag", [tt.Diag.NonUnit, tt.Diag.Unit])
def test_trmm_matches_reference(dtype, side, uplo, op, diag):
    a, b = _trmm_operands(dtype, side.name)
    alpha = _scalars(dtype)[0]
    mesh = _tmesh()
    out = trmm_dist(side, uplo, op, diag, alpha, from_dense(_t(a), mesh, NB),
                    from_dense(_t(b), mesh, NB))
    got = to_dense(out).numpy()
    t = np.tril(_wide(a)) if uplo == tt.Uplo.Lower else np.triu(_wide(a))
    if diag == tt.Diag.Unit:
        np.fill_diagonal(t, 1)
    opt = {tt.Op.NoTrans: t, tt.Op.Trans: t.T, tt.Op.ConjTrans: t.conj().T}[op]
    ref = alpha * (opt @ _wide(b) if side == tt.Side.Left else _wide(b) @ opt)
    tol = _tol(N, dtype, abs(alpha), np.abs(a).max(), np.abs(b).max())
    assert np.abs(got - ref).max() <= tol
    key = (np.dtype(dtype).name, side.name, uplo.name, op.name, diag.name)
    if key in JAX_TRMM:
        assert np.abs(got - _jax_trmm(*key)).max() <= tol


# ---------------------------------------------------------------------------
# her2k_dist / syr2k_dist
# ---------------------------------------------------------------------------

K = 44  # ragged k: the contraction is masked to 44 of 48 padded columns


def _her2k_operands(dtype, seed=11):
    return _rand((N, K), dtype, seed), _rand((N, K), dtype, seed + 1), \
        _rand((N, N), dtype, seed + 2)


@functools.lru_cache(maxsize=None)
def _jax_her2k(dtype_name, conj, full, uplo_name):
    dtype = np.dtype(dtype_name).type
    a, b, c = _her2k_operands(dtype)
    alpha, beta = _scalars(dtype)
    mesh = _jmesh()
    out = jb3.her2k_dist(alpha, jfrom_dense(jnp.asarray(a), mesh, NB),
                         jfrom_dense(jnp.asarray(b), mesh, NB), beta,
                         jfrom_dense(jnp.asarray(c), mesh, NB), uplo=jt.Uplo[uplo_name],
                         conj=conj, full=full)
    return np.asarray(jto_dense(out)), bool(out.diag_pad)


JAX_HER2K = {("complex128", True, False, "Lower"), ("complex64", False, True, "Upper"),
             ("float32", True, False, "Upper"), ("float64", False, True, "Lower")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("conj", [True, False])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("uplo", [tt.Uplo.Lower, tt.Uplo.Upper])
def test_her2k_matches_reference(dtype, conj, full, uplo):
    a, b, c = _her2k_operands(dtype)
    alpha, beta = _scalars(dtype)
    mesh = _tmesh()
    ad, bd, cd = (from_dense(_t(x), mesh, NB) for x in (a, b, c))
    if conj:
        out = her2k_dist(alpha, ad, bd, beta, cd, uplo=uplo, full=full)
    else:
        out = syr2k_dist(alpha, ad, bd, beta, cd, uplo=uplo, full=full)
    got = to_dense(out).numpy()
    h = (lambda x: x.conj().T) if conj else (lambda x: x.T)
    aw, bw = _wide(a), _wide(b)
    prod = alpha * aw @ h(bw) + (np.conj(alpha) if conj else alpha) * bw @ h(aw)
    if not full:
        prod = np.tril(prod) if uplo == tt.Uplo.Lower else np.triu(prod)
    ref = prod + beta * _wide(c)
    tol = _tol(K, dtype, 2 * abs(alpha), np.abs(a).max(), np.abs(b).max()) \
        + _tol(1, dtype, abs(beta), np.abs(c).max())
    assert np.abs(got - ref).max() <= tol
    assert out.diag_pad is False  # 60 rows on 8 tiles of 8: the grid is padded
    key = (np.dtype(dtype).name, conj, full, uplo.name)
    if key in JAX_HER2K:
        want, pad = _jax_her2k(*key)
        assert np.abs(got - want).max() <= tol
        assert out.diag_pad == pad


def test_her2k_diag_pad_when_unpadded():
    mesh = _tmesh()
    a = from_dense(_t(_rand((64, 24), np.float64, 3)), mesh, NB)
    assert her2k_dist(1.0, a, a).diag_pad is True


def test_her2k_layout_mismatch_raises():
    mesh = _tmesh()
    a = from_dense(_t(_rand((64, 24), np.float64, 3)), mesh, NB)
    b = from_dense(_t(_rand((64, 16), np.float64, 4)), mesh, NB)
    with pytest.raises(ValueError):
        her2k_dist(1.0, a, b)


# ---------------------------------------------------------------------------
# invariants of the port's own forms (slate_tpu proves them for its own:
# tests/test_lookahead.py, tests/test_bcast.py)
# ---------------------------------------------------------------------------


def _runs(fn):
    outs = {f"la{la}": fn(lookahead=la) for la in (0, 1, 2)}
    outs.update({impl: fn(bcast_impl=impl) for impl in ("psum", "ring", "doubling")})
    return outs


@pytest.mark.parametrize("case", ["hemm", "symm_upper", "trmm_trans", "trmm_right",
                                  "her2k", "syr2k_full"])
def test_lookahead_and_bcast_impl_bitwise(case):
    mesh = _tmesh()
    dtype = np.complex128

    def run(**opts):
        if case in ("hemm", "symm_upper"):
            conj = case == "hemm"
            uplo = tt.Uplo.Lower if conj else tt.Uplo.Upper
            _, stored, b, _ = _hemm_operands(dtype, uplo.name, conj, "Left")
            d = hemm_summa(tt.Side.Left, ALPHA, from_dense(_t(stored), mesh, NB),
                           from_dense(_t(b), mesh, NB), uplo=uplo, conj=conj,
                           method=tt.MethodHemm.HemmC, **opts)
        elif case.startswith("trmm"):
            side = tt.Side.Right if case == "trmm_right" else tt.Side.Left
            a, b = _trmm_operands(dtype, side.name)
            d = trmm_dist(side, tt.Uplo.Upper, tt.Op.ConjTrans, tt.Diag.NonUnit, ALPHA,
                          from_dense(_t(a), mesh, NB), from_dense(_t(b), mesh, NB), **opts)
        else:
            a, b, _ = _her2k_operands(dtype)
            f = her2k_dist if case == "her2k" else syr2k_dist
            d = f(ALPHA, from_dense(_t(a), mesh, NB), from_dense(_t(b), mesh, NB),
                  full=case == "syr2k_full", **opts)
        return to_dense(d).numpy()

    outs = _runs(run)
    base = outs["la1"]
    for k, v in outs.items():
        np.testing.assert_array_equal(v, base, err_msg=k)


def test_products_run_with_tf32_off(monkeypatch):
    """Every product of the slice runs inside ``ops.matmul._tf32_scope`` at
    Precision.Highest (TF32 off for an f32 product on the card; here the
    scope stands in as the card's: the flag set False inside), with the
    flag set True around the calls, and the flag comes back."""
    import slate_tpu_torch.parallel.dist_blas3 as db3

    seen, scopes = [], []
    flags = torch.backends.cuda.matmul

    def scope_spy(a, precision):
        scopes.append(precision)
        assert a.dtype == torch.float32
        return mm._tf32(precision == tt.Precision.High)

    monkeypatch.setattr(db3, "_tf32_scope", scope_spy)
    for name in ("matmul", "bmm"):
        orig = getattr(torch, name)

        def spy(*args, _orig=orig, **kw):
            seen.append(flags.allow_tf32)
            return _orig(*args, **kw)

        monkeypatch.setattr(torch, name, spy)
    orig_baddbmm = torch.Tensor.baddbmm_

    def spy_baddbmm(self, *args, **kw):
        seen.append(flags.allow_tf32)
        return orig_baddbmm(self, *args, **kw)

    monkeypatch.setattr(torch.Tensor, "baddbmm_", spy_baddbmm)
    from slate_tpu_torch.parallel import herk_dist, trsm_dist_right

    mesh = _tmesh()
    dtype = np.float32
    _, stored, b, _ = _hemm_operands(dtype, "Lower", False, "Left")
    a, bt = _trmm_operands(dtype, "Right")
    old = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        sd, bd = from_dense(_t(stored), mesh, NB), from_dense(_t(b), mesh, NB)
        for method in (tt.MethodHemm.HemmC, tt.MethodHemm.HemmA):
            hemm_summa(tt.Side.Left, 1.0, sd, bd, conj=False, method=method)
        ad, btd = from_dense(_t(a), mesh, NB), from_dense(_t(bt), mesh, NB)
        trmm_dist(tt.Side.Left, tt.Uplo.Lower, tt.Op.NoTrans, tt.Diag.NonUnit, 1.0, ad, bd)
        her2k_dist(1.0, ad, ad)
        herk_dist(1.0, ad)
        tw = from_dense(_t(np.tril(a) + N * np.eye(N, dtype=dtype)), mesh, NB, diag_pad_one=True)
        trsm_dist_right(tw, btd)
        assert flags.allow_tf32 is True
    finally:
        flags.allow_tf32 = old
    assert seen and not any(seen), seen
    assert scopes and set(scopes) == {tt.Precision.Highest}, scopes


# ---------------------------------------------------------------------------
# comm audit: bytes per op equal to slate_tpu's, per lowering (slate_tpu's
# jitted kernels traced afresh through their __wrapped__ functions, on tile
# sizes no other test uses)
# ---------------------------------------------------------------------------


def _totals(records):
    out = {}
    for op, nbytes, mult in records:
        out[op] = out.get(op, 0) + nbytes * mult
    return out


def _jtrace(fn, static, *args):
    with jcomm.comm_audit() as rec:
        jax.make_jaxpr(fn.__wrapped__, static_argnums=static)(*args)
    return _totals(rec)


def _tport(fn):
    with tcomm.comm_audit() as rec:
        fn()
    return _totals(rec)


AUDIT_NB = 6
AN, AK = 44, 26  # 8 x 5 -> 8 x 8 tiles of 6 (padded)


def _audit_operands(dtype=np.float64):
    a = _rand((AN, AN), dtype, 21)
    b = _rand((AN, AK), dtype, 22)
    return a, b


@pytest.mark.parametrize("impl", ["psum", "ring", "doubling"])
def test_hemm_c_and_trmm_audit_bytes_match_jax(impl):
    a, b = _audit_operands()
    p, q, nb = 2, 4, AUDIT_NB
    jmesh, tmesh = _jmesh(), _tmesh()
    ja, jbd = jfrom_dense(jnp.asarray(a), jmesh, nb), jfrom_dense(jnp.asarray(b), jmesh, nb)
    want = {}
    for conj, uplo in ((True, jt.Uplo.Lower), (False, jt.Uplo.Upper)):
        for op, n_ in _jtrace(jb3._hemm_jit, (5, 6, 7, 8, 9, 10, 11, 12), ja.tiles, jbd.tiles,
                              None, 1.0, 0.0, jmesh, p, q, ja.nt, uplo, conj, 1, impl).items():
            want[op] = want.get(op, 0) + n_
    for op_ in (jt.Op.NoTrans, jt.Op.Trans):
        for op, n_ in _jtrace(jb3._trmm_jit, (3, 4, 5, 6, 7, 8, 9, 10, 11), ja.tiles, jbd.tiles,
                              1.0, jmesh, p, q, ja.nt, jt.Uplo.Lower, op_, jt.Diag.Unit, 2,
                              impl).items():
            want[op] = want.get(op, 0) + n_
    ta, tbd = from_dense(_t(a), tmesh, nb), from_dense(_t(b), tmesh, nb)

    def port():
        for conj, uplo in ((True, tt.Uplo.Lower), (False, tt.Uplo.Upper)):
            hemm_summa(tt.Side.Left, 1.0, ta, tbd, uplo=uplo, conj=conj,
                       method=tt.MethodHemm.HemmC, lookahead=1, bcast_impl=impl)
        for op_ in (tt.Op.NoTrans, tt.Op.Trans):
            trmm_dist(tt.Side.Left, tt.Uplo.Lower, op_, tt.Diag.Unit, 1.0, ta, tbd, lookahead=2,
                      bcast_impl=impl)

    got = _tport(port)
    assert want and got == want
    assert any(op.startswith("ppermute") for op in got) == (impl != "psum")


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_hemm_a_and_transpose_audit_bytes_match_jax(dtype):
    a, b = _audit_operands(dtype)
    p, q, nb = 2, 4, AUDIT_NB
    jmesh, tmesh = _jmesh(), _tmesh()
    ja, jbd = jfrom_dense(jnp.asarray(a), jmesh, nb), jfrom_dense(jnp.asarray(b), jmesh, nb)
    want = _jtrace(jb3._hemm_a_jit, (5, 6, 7, 8, 9), ja.tiles, jbd.tiles, None, 1.0, 0.0, jmesh,
                   p, q, jt.Uplo.Lower, True)
    for op, n_ in _jtrace(jb3._transpose_jit, (1, 2, 3, 4), jbd.tiles, jmesh, p, q,
                          True).items():
        want[op] = want.get(op, 0) + n_
    ta, tbd = from_dense(_t(a), tmesh, nb), from_dense(_t(b), tmesh, nb)
    got = _tport(lambda: (hemm_summa(tt.Side.Left, 1.0, ta, tbd, method=tt.MethodHemm.HemmA),
                          transpose_dist(tbd, conj=True)))
    assert want and got == want
    assert set(got) == {"all_gather[p]", "all_gather[q]", "psum_scatter[p]", "psum_scatter[q]"}


@pytest.mark.parametrize("impl", ["psum", "ring"])
def test_her2k_audit_bytes_match_jax(impl):
    a, b = _audit_operands(np.complex128)
    p, q, nb = 2, 4, AUDIT_NB
    jmesh, tmesh = _jmesh(), _tmesh()
    ja, jbd = jfrom_dense(jnp.asarray(b), jmesh, nb), jfrom_dense(jnp.asarray(b * 2), jmesh, nb)
    want = _jtrace(jb3._her2k_jit, (5, 6, 7, 8, 9, 10, 11, 12, 13, 14), ja.tiles, jbd.tiles,
                   None, 1.0, 0.0, jmesh, p, q, ja.nt, AK, jt.Uplo.Lower, True, False, 1, impl)
    ta, tbd = from_dense(_t(b), tmesh, nb), from_dense(_t(b * 2), tmesh, nb)
    got = _tport(lambda: her2k_dist(1.0, ta, tbd, lookahead=1, bcast_impl=impl))
    assert want and got == want
