"""The port's herk_dist and mesh condition estimators
(slate_tpu_torch.parallel.dist_aux) against slate_tpu.parallel.dist_aux.

The same seeded numpy operands go through ``slate_tpu`` on the 8 forced CPU
devices (a 2 x 4 mesh) and through the port on a virtual 2 x 4 mesh on the
CPU.  herk_dist in f32, f64, complex64 and complex128 (ragged n and k,
full and one triangle) holds to 10 k eps max|A|^2; gecondest_dist and
pocondest_dist hold to 1e-12 (f64) / 1e-5 (f32) relative against
``slate_tpu`` on the same factor, against the port's single-chip
estimators and across the broadcast lowerings (bitwise).  The audited comm
bytes of herk and of the estimators' probe loop (2 iters + 1 trips, the
two solves of its ``lax.cond`` both counted) equal ``slate_tpu``'s, traced
afresh with ``jax.make_jaxpr`` on tile sizes no other test uses.  The
condest memo hits on a repeated call, misses on another probe
configuration, on a write in place and on a write past the version
counter.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_devices

from slate_tpu import types as jt
from slate_tpu.parallel import comm as jcomm
from slate_tpu.parallel import dist_aux as jaux
from slate_tpu.parallel import from_dense as jfrom_dense
from slate_tpu.parallel import make_mesh as jmake_mesh
from slate_tpu.parallel import to_dense as jto_dense
from slate_tpu.parallel.dist_chol import potrf_dist as jpotrf_dist
from slate_tpu.parallel.dist_lu import getrf_pp_dist as jgetrf_pp_dist
from slate_tpu.utils.testing import generate
from slate_tpu_torch import types as tt
from slate_tpu_torch.linalg import gecondest, getrf_array, pocondest, potrf_array
from slate_tpu_torch.obs import metrics as tmetrics
from slate_tpu_torch.ops import kernels as tk
from slate_tpu_torch.parallel import comm as tcomm
from slate_tpu_torch.parallel import (
    DistMatrix,
    from_dense,
    gecondest_dist,
    getrf_pp_dist,
    herk_dist,
    make_mesh,
    norm_dist,
    pocondest_dist,
    potrf_dist,
    to_dense,
)

torch.set_num_threads(1)

NB = 8
N = 48
DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _jmesh():
    return jmake_mesh(2, 4, devices=cpu_devices(8))


def _tmesh():
    return make_mesh(2, 4, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _rand(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


def _rtol(dtype):
    return 1e-5 if np.dtype(dtype) in (np.float32, np.complex64) else 1e-12


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    for env in (tk.PANEL_IMPL_ENV, tk.UPDATE_IMPL_ENV, tcomm.BCAST_IMPL_ENV):
        monkeypatch.delenv(env, raising=False)


# ---------------------------------------------------------------------------
# herk_dist
# ---------------------------------------------------------------------------

HN, HK = 60, 36  # ragged n and k (the k mask keeps 36 of 40 padded columns)


@functools.lru_cache(maxsize=None)
def _jax_herk(dtype_name, full, uplo_name):
    dtype = np.dtype(dtype_name).type
    a, c = _rand((HN, HK), dtype, 1), _rand((HN, HN), dtype, 2)
    mesh = _jmesh()
    out = jaux.herk_dist(0.5, jfrom_dense(jnp.asarray(a), mesh, NB), 2.0,
                         jfrom_dense(jnp.asarray(c), mesh, NB), uplo=jt.Uplo[uplo_name],
                         full=full)
    return np.asarray(jto_dense(out)), bool(out.diag_pad)


JAX_HERK = {("complex128", False, "Lower"), ("float32", True, "Upper")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("uplo", [tt.Uplo.Lower, tt.Uplo.Upper])
def test_herk_dist_matches_reference(dtype, full, uplo):
    a, c = _rand((HN, HK), dtype, 1), _rand((HN, HN), dtype, 2)
    mesh = _tmesh()
    out = herk_dist(0.5, from_dense(_t(a), mesh, NB), 2.0, from_dense(_t(c), mesh, NB),
                    uplo=uplo, full=full)
    got = to_dense(out).numpy()
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    prod = 0.5 * a.astype(wide) @ a.astype(wide).conj().T
    if not full:
        prod = np.tril(prod) if uplo == tt.Uplo.Lower else np.triu(prod)
    ref = prod + 2.0 * c.astype(wide)
    eps = float(np.finfo(dtype).eps)
    tol = 10 * HK * eps * np.abs(a).max() ** 2 + 10 * eps * 2 * np.abs(c).max()
    assert np.abs(got - ref).max() <= tol
    assert out.diag_pad is False and (out.m, out.n) == (HN, HN)
    key = (np.dtype(dtype).name, full, uplo.name)
    if key in JAX_HERK:
        want, pad = _jax_herk(*key)
        assert np.abs(got - want).max() <= tol
        assert pad == out.diag_pad


def test_herk_dist_residual_check():
    # the reference's own check (tests/test_parallel.py): A A^H full and the
    # lower triangle only, real f64
    a = generate("randn", 64, 40, seed=3)
    mesh = _tmesh()
    ad = from_dense(_t(a), mesh, NB)
    full = to_dense(herk_dist(1.0, ad, full=True)).numpy()
    low = to_dense(herk_dist(1.0, ad, uplo=tt.Uplo.Lower)).numpy()
    np.testing.assert_allclose(full, a @ a.T, atol=1e-12)
    np.testing.assert_allclose(low, np.tril(a @ a.T), atol=1e-12)
    assert herk_dist(1.0, ad).diag_pad is True


def test_herk_dist_layout_mismatch_raises():
    mesh = _tmesh()
    ad = from_dense(_t(_rand((64, 16), np.float64, 0)), mesh, NB)
    cd = from_dense(_t(_rand((64, 16), np.float64, 1)), mesh, NB)
    with pytest.raises(ValueError):
        herk_dist(1.0, ad, 1.0, cd)


@pytest.mark.parametrize("impl", ["psum", "ring", "doubling"])
def test_herk_dist_bcast_impl_bitwise(impl):
    a = _rand((HN, HK), np.complex128, 4)
    mesh = _tmesh()
    ad = from_dense(_t(a), mesh, NB)
    base = to_dense(herk_dist(1.0, ad, full=True, bcast_impl="psum")).numpy()
    np.testing.assert_array_equal(to_dense(herk_dist(1.0, ad, full=True, bcast_impl=impl)).numpy(),
                                  base)


# ---------------------------------------------------------------------------
# condition estimators
# ---------------------------------------------------------------------------


def _svd_matrix(dtype, seed, cond, spd=False):
    """U diag(s) V^H with s from 1 down to 1 / cond (V = U when ``spd``),
    U and V unitary: real for a real dtype, complex for a complex one."""
    rng = np.random.default_rng(seed)
    cplx = np.dtype(dtype).kind == "c"

    def unitary():
        g = rng.standard_normal((N, N))
        if cplx:
            g = g + 1j * rng.standard_normal((N, N))
        return np.linalg.qr(g)[0]

    u = unitary()
    v = u if spd else unitary()
    s = np.logspace(0, -np.log10(cond), N)
    a = (u * s) @ v.conj().T
    if spd:
        a = (a + a.conj().T) / 2
    return a.astype(dtype)


@functools.lru_cache(maxsize=None)
def _jax_ge_factor(dtype_name):
    a = _svd_matrix(np.dtype(dtype_name).type, 7, 1e6)
    mesh = _jmesh()
    lu, perm, info = jgetrf_pp_dist(jfrom_dense(jnp.asarray(a), mesh, NB, diag_pad_one=True),
                                    panel_impl="xla", num_monitor="off")
    anorm = jaux.norm_dist(jt.Norm.One, jfrom_dense(jnp.asarray(a), mesh, NB))
    return a, lu, np.asarray(perm), int(info), float(anorm)


@pytest.mark.parametrize("dtype,norm", [(np.float64, "One"), (np.complex128, "One"),
                                        (np.float32, "Inf")])
def test_gecondest_dist_matches_jax_on_the_same_factor(dtype, norm):
    a, jlu, perm, info, anorm = _jax_ge_factor(np.dtype(dtype).name)
    assert info == 0
    want = float(jaux.gecondest_dist(jlu, jnp.asarray(perm), anorm, jt.Norm[norm]))
    lud = DistMatrix(tiles=_t(np.asarray(jlu.tiles)), m=N, n=N, nb=NB, mesh=_tmesh(),
                     diag_pad=True)
    got = float(gecondest_dist(lud, _t(perm), anorm, tt.Norm[norm]))
    assert got == pytest.approx(want, rel=_rtol(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_gecondest_dist_matches_single_chip_and_brackets_kappa(dtype):
    a = _svd_matrix(dtype, 7, 1e6)
    mesh = _tmesh()
    lu, perm, info = getrf_pp_dist(from_dense(_t(a), mesh, NB, diag_pad_one=True),
                                   panel_impl="xla")
    assert int(info) == 0
    anorm = norm_dist(tt.Norm.One, from_dense(_t(a), mesh, NB))
    rc_d = float(gecondest_dist(lu, perm, anorm))
    rc_s = float(gecondest(tt.Norm.One, getrf_array(_t(a)), anorm))
    assert rc_d == pytest.approx(rc_s, rel=1e-6)
    # Hager-Higham underestimates ||A^-1||_1, so rcond >= 1 / kappa_1, and
    # not by more than a small factor
    kappa = np.abs(a).sum(axis=0).max() * np.abs(np.linalg.inv(a)).sum(axis=0).max()
    assert 1 / kappa * (1 - 1e-12) <= rc_d < 10 / kappa
    _, jlu, jperm, _, janorm = _jax_ge_factor(np.dtype(dtype).name)
    assert rc_d == pytest.approx(float(jaux.gecondest_dist(jlu, jnp.asarray(jperm), janorm)),
                                 rel=_rtol(dtype))


@functools.lru_cache(maxsize=None)
def _jax_po(dtype_name):
    a = _svd_matrix(np.dtype(dtype_name).type, 8, 1e5, spd=True)
    mesh = _jmesh()
    l, info = jpotrf_dist(jfrom_dense(jnp.asarray(a), mesh, NB, diag_pad_one=True),
                          panel_impl="xla", num_monitor="off")
    anorm = jaux.norm_dist(jt.Norm.One, jfrom_dense(jnp.asarray(a), mesh, NB))
    return a, l, int(info), float(anorm), float(jaux.pocondest_dist(l, anorm))


@pytest.mark.parametrize("dtype", [np.float64, np.complex64])
def test_pocondest_dist_matches_jax_single_chip_and_impl_bitwise(dtype):
    a, jl, info, anorm, want = _jax_po(np.dtype(dtype).name)
    assert info == 0
    mesh = _tmesh()
    ld = DistMatrix(tiles=_t(np.asarray(jl.tiles)), m=N, n=N, nb=NB, mesh=mesh, diag_pad=True)
    rc = {impl: float(pocondest_dist(ld, anorm, bcast_impl=impl))
          for impl in ("psum", "ring", "doubling")}
    assert rc["psum"] == rc["ring"] == rc["doubling"]
    assert rc["ring"] == pytest.approx(want, rel=_rtol(dtype))
    # the port's own factor, against its single-chip estimator (in f64: in
    # f32 two factors of a cond-1e5 matrix differ by ~cond eps32)
    l, tinfo = potrf_dist(from_dense(_t(a), mesh, NB, diag_pad_one=True), panel_impl="xla")
    assert int(tinfo) == 0
    if dtype == np.float64:
        f, _ = potrf_array(_t(a), tt.Uplo.Lower)
        rc_s = float(pocondest(tt.Norm.One, f, anorm))
        assert float(pocondest_dist(l, anorm)) == pytest.approx(rc_s, rel=1e-6)


def _spd_factor(n=64, seed=5):
    a = generate("spd", n, seed=seed)
    mesh = _tmesh()
    l, info = potrf_dist(from_dense(_t(a), mesh, NB, diag_pad_one=True))
    assert int(info) == 0
    return l, norm_dist(tt.Norm.One, from_dense(_t(a), mesh, NB))


def _hits():
    return tmetrics.serve_counts()["condest_cache_hits"]


def test_condest_memo_on_factor():
    # the reference's check (tests/test_serve.py): a repeat hits once, a
    # different probe configuration is its own memo row
    l, anorm = _spd_factor()
    h0 = _hits()
    r1 = pocondest_dist(l, anorm)
    r2 = pocondest_dist(l, anorm)
    assert float(r1) == float(r2) and _hits() - h0 == 1
    r3 = pocondest_dist(l, anorm, iters=3)
    assert _hits() - h0 == 1 and float(r3) > 0


def test_condest_memo_misses_after_a_write_past_the_version_counter():
    # the factor's tiles overwritten in place by another factor (copy_
    # moves the version counter): the memo misses and estimates again
    l, anorm = _spd_factor()
    r1 = float(pocondest_dist(l, anorm))
    h0 = _hits()
    other, _ = _spd_factor(seed=6)
    version = l.tiles._version
    l.tiles.copy_(other.tiles)
    assert l.tiles._version > version
    r2 = float(pocondest_dist(l, anorm))
    assert _hits() == h0 and r2 != r1
    assert float(pocondest_dist(l, anorm)) == r2 and _hits() == h0 + 1  # the new entry


def test_condest_memo_misses_after_a_write_in_place():
    mesh = _tmesh()
    a = _svd_matrix(np.float64, 9, 1e4)
    lu, perm, info = getrf_pp_dist(from_dense(_t(a), mesh, NB, diag_pad_one=True))
    anorm = norm_dist(tt.Norm.One, from_dense(_t(a), mesh, NB))
    r1 = float(gecondest_dist(lu, perm, anorm))
    h0 = _hits()
    assert float(gecondest_dist(lu, perm, anorm)) == r1 and _hits() == h0 + 1
    lu.tiles[0, 0, 0, 0] *= 4.0  # bumps the version counter
    assert float(gecondest_dist(lu, perm, anorm)) != r1 and _hits() == h0 + 1


# ---------------------------------------------------------------------------
# comm audit: bytes per op equal to slate_tpu's (fresh traces, nb = 6 / 10)
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


@pytest.mark.parametrize("impl", ["psum", "doubling"])
def test_herk_audit_bytes_match_jax(impl):
    n, k, nb = 44, 26, 6
    a = _rand((n, k), np.float64, 31)
    jmesh, tmesh = _jmesh(), _tmesh()
    ja = jfrom_dense(jnp.asarray(a), jmesh, nb)
    want = _jtrace(jaux._herk_jit, (4, 5, 6, 7, 8, 9, 10, 11), ja.tiles, None, 1.0, 0.0, jmesh,
                   2, 4, ja.nt, k, jt.Uplo.Lower, False, impl)
    got = _tport(lambda: herk_dist(1.0, from_dense(_t(a), tmesh, nb), bcast_impl=impl))
    assert want and got == want


@pytest.mark.parametrize("estimator,impl,nb", [("ge", "ring", 6), ("ge", "psum", 10),
                                               ("po", "doubling", 6), ("po", "psum", 10)])
def test_condest_audit_bytes_match_jax(estimator, impl, nb):
    # the recorded bytes do not depend on the values: any identity-padded
    # triangle pair and a permutation stand in for the factor
    n = 44
    a = generate("randn", n, seed=41) + n * np.eye(n)
    jmesh, tmesh = _jmesh(), _tmesh()
    jd = jfrom_dense(jnp.asarray(a), jmesh, nb, diag_pad_one=True)
    td = from_dense(_t(a), tmesh, nb, diag_pad_one=True)
    mglob = jd.mt * nb
    perm = np.random.default_rng(42).permutation(mglob)
    if estimator == "ge":
        want = _jtrace(jaux._gecondest_jit, (3, 4, 5, 6, 7, 8, 9), jd.tiles, jnp.asarray(perm),
                       jnp.asarray(3.0, jnp.float64), jmesh, n, nb, False, 0, impl, 5)
        got = _tport(lambda: gecondest_dist(td, _t(perm), 3.0, bcast_impl=impl))
    else:
        want = _jtrace(jaux._pocondest_jit, (2, 3, 4, 5, 6, 7), jd.tiles,
                       jnp.asarray(3.0, jnp.float64), jmesh, n, nb, 0, impl, 5)
        got = _tport(lambda: pocondest_dist(td, 3.0, bcast_impl=impl))
    assert want and got == want
