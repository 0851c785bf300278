"""The port's SVD (slate_tpu_torch.linalg.svd: ge2tb, tb2bd, the
back-transforms, bdsqr, svd_array, svd_staged and the api facades) against
slate_tpu.linalg.svd on the CPU.

Stage by stage: ``tb2bd`` and the back-transforms are fed ``slate_tpu``'s
factors (``utils.testing.ge2tb_factors_from_numpy`` /
``tb2bd_factors_from_numpy``).  Tolerances, each with its reason (A's
entries O(1), eps of the dtype, k = max(m, n)):

- the band within 10 k eps max|A| (backward-stable panels, the same
  Householder loops);
- (d, e) from the same band: the bidiagonal's singular values within
  10 n eps ||A||_2 of the band's, for both packages, and the port's
  reflectors lift the bidiagonal's vectors back to the band within the
  same limit.  The entries themselves are compared by their spread only,
  recorded and not gated: a bulge chase's entries are forward-unstable (at
  (40, 33) f64 one d entry of 33 reads 1.2e-11 apart, the rest ~1e-14);
- the back-transforms on the same Z within 10 k eps max|Z|;
- s within 10 k eps s_max; A = U S V^H within 10 k eps ||A|| and U, V
  orthonormal within 10 k eps; U and V column by column, after fixing each
  pair's phase, within 10 k eps ||A|| / gap on singular values 1..n;
- the Golub-Kahan divide and conquer runs its chunked merge with
  ``_CHUNK_AT`` forced small in both packages, and the staged chase with
  ``_CHASE_SEGMENT_ABOVE`` forced small.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu import api as japi
from slate_tpu.linalg import svd as jsvd
from slate_tpu.linalg import tridiag as jtd
from slate_tpu_torch import api as tapi
from slate_tpu_torch.linalg import eig as teig
from slate_tpu_torch.linalg import svd as tsvd
from slate_tpu_torch.linalg import tridiag as ttd
from slate_tpu_torch.utils.testing import (
    ge2tb_factors_from_numpy,
    generate,
    tb2bd_factors_from_numpy,
)

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

C = 10


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mat(m, n, dtype, seed, separated=False):
    if separated:  # singular values 1..k: gaps of 1
        cdt = np.complex128 if np.iscomplexobj(np.zeros(1, dtype)) else np.float64
        u, _ = np.linalg.qr(generate("randn", m, m, dtype=cdt, seed=seed))
        v, _ = np.linalg.qr(generate("randn", n, n, dtype=cdt, seed=seed + 1))
        k = min(m, n)
        return ((u[:, :k] * np.arange(1, k + 1)) @ v[:, :k].conj().T).astype(dtype)
    return generate("randn", m, n, dtype=dtype, seed=seed)


@functools.lru_cache(maxsize=None)
def _jax_ge2tb(m, n, nb, dtype_name, seed):
    a = _mat(m, n, np.dtype(dtype_name).type, seed)
    f = jax.jit(jsvd.ge2tb, static_argnums=1)(jnp.asarray(a), nb)
    return a, tuple(np.asarray(x) for x in (f.band, f.vq, f.tq, f.vl, f.tl))


@functools.lru_cache(maxsize=None)
def _jsvd(nb=8, want_vectors=True):
    return jax.jit(functools.partial(jsvd.svd_array, want_vectors=want_vectors, nb=nb))


CASES = [(40, 33, 8, "float64"), (64, 64, 32, "float32"), (44, 40, 8, "complex128"),
         (48, 48, 8, "complex64")]


@pytest.mark.parametrize("m,n,nb,dtype", CASES)
def test_ge2tb_band_matches(m, n, nb, dtype):
    a, (band, vq, tq, vl, tl) = _jax_ge2tb(m, n, nb, dtype, 2)
    f = tsvd.ge2tb(_t(a), nb)
    k = max(m, n)
    tol = C * k * _eps(dtype) * np.abs(a).max()
    assert float(np.abs(f.band.numpy() - band).max()) <= tol
    for got, want in ((f.vq, vq), (f.tq, tq), (f.vl, vl), (f.tl, tl)):
        assert tuple(got.shape) == want.shape
    # Q^H A P = band: both back-transforms reproduce A from the band
    rec = tsvd.unmbr_ge2tb_u(f, _t(tsvd.unmbr_ge2tb_v(f, _t(f.band.numpy().conj().T)).numpy().conj().T))
    assert float(np.abs(rec.numpy() - a).max()) <= tol


@pytest.mark.parametrize("m,n,nb,dtype", CASES)
def test_tb2bd_from_reference_band(m, n, nb, dtype, record_property):
    _, (band, *_rest) = _jax_ge2tb(m, n, nb, dtype, 2)
    sq = band[:n, :n]
    d, e, f2, pu, pv = tsvd.tb2bd(_t(sq), nb)
    dj, ej, *_ = jax.jit(jsvd.tb2bd, static_argnums=(1, 2, 3))(jnp.asarray(sq), nb)
    b = np.diag(d.numpy()) + np.diag(e.numpy(), 1)
    bj = np.diag(np.asarray(dj)) + np.diag(np.asarray(ej), 1)
    sref = np.linalg.svd(sq.astype(np.complex128), compute_uv=False)
    tol = C * n * _eps(dtype) * sref[0]
    assert np.abs(np.linalg.svd(b, compute_uv=False) - sref).max() <= tol
    assert np.abs(np.linalg.svd(bj, compute_uv=False) - sref).max() <= tol
    assert d.dtype == e.dtype and not d.is_complex()
    spread = max(np.abs(d.numpy() - np.asarray(dj)).max(), np.abs(e.numpy() - np.asarray(ej)).max())
    record_property("de_spread_over_eps_max", float(spread / (_eps(dtype) * np.abs(sq).max())))
    # the lift of the bidiagonal's vectors: band = (Pu-lifted U) S (Pv-lifted V)^H
    ub, sb, vbh = np.linalg.svd(b)
    u = tsvd.unmbr_tb2bd_u(f2, pu[:, None] * _t(ub.astype(sq.dtype))).numpy()
    v = tsvd.unmbr_tb2bd_v(f2, pv[:, None] * _t(vbh.conj().T.astype(sq.dtype))).numpy()
    assert np.abs((u * sb) @ v.conj().T - sq).max() <= tol


@pytest.mark.parametrize("m,n,nb,dtype", [(40, 33, 8, "float64"), (44, 40, 8, "complex128")])
def test_back_transforms_on_reference_factors(m, n, nb, dtype):
    _, (band, vq, tq, vl, tl) = _jax_ge2tb(m, n, nb, dtype, 2)
    f1 = ge2tb_factors_from_numpy(band, vq, tq, vl, tl, nb, device="cpu")
    jf1 = jsvd.Ge2tbFactors(*(jnp.asarray(x) for x in (band, vq, tq, vl, tl)), nb)
    sq = band[:n, :n]
    _, _, f2j, _, _ = jax.jit(jsvd.tb2bd, static_argnums=(1, 2, 3))(jnp.asarray(sq), nb)
    f2 = tb2bd_factors_from_numpy(f2j.lvs, f2j.ltaus, f2j.rvs, f2j.rtaus, nb, n, device="cpu")
    jf2 = jsvd.Tb2bdFactors(f2j.lvs, f2j.ltaus, f2j.rvs, f2j.rtaus, nb, n)
    dt = np.dtype(dtype).type
    for side, k in (("u", m), ("v", n)):
        z = generate("randn", k, 5, dtype=dt, seed=7)
        fn_t = getattr(tsvd, f"unmbr_ge2tb_{side}")
        fn_j = getattr(jsvd, f"unmbr_ge2tb_{side}")
        got = fn_t(f1, _t(z)).numpy()
        want = np.asarray(jax.jit(lambda x: fn_j(jf1, x))(jnp.asarray(z)))
        assert np.abs(got - want).max() <= C * k * _eps(dtype) * np.abs(z).max()
        zs = z[:n]
        fn_t = getattr(tsvd, f"unmbr_tb2bd_{side}")
        fn_j = getattr(jsvd, f"unmbr_tb2bd_{side}")
        got = fn_t(f2, _t(zs)).numpy()
        want = np.asarray(jax.jit(lambda x: fn_j(jf2, x))(jnp.asarray(zs)))
        assert np.abs(got - want).max() <= C * n * _eps(dtype) * np.abs(zs).max()


@pytest.mark.parametrize("n,chunked", [(1, False), (2, False), (20, True)])
def test_bdsqr_matches(n, chunked, monkeypatch):
    """The Golub-Kahan solve; at n = 20 (2n = 40, N = 64) with _CHUNK_AT =
    64 and _CHUNK_COLS = 32 in both packages, so its top merge runs in two
    chunks (slate_tpu's wide-merge route at 16384)."""
    if chunked:
        for mod in (ttd, jtd):
            monkeypatch.setattr(mod, "_CHUNK_AT", 64)
            monkeypatch.setattr(mod, "_CHUNK_COLS", 32)
    rng = np.random.default_rng(n)
    d, e = rng.standard_normal(n), rng.standard_normal(max(n - 1, 0))
    s, u, v = tsvd.bdsqr(_t(d), _t(e))
    sj, uj, vj = jax.jit(lambda a, b: jsvd.bdsqr(a, b))(jnp.asarray(d), jnp.asarray(e))
    b = np.diag(d) + np.diag(e, 1)
    scale = max(np.abs(np.asarray(sj)).max(), 1.0)
    tol = C * 2 * n * _eps(np.float64) * scale
    assert np.abs(s.numpy() - np.asarray(sj)).max() <= tol
    assert np.abs((u.numpy() * s.numpy()) @ v.numpy().T - b).max() <= tol
    # U's orthogonality degrades as ~eps / sigma_min (the +-sigma Golub-Kahan
    # pairs nearly collide; bdsqr's docstring), in both packages alike
    uju = np.asarray(uj)
    orth_j = np.abs(uju.T @ uju - np.eye(n)).max()
    assert np.abs(u.numpy().T @ u.numpy() - np.eye(n)).max() <= max(C * orth_j, C * 2 * n * _eps(np.float64))
    sv = tsvd.bdsqr(_t(d), _t(e), want_vectors=False)
    assert np.abs(sv.numpy() - np.asarray(sj)).max() <= tol


@functools.lru_cache(maxsize=None)
def _jax_svd(m, n, dtype_name, separated):
    a = _mat(m, n, np.dtype(dtype_name).type, seed=m * 100 + n, separated=separated)
    return a, tuple(np.asarray(x) for x in _jsvd()(jnp.asarray(a)))


@pytest.mark.parametrize("m,n,dtype,separated", [(1, 1, "float64", False),
                                                 (40, 33, "float64", True),
                                                 (12, 16, "float64", False),
                                                 (16, 16, "complex128", True)])
def test_svd_array_matches(m, n, dtype, separated):
    """s, A = U S V^H, orthonormality, the m < n swap, the values-only
    form; U and V column by column on separated singular values."""
    a, (uj, sj, vhj) = _jax_svd(m, n, dtype, separated)
    u, s, vh = tsvd.svd_array(_t(a), nb=8)
    k = max(m, n)
    eps = _eps(dtype)
    smax = max(float(sj[0]), 1.0)
    assert np.abs(s.numpy() - sj).max() <= C * k * eps * smax
    un, vhn = u.numpy(), vh.numpy()
    assert un.shape == uj.shape and vhn.shape == vhj.shape
    assert np.abs((un * s.numpy()) @ vhn - a).max() <= C * k * eps * smax
    kk = min(m, n)
    assert np.abs(un.conj().T @ un - np.eye(kk)).max() <= C * k * eps
    assert np.abs(vhn @ vhn.conj().T - np.eye(kk)).max() <= C * k * eps
    if separated:  # gaps of 1; U and V's columns share the phase
        idx = np.abs(un).argmax(axis=0)
        ph = un[idx, np.arange(kk)] / np.abs(un[idx, np.arange(kk)])
        phj = uj[idx, np.arange(kk)] / np.abs(uj[idx, np.arange(kk)])
        assert np.abs(un / ph - uj / phj).max() <= C * k * eps * smax
        assert np.abs(vhn * ph[:, None] - vhj * phj[:, None]).max() <= C * k * eps * smax
    sv = tsvd.svd_array(_t(a), want_vectors=False, nb=8)
    assert np.abs(sv.numpy() - sj).max() <= C * k * eps * smax


def test_svd_staged_segmented(monkeypatch):
    """_CHASE_SEGMENT_ABOVE = 16: svd_staged chases in segments
    (slate_tpu: jitted step ranges, bitwise its svd_array), bitwise
    svd_array's in the port and within the limits of slate_tpu's
    svd_array."""
    monkeypatch.setattr(teig, "_CHASE_SEGMENT_ABOVE", 16)
    a, (uj, sj, vhj) = _jax_svd(40, 33, "float64", True)
    assert teig._chase_segments(33) == 2
    u, s, vh = tsvd.svd_staged(_t(a), nb=8)
    ua, sa, vha = tsvd.svd_array(_t(a), nb=8)
    for x, y in ((u, ua), (s, sa), (vh, vha)):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    d, e, f2, _, _ = tsvd.tb2bd(tsvd.ge2tb(_t(a), 8).band[:33], 8, segments=3)
    d1, e1, f21, _, _ = tsvd.tb2bd(tsvd.ge2tb(_t(a), 8).band[:33], 8)
    np.testing.assert_array_equal(d.numpy(), d1.numpy())
    np.testing.assert_array_equal(f2.rvs.numpy(), f21.rvs.numpy())
    assert np.abs(s.numpy() - sj).max() <= C * 40 * _eps(np.float64) * 33
    sv = tsvd.svd_staged(_t(a), want_vectors=False, nb=8)
    assert np.abs(sv.numpy() - sj).max() <= C * 40 * _eps(np.float64) * 33


def test_api_facades():
    a = _mat(14, 12, np.float64, seed=61)
    tol = C * 14 * _eps(np.float64) * 10
    s = tapi.svd_vals(_t(a))
    assert np.abs(s.numpy() - np.asarray(jax.jit(japi.svd_vals)(jnp.asarray(a)))).max() <= tol
    u, s2, vh = tapi.svd_decompose(_t(a))  # values from stedc, not sterf: rounding apart
    assert np.abs(s.numpy() - s2.numpy()).max() <= tol
    assert np.abs((u.numpy() * s2.numpy()) @ vh.numpy() - a).max() <= tol
    assert tapi.svd_vals(a, device="cpu").device.type == "cpu"
