"""The port's two-stage Hermitian eigensolver (slate_tpu_torch.linalg.eig:
he2hb, hb2st, the back-transforms, heev_array, heev_staged, hegst / hegv
and the api facades) against slate_tpu.linalg.eig on the CPU.

Stage by stage: each port stage is fed ``slate_tpu``'s output of the stage
before (``utils.testing.he2hb_factors_from_numpy`` /
``hb2st_factors_from_numpy``), so a stage is held alone.  Tolerances, each
with its reason (A's entries O(1), eps of the dtype):

- the band within 10 n eps max|A|: both reductions are backward stable and
  the panels are the same Householder loops;
- (d, e) from the same band: the tridiagonal's spectrum within 10 n eps
  ||A||_2 of the reference's (Weyl), and elementwise within 100 n eps
  max|band| -- the chase's entries are forward-unstable (rounding
  differences grow along a sweep), which the wider constant covers;
- the back-transforms applied to the same Z within 10 n eps max|Z|;
- w within 10 n eps ||A||_2; Z by residual max|A Z - Z W| / ||A|| and
  orthogonality within 10 n eps, and column by column after fixing each
  column's phase, within 10 n eps ||A|| / gap on spectra with gaps ~1;
- the chase's (sweep, hop) schedule is bitwise: both packages run a
  recording hop on the same frame.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu import api as japi
from slate_tpu import types as jt
from slate_tpu.linalg import eig as jeig
from slate_tpu_torch import api as tapi
from slate_tpu_torch import types as tt
from slate_tpu_torch.linalg import eig as teig
from slate_tpu_torch.utils.testing import (
    generate,
    hb2st_factors_from_numpy,
    he2hb_factors_from_numpy,
)

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

C = 10


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _t(x):
    return torch.from_numpy(np.array(x))


def _herm(n, dtype, seed, separated=False):
    if separated:  # eigenvalues 1..n: gaps of 1
        q, _ = np.linalg.qr(generate("randn", n, n, dtype=np.complex128 if np.iscomplexobj(
            np.zeros(1, dtype)) else np.float64, seed=seed))
        a = (q * np.arange(1, n + 1)) @ q.conj().T
    else:
        g = generate("randn", n, n, dtype=dtype, seed=seed)
        a = (g + g.conj().T) / 2
    return a.astype(dtype)


def _phase_fixed(z):
    z = np.asarray(z)
    idx = np.abs(z).argmax(axis=0)
    piv = z[idx, np.arange(z.shape[1])]
    return z * (np.abs(piv) / piv)


@functools.lru_cache(maxsize=None)
def _jheev(method="DC", nb=8, want_vectors=True):
    """One jitted slate_tpu heev_array per configuration (repeat shapes hit
    its cache)."""
    return jax.jit(functools.partial(jeig.heev_array, want_vectors=want_vectors,
                                     method=jt.MethodEig[method], nb=nb))


@functools.lru_cache(maxsize=None)
def _jax_he2hb(n, nb, dtype_name, seed):
    a = _herm(n, np.dtype(dtype_name).type, seed)
    f = jax.jit(jeig.he2hb, static_argnums=1)(jnp.asarray(a), nb)
    return a, tuple(np.asarray(x) for x in (f.band, f.v, f.t))


CASES = [(33, 8, "float64"), (64, 32, "float32"), (40, 8, "complex128"), (64, 8, "complex64")]


@pytest.mark.parametrize("n,nb,dtype", CASES)
def test_he2hb_band_matches(n, nb, dtype):
    a, (band, v, t) = _jax_he2hb(n, nb, dtype, 1)
    f = teig.he2hb(_t(a), nb)
    tol = C * n * _eps(dtype) * np.abs(a).max()
    assert float(np.abs(f.band.numpy() - band).max()) <= tol
    assert f.v.shape == v.shape and f.t.shape == t.shape and f.nb == nb
    # Q^H A Q = band: the factors reproduce A from the band
    back = teig.unmtr_he2hb(f, _t(teig.unmtr_he2hb(f, f.band).numpy().conj().T))
    assert float(np.abs(back.numpy().conj().T - a).max()) <= tol


@pytest.mark.parametrize("n,nb,dtype", CASES)
def test_hb2st_from_reference_band(n, nb, dtype):
    _, (band, v, t) = _jax_he2hb(n, nb, dtype, 1)
    f1 = he2hb_factors_from_numpy(band, v, t, nb, device="cpu")
    d, e, f2, ph = teig.hb2st(f1.band, nb)
    dj, ej, f2j, phj = jax.jit(jeig.hb2st, static_argnums=(1, 2, 3))(jnp.asarray(band), nb)
    rdt = np.finfo(dtype).dtype
    scale = np.abs(band).max()
    tri = np.diag(d.numpy()) + np.diag(e.numpy(), 1) + np.diag(e.numpy(), -1)
    trij = np.diag(np.asarray(dj)) + np.diag(np.asarray(ej), 1) + np.diag(np.asarray(ej), -1)
    wref = np.linalg.eigvalsh(band.astype(np.complex128 if np.iscomplexobj(band) else np.float64))
    norm2 = np.abs(wref).max()
    assert d.dtype == torch.from_numpy(np.zeros(1, rdt)).dtype and e.dtype == d.dtype
    assert np.abs(np.linalg.eigvalsh(tri) - wref).max() <= C * n * _eps(dtype) * norm2
    assert np.abs(np.linalg.eigvalsh(trij) - wref).max() <= C * n * _eps(dtype) * norm2
    assert np.abs(d.numpy() - np.asarray(dj)).max() <= 100 * n * _eps(dtype) * scale
    assert np.abs(e.numpy() - np.asarray(ej)).max() <= 100 * n * _eps(dtype) * scale
    # the lift: phases and the stage-2 reflectors take T's vectors to the band's
    wt, zt = np.linalg.eigh(tri)
    zb = teig.unmtr_hb2st(f2, ph[:, None] * _t(zt.astype(band.dtype)))
    res = np.abs(band @ zb.numpy() - zb.numpy() * wt).max()
    assert res <= C * n * _eps(dtype) * norm2


@pytest.mark.parametrize("n,nb,dtype", [(33, 8, "float64"), (40, 8, "complex128")])
def test_back_transforms_on_reference_factors(n, nb, dtype):
    """unmtr_hb2st and unmtr_he2hb of both packages on the same factors
    and the same Z."""
    _, (band, v, t) = _jax_he2hb(n, nb, dtype, 1)
    dj, ej, f2j, phj = jax.jit(jeig.hb2st, static_argnums=(1, 2, 3))(jnp.asarray(band), nb)
    f1 = he2hb_factors_from_numpy(band, v, t, nb, device="cpu")
    f2 = hb2st_factors_from_numpy(f2j.vs, f2j.taus, nb, n, device="cpu")
    z = generate("randn", n, 5, dtype=np.dtype(dtype).type, seed=3)
    tol = C * n * _eps(dtype) * np.abs(z).max()
    got = teig.unmtr_hb2st(f2, _t(z)).numpy()
    jf2 = jeig.Hb2stFactors(f2j.vs, f2j.taus, nb, n)  # the jit made w and n arrays
    want = np.asarray(jax.jit(lambda x: jeig.unmtr_hb2st(jf2, x))(jnp.asarray(z)))
    assert np.abs(got - want).max() <= tol
    jf1 = jeig.He2hbFactors(jnp.asarray(band), jnp.asarray(v), jnp.asarray(t), nb)
    got = teig.unmtr_he2hb(f1, _t(z)).numpy()
    want = np.asarray(jax.jit(lambda x: jeig.unmtr_he2hb(jf1, x))(jnp.asarray(z)))
    assert np.abs(got - want).max() <= tol


def test_chase_schedule_bitwise():
    """Both packages' wavefront chase on the same frame with a hop that
    changes nothing and records, for every (sweep j, hop t) it runs, the
    window's frame row (pad + r0), the eliminated index and nact: the
    recorded (n - 1, max_hops) tables are bitwise equal, unrun hops -1."""
    n, w = 45, 4
    pad = 4 * w
    nsweeps, max_hops = n - 2, -(-(n - 1) // w)
    frame = np.zeros((n + 2 * pad, 4 * w))
    frame[:, 2 * w] = np.arange(n + 2 * pad)  # the diagonal names its row

    def jone(block, idx0, nact):
        return block, block[w, w], idx0.astype(block.dtype), nact.astype(block.dtype)

    init = tuple(jnp.full((n - 1, max_hops), -1.0) for _ in range(3))
    out = jeig._wavefront_chase_band(jnp.asarray(frame), n, w, nsweeps, max_hops, jone, init)

    def tone(blocks, idx0, nact):
        k = blocks.shape[0]
        na = torch.full((k,), float(w), dtype=torch.float64) if nact is None else \
            torch.tensor(nact, dtype=torch.float64)
        return blocks, blocks[:, w, w].clone(), torch.tensor(idx0, dtype=torch.float64), na

    facs = tuple(torch.full((n - 1, max_hops), -1.0, dtype=torch.float64) for _ in range(3))
    got = teig._wavefront_chase_band(_t(frame), n, w, nsweeps, max_hops, tone, facs)
    for g, j in zip(got[1:], out[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert (got[1].numpy() >= 0).sum() == sum(
        1 for j in range(nsweeps) for t in range(max_hops) if j + 1 + t * w <= n - 1)


@pytest.mark.parametrize("n,dtype,method,separated", [
    (1, "float64", "DC", False), (2, "float32", "DC", False), (33, "float64", "QR", True),
    (48, "float32", "DC", False), (40, "complex128", "DC", True), (36, "complex64", "QR", False)])
def test_heev_array_matches(n, dtype, method, separated):
    """w, Z by residual and orthogonality, the values-only form; on the
    separated spectra (eigenvalues 1..n) Z column by column."""
    a = _herm(n, np.dtype(dtype).type, seed=n + 7, separated=separated)
    w, z = teig.heev_array(_t(a), method=tt.MethodEig[method], nb=8)
    wj, zj = _jheev(method)(jnp.asarray(a))
    norm2 = max(np.abs(np.linalg.eigvalsh(a.astype(np.complex128))).max(), 1.0)
    eps = _eps(dtype)
    assert np.abs(w.numpy() - np.asarray(wj)).max() <= C * n * eps * norm2
    zn = z.numpy()
    assert np.abs(a @ zn - zn * w.numpy()).max() <= C * n * eps * norm2
    assert np.abs(zn.conj().T @ zn - np.eye(n)).max() <= C * n * eps
    if separated:  # gaps of 1
        err = np.abs(_phase_fixed(zn) - _phase_fixed(np.asarray(zj))).max()
        assert err <= C * n * eps * norm2 / 1.0
    wv = teig.heev_array(_t(a), want_vectors=False, nb=8)
    assert np.abs(wv.numpy() - np.asarray(wj)).max() <= C * n * eps * norm2


def test_heev_staged_segmented(monkeypatch):
    """_CHASE_SEGMENT_ABOVE = 16 in both packages: heev_staged chases in
    segments (slate_tpu: jitted step ranges; here the same loop over the
    ranges), bitwise heev_array's in the port, and the values-only form is
    the divide and conquer.  The reference is slate_tpu's heev_array, which
    its heev_staged reproduces bitwise."""
    for mod in (teig, jeig):
        monkeypatch.setattr(mod, "_CHASE_SEGMENT_ABOVE", 16)
    n = 40
    a = _herm(n, np.float64, seed=21)
    assert teig._chase_segments(n) == jeig._chase_segments(n) == 2
    w, z = teig.heev_staged(_t(a), nb=8)
    wa, za = teig.heev_array(_t(a), nb=8)
    np.testing.assert_array_equal(w.numpy(), wa.numpy())
    np.testing.assert_array_equal(z.numpy(), za.numpy())
    d, e, f2, _ = teig.hb2st(teig.he2hb(_t(a), 8).band, 8, segments=3)
    d1, e1, f21, _ = teig.hb2st(teig.he2hb(_t(a), 8).band, 8)
    np.testing.assert_array_equal(d.numpy(), d1.numpy())
    np.testing.assert_array_equal(f2.vs.numpy(), f21.vs.numpy())
    wj, _ = _jheev()(jnp.asarray(a))
    assert np.abs(w.numpy() - np.asarray(wj)).max() <= C * n * _eps(np.float64) * 10
    wv = teig.heev_staged(_t(a), want_vectors=False, nb=8)
    assert np.abs(wv.numpy() - np.asarray(wj)).max() <= C * n * _eps(np.float64) * 10


@pytest.mark.parametrize("itype", [1, 2, 3])
def test_hegv_matches(itype):
    n = 24
    a = _herm(n, np.float64, seed=31)
    b = generate("spd", n, dtype=np.float64, seed=32)
    w, x, info = teig.hegv_array(_t(a), _t(b), itype=itype)
    wj, xj, infoj = jax.jit(functools.partial(jeig.hegv_array, itype=itype))(
        jnp.asarray(a), jnp.asarray(b))
    assert int(info) == int(infoj) == 0
    scale = max(np.abs(np.asarray(wj)).max(), 1.0)
    assert np.abs(w.numpy() - np.asarray(wj)).max() <= 100 * n * _eps(np.float64) * scale
    xn = x.numpy()
    # B-orthonormal eigenvectors (itype 3: L^-1-orthonormal, X^H B^-1 X = I)
    gram = xn.T @ (np.linalg.inv(b) if itype == 3 else b) @ xn
    assert np.abs(gram - np.eye(n)).max() <= 100 * n * _eps(np.float64) * np.linalg.cond(b)
    wv, xv, _ = teig.hegv_array(_t(a), _t(b), itype=itype, want_vectors=False)
    assert xv is None and np.abs(wv.numpy() - np.asarray(wj)).max() <= 100 * n * _eps(np.float64) * scale


def test_larfg_masked_edges():
    """The Householder of both packages on edge vectors: a -0.0 pivot
    (sign +1), a zero tail (tau 0), nactive 1 and 0 (the identity), a
    complex pivot with a zero tail (tau != 0), batched through the port."""
    cases = [(np.array([-0.0, 1.0, 2.0, 0.5]), 4), (np.array([3.0, 0.0, 0.0, 0.0]), 4),
             (np.array([1.0, 2.0, 3.0, 4.0]), 1), (np.array([1.0, 2.0, 3.0, 4.0]), 0),
             (np.array([1.0, 2.0, 3.0, 4.0]), 3),
             (np.array([1 + 1j, 0, 0, 0]), 4), (np.array([0.5 - 2j, 1j, 3.0, 0]), 4)]
    jlarfg = jax.jit(jeig._larfg_masked)
    for x, na in cases:
        x = x.astype(np.complex128)  # one compile; a real x is its complex embedding
        v, tau = teig._larfg_masked(_t(x)[None], [na])
        vj, tauj = jlarfg(jnp.asarray(x), na)
        np.testing.assert_allclose(v[0].numpy(), np.asarray(vj), rtol=0, atol=4 * _eps(np.float64))
        np.testing.assert_allclose(tau[0].numpy(), np.asarray(tauj), rtol=0, atol=4 * _eps(np.float64))
    x = np.array([[-0.0, 1.0, 2.0, 0.5], [3.0, 0.0, 0.0, 0.0]])
    v, tau = teig._larfg_masked(_t(x), None)
    for i in range(2):
        vj, tauj = jlarfg(jnp.asarray(x[i].astype(np.complex128)), 4)
        np.testing.assert_allclose(v[i].numpy(), np.asarray(vj), rtol=0, atol=4 * _eps(np.float64))
        np.testing.assert_allclose(float(tau[i]), complex(tauj).real, rtol=0, atol=4 * _eps(np.float64))


def test_api_facades():
    n = 20
    a = _herm(n, np.float64, seed=41)
    b = generate("spd", n, dtype=np.float64, seed=42)
    tol = 100 * n * _eps(np.float64) * 10
    w = tapi.eig_vals(_t(a))
    assert np.abs(w.numpy() - np.asarray(jax.jit(japi.eig_vals)(jnp.asarray(a)))).max() <= tol
    w2, z = tapi.eig_decompose(_t(a))
    np.testing.assert_array_equal(w.numpy(), w2.numpy())
    assert np.abs(a @ z.numpy() - z.numpy() * w2.numpy()).max() <= tol
    wg, xg, info = tapi.generalized_eig(_t(a), _t(b))
    wgj = np.asarray(jax.jit(japi.generalized_eig)(jnp.asarray(a), jnp.asarray(b))[0])
    assert int(info) == 0 and np.abs(wg.numpy() - wgj).max() <= tol
    assert tapi.eig_vals(a, device="cpu").device.type == "cpu"
