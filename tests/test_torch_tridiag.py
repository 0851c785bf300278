"""The port's tridiagonal eigensolvers (slate_tpu_torch.linalg.tridiag:
sterf, steqr, stedc, stedc_vals, stedc_staged and the merge pieces) against
slate_tpu.linalg.tridiag on the CPU.

The same seeded numpy (d, e) go through both packages (``slate_tpu``'s
functions under ``jax.jit``, a fresh wrapper whenever a test monkeypatches
a module constant, so that the trace sees it).  Tolerances, each with its
reason:

- eigenvalues within 10 n eps ||T||: both solvers are backward stable, so
  each is within ~n eps ||T|| of the exact spectrum (Weyl); 10 covers the
  constant;
- vectors by residual max|T Z - Z W| and orthogonality max|Z^T Z - I|
  within 10 n eps (||T||); column by column, after fixing each column's
  sign, within 10 n eps ||T|| / gap on a spectrum with gaps ~1 (a vector's
  error is its residual over the gap);
- the merge's scans (``_suffix_next``, ``_prefix_prev``) and the deflation
  rotations on exact data are bitwise; the secular merge on the same poles
  to 100 n eps (70 bisection steps and the polish round differently);
- the rare routes are forced small in both packages: ``_CHUNK_AT`` /
  ``_CHUNK_COLS`` (the chunked merges), ``_STEDC_STAGE_ABOVE`` (the staged
  form) and ``_STERF_QR_MAX`` (sterf's divide-and-conquer route).

Data-dependent counts (the QR iteration's sweeps) are recorded, not gated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.linalg import tridiag as jtd
from slate_tpu_torch.linalg import tridiag as ttd

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

C = 10


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _tri(n, dtype, seed, separated=False):
    rng = np.random.default_rng(seed)
    if separated:
        d = np.arange(n, dtype=np.float64) * 1.0 + 0.1 * rng.standard_normal(n)
        e = 0.05 * rng.standard_normal(max(n - 1, 0))
    else:
        d = rng.standard_normal(n)
        e = rng.standard_normal(max(n - 1, 0))
    return d.astype(dtype), e.astype(dtype)


def _dense(d, e):
    return np.diag(d.astype(np.float64)) + np.diag(e.astype(np.float64), 1) + np.diag(
        e.astype(np.float64), -1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _check_w(w, ref, n, dtype, tnorm):
    err = float(np.abs(np.asarray(w, np.float64) - np.asarray(ref, np.float64)).max()) if n else 0.0
    assert err <= C * max(n, 1) * _eps(dtype) * tnorm, (err, tnorm)


def _check_vectors(t, w, z, n, dtype, tnorm):
    z = np.asarray(z, np.float64)
    w = np.asarray(w, np.float64)
    res = float(np.abs(t @ z - z * w).max())
    orth = float(np.abs(z.T @ z - np.eye(n)).max())
    assert res <= C * n * _eps(dtype) * tnorm, res
    assert orth <= C * n * _eps(dtype), orth


def _sign_fixed(z):
    z = np.asarray(z, np.float64)
    idx = np.abs(z).argmax(axis=0)
    return z * np.sign(z[idx, np.arange(z.shape[1])])


# ---------------------------------------------------------------------------
# the QR iteration: sterf / steqr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dtype", [(1, np.float64), (2, np.float64), (31, np.float32),
                                     (33, np.float64), (64, np.float32), (300, np.float64)])
def test_sterf_matches(n, dtype, record_property):
    """The QR iteration up to _STERF_QR_MAX = 256, stedc_vals above it."""
    d, e = _tri(n, dtype, seed=n)
    w = ttd.sterf(_t(d), _t(e))
    ref = jax.jit(jtd.sterf)(jnp.asarray(d), jnp.asarray(e))
    tnorm = max(float(np.abs(np.linalg.eigvalsh(_dense(d, e))).max()), 1.0)
    _check_w(w.numpy(), ref, n, dtype, tnorm)
    assert w.dtype == torch.from_numpy(d).dtype
    if n <= ttd._STERF_QR_MAX:
        _, _, sweeps = ttd._steqr_impl(_t(d), _t(e), None, 30 * n)
        record_property("sweeps", int(sweeps))  # data-dependent: recorded, not gated


def test_sterf_routes_to_divide_and_conquer(monkeypatch):
    """Above _STERF_QR_MAX (forced to 40) sterf is the values-only divide
    and conquer, bitwise stedc_vals, and max_sweeps forces the QR
    iteration back (the route's values against slate_tpu: n = 300 above)."""
    monkeypatch.setattr(ttd, "_STERF_QR_MAX", 40)
    n = 50
    d, e = _tri(n, np.float64, seed=7)
    w = ttd.sterf(_t(d), _t(e))
    ref = np.linalg.eigvalsh(_dense(d, e))
    tnorm = float(np.abs(np.linalg.eigvalsh(_dense(d, e))).max())
    _check_w(w.numpy(), ref, n, np.float64, tnorm)
    np.testing.assert_array_equal(w.numpy(), ttd.stedc_vals(_t(d), _t(e)).numpy())
    wq = ttd.sterf(_t(d), _t(e), max_sweeps=30 * n)
    _check_w(wq.numpy(), ref, n, np.float64, tnorm)


@pytest.mark.parametrize("n,dtype", [(1, np.float64), (2, np.float32), (33, np.float64),
                                     (40, np.float32)])
def test_steqr_matches(n, dtype):
    d, e = _tri(n, dtype, seed=100 + n, separated=True)
    w, z = ttd.steqr(_t(d), _t(e))
    wj, zj = jax.jit(jtd.steqr)(jnp.asarray(d), jnp.asarray(e))
    t = _dense(d, e)
    tnorm = max(float(np.abs(np.linalg.eigvalsh(t)).max()), 1.0)
    _check_w(w.numpy(), wj, n, dtype, tnorm)
    _check_vectors(t, w.numpy(), z.numpy(), n, dtype, tnorm)
    gap = 0.5  # d_i = i + 0.1 N(0, 1), |e| ~ 0.05: eigenvalue gaps ~1
    err = float(np.abs(_sign_fixed(z.numpy()) - _sign_fixed(zj)).max())
    assert err <= C * max(n, 1) * _eps(dtype) * tnorm / gap, err


def test_steqr_batched_freezes_converged_members():
    """A batch of base problems as stedc's base solves run them: each
    member equals its own unbatched solve (a converged member is frozen,
    as a vmapped while_loop freezes it)."""
    ds, es = zip(*(_tri(12, np.float64, seed=s) for s in range(3)))
    d, e = np.stack(ds), np.stack(es)
    e[1] = 0  # converged before the first sweep
    w, z = ttd.steqr(_t(d), _t(e))
    for b in range(3):
        wb, zb = ttd.steqr(_t(d[b]), _t(e[b]))
        np.testing.assert_allclose(w[b].numpy(), wb.numpy(), rtol=0, atol=1e-13)
        np.testing.assert_allclose(np.abs(z[b].numpy()), np.abs(zb.numpy()), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(w[1].numpy(), np.sort(d[1]))


# ---------------------------------------------------------------------------
# divide and conquer: the pieces
# ---------------------------------------------------------------------------


def test_scans_bitwise():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(17)
    active = rng.random(17) < 0.6
    want = jax.jit(lambda v, a: (jtd._suffix_next(v, a, 1e300), jtd._prefix_prev(v, a, -1e300)))(
        jnp.asarray(vals), jnp.asarray(active))
    got = (ttd._suffix_next(_t(vals)[None], _t(active)[None], 1e300)[0],
           ttd._prefix_prev(_t(vals)[None], _t(active)[None], -1e300)[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_deflation_and_secular_merge():
    """_deflate_z on poles with exact ties (the Givens deflation and a zero
    z entry) and _secular_merge on them, against slate_tpu."""
    rng = np.random.default_rng(5)
    n = 24
    d = np.sort(rng.standard_normal(n))
    d[5] = d[4]  # exact ties: deflated by rotation
    d[11] = d[10] = d[9]
    z = rng.standard_normal(n)
    z /= np.linalg.norm(z)
    z[17] = 0.0  # negligible: deflated by the mask
    rho = 0.7
    zf, cs, sn, act = ttd._deflate_z(_t(d)[None], _t(z)[None], torch.tensor([rho], dtype=torch.float64))
    jz, jcs, jsn, jact = jtd._deflate_z(jnp.asarray(d), jnp.asarray(z), rho)
    np.testing.assert_array_equal(act[0].numpy(), np.asarray(jact))
    for got, want in ((zf, jz), (cs, jcs), (sn, jsn)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=4 * _eps(np.float64))
    lam, v = ttd._secular_merge(_t(d)[None], _t(z)[None], torch.tensor([rho], dtype=torch.float64))
    jlam, jv = jax.jit(jtd._secular_merge)(jnp.asarray(d), jnp.asarray(z), rho)
    tol = 100 * n * _eps(np.float64)
    np.testing.assert_allclose(lam[0].numpy(), np.asarray(jlam), rtol=0, atol=tol * 2)
    m = np.diag(d) + rho * np.outer(z, z)
    vn = v[0].numpy()
    assert np.abs(m @ vn - vn * lam[0].numpy()).max() < tol
    assert np.abs(vn.T @ vn - np.eye(n)).max() < tol


# ---------------------------------------------------------------------------
# divide and conquer: stedc, stedc_vals, stedc_staged and the forced routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,dtype", [(33, np.float64), (96, np.float32)])
def test_stedc_matches(n, dtype):
    d, e = _tri(n, dtype, seed=200 + n)
    w, z = ttd.stedc(_t(d), _t(e))
    wj, zj = jax.jit(jtd.stedc)(jnp.asarray(d), jnp.asarray(e))
    t = _dense(d, e)
    tnorm = float(np.abs(np.linalg.eigvalsh(t)).max())
    _check_w(w.numpy(), wj, n, dtype, tnorm)
    _check_vectors(t, w.numpy(), z.numpy(), n, dtype, tnorm)
    wv = ttd.stedc_vals(_t(d), _t(e))
    _check_w(wv.numpy(), wj, n, dtype, tnorm)


def test_stedc_columns_on_separated_spectrum():
    n = 70  # pads to N = 128: the pad eigenvalues tie and sort stably last
    d, e = _tri(n, np.float64, seed=9, separated=True)
    w, z = ttd.stedc(_t(d), _t(e))
    wj, zj = jax.jit(jtd.stedc)(jnp.asarray(d), jnp.asarray(e))
    tnorm = float(np.abs(np.linalg.eigvalsh(_dense(d, e))).max())
    _check_w(w.numpy(), wj, n, np.float64, tnorm)
    err = float(np.abs(_sign_fixed(z.numpy()) - _sign_fixed(zj)).max())
    assert err <= C * n * _eps(np.float64) * tnorm / 0.5, err


def test_stedc_chunked_and_staged_routes(monkeypatch):
    """_CHUNK_AT = 128, _CHUNK_COLS = 32 and _STEDC_STAGE_ABOVE = 48 in both
    packages: the widest merge of n = 100 (N = 128) runs in four chunks, with
    vectors (_merge_chunked) and values only (_merge_chunked_vals), and
    stedc_staged takes its staged route (bitwise stedc in both packages:
    slate_tpu's staged form is its fused one dispatched per level)."""
    for mod in (ttd, jtd):
        monkeypatch.setattr(mod, "_CHUNK_AT", 128)
        monkeypatch.setattr(mod, "_CHUNK_COLS", 32)
        monkeypatch.setattr(mod, "_STEDC_STAGE_ABOVE", 48)
    n = 100
    d, e = _tri(n, np.float64, seed=11)
    t = _dense(d, e)
    tnorm = float(np.abs(np.linalg.eigvalsh(t)).max())
    w, z = ttd.stedc(_t(d), _t(e))
    ws, zs = ttd.stedc_staged(_t(d), _t(e))
    np.testing.assert_array_equal(ws.numpy(), w.numpy())
    np.testing.assert_array_equal(zs.numpy(), z.numpy())
    wj, _ = jax.jit(lambda a, b: jtd.stedc(a, b))(jnp.asarray(d), jnp.asarray(e))
    _check_w(w.numpy(), wj, n, np.float64, tnorm)
    _check_vectors(t, w.numpy(), z.numpy(), n, np.float64, tnorm)
    _check_w(ttd.stedc_vals(_t(d), _t(e)).numpy(), wj, n, np.float64, tnorm)


def test_stedc_deflation_heavy():
    """Repeated eigenvalues: a block-diagonal T of equal blocks (zero
    couplings) deflates at every merge; the eigenvalues come out sorted
    stably and the vectors stay orthonormal."""
    n = 64
    d1, e1 = _tri(16, np.float64, seed=13)
    d, e = np.tile(d1, 4), np.concatenate([np.append(e1, 0.0)] * 4)[:-1]
    w, z = ttd.stedc(_t(d), _t(e))
    wj, _ = jax.jit(jtd.stedc)(jnp.asarray(d), jnp.asarray(e))
    t = _dense(d, e)
    tnorm = float(np.abs(np.linalg.eigvalsh(t)).max())
    _check_w(w.numpy(), wj, n, np.float64, tnorm)
    _check_vectors(t, w.numpy(), z.numpy(), n, np.float64, tnorm)


def test_tridiag_runs_on_the_tensors_device():
    d, e = _tri(40, np.float32, seed=1)
    w, z = ttd.stedc(_t(d), _t(e))
    assert w.device.type == "cpu" and z.device.type == "cpu" and z.dtype == torch.float32
