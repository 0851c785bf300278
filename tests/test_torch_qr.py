"""The port's single-chip QR and least squares (slate_tpu_torch.linalg.qr)
against slate_tpu.linalg.qr.

The same seeded numpy operands go through ``slate_tpu`` (the Householder
panels through ``qr_panel_pallas`` / ``qr_panel_offset_pallas`` in Pallas
interpret mode, ``Option.PanelImpl`` ``pallas``, as
tests/test_pallas_panels.py runs them) and through the port on the CPU,
where the kernel wrappers take their plain twins.

Tolerances: factors, reflectors and T within c m eps of the reference at
their own scale (two frameworks, two summation orders in the v^H A
products; c = 4, and 100 for the recursive geqrf whose merges sum over
m rows many times); the least-squares solutions to the reference's
normal-equations gate |A^H (A X - B)| / (max|A|^2 max|X| m) < 100 n eps
(tester.py's run_gels) and to each other within 100 m eps max|X|.
Bitwise: the port's own results across PanelImpl lowerings on the CPU,
signs of zero pivots, dead-column codes, the Op.Trans refusals.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu import api as japi
from slate_tpu import types as jt
from slate_tpu.linalg import qr as jqr
from slate_tpu.ops import pallas_ops as po
from slate_tpu.utils.testing import generate
from slate_tpu_torch import api as tapi
from slate_tpu_torch import types as tt
from slate_tpu_torch.linalg import qr as tqr
from slate_tpu_torch.ops import kernels as tk

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

DTYPES = [np.float32, np.float64]


def _eps(dtype):
    return float(np.finfo(dtype).eps)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, c, m, dtype, scale=None):
    """|got - ref| <= c m eps max|ref| (or ``scale``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = float(np.abs(ref).max()) if scale is None else scale
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= c * m * _eps(dtype) * max(scale, 1e-30), (err, c * m * _eps(dtype) * scale)


@pytest.fixture(autouse=True)
def _default_impls(monkeypatch):
    monkeypatch.delenv(tk.PANEL_IMPL_ENV, raising=False)


def _panel(m, w, dtype, seed, zero_col=None, row0=0):
    a = generate("randn", m, w, dtype=dtype, seed=seed)
    if zero_col is not None:
        a[:, zero_col] = 0
    a[:row0] = 0
    a[row0, 0] = -0.0  # the first pivot: its sign must read +1
    return a


# ---------------------------------------------------------------------------
# the panels: the plain twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,w,zero_col", [(40, 16, 5), (37, 16, None), (10, 16, 3), (64, 64, 63)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_plain_matches_pallas(m, w, zero_col, dtype):
    a = _panel(m, w, dtype, seed=m + w, zero_col=zero_col)
    vr_j, tau_j, t_j = (np.asarray(x) for x in po.qr_panel_pallas(jnp.asarray(a)))
    vr, tau, t = (x.numpy() for x in tk.qr_panel_plain(_t(a)))
    _close(vr, vr_j, 4, m, dtype)
    _close(tau, tau_j, 4, m, dtype, float(np.abs(t_j).max()))
    _close(t, t_j, 4, m, dtype)
    assert vr[0, 0] < 0 and vr_j[0, 0] < 0  # -0.0 -> sign +1 -> beta = -anorm
    if zero_col is not None and zero_col < min(m, w):
        # a dead column of the plain panel: tau 0, R(j, j) = alpha, unit v
        assert tau[zero_col] == 0 and tau_j[zero_col] == 0
        np.testing.assert_array_equal(vr[zero_col + 1:, zero_col], 0)
    if m < w:  # min(m, w) steps
        np.testing.assert_array_equal(tau[m:], 0)
        np.testing.assert_array_equal(t[:, m:], 0)


@pytest.mark.parametrize("m,w,row0,zero_col", [(48, 8, 0, None), (48, 8, 16, 3), (50, 8, 42, 7),
                                               (33, 16, 9, 0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_panel_offset_plain_matches_pallas(m, w, row0, zero_col, dtype):
    a = _panel(m, w, dtype, seed=m + row0, zero_col=zero_col, row0=row0)
    ref = [np.asarray(x) for x in po.qr_panel_offset_pallas(jnp.asarray(a), row0)]
    got = [x.numpy() for x in tk.qr_panel_offset_plain(_t(a), row0)]
    for g, r in zip(got, ref):
        _close(g, r, 4, m, dtype, float(np.abs(r).max()) if r.any() else 1.0)
    r, v, tau, t = got
    np.testing.assert_array_equal(r[:row0], 0)  # rows < row0 stay zero
    np.testing.assert_array_equal(v[:row0], 0)
    if zero_col != 0:  # weight below the -0.0 pivot: beta = -anorm
        assert r[row0, 0] < 0 and ref[0][row0, 0] < 0
    for j in range(w):  # zeros below each pivot in r, above it in v
        np.testing.assert_array_equal(r[row0 + j + 1:, j], 0)
        np.testing.assert_array_equal(v[:row0 + j, j], 0)
    if zero_col is not None:
        # a dead offset column: tau 0 and a ZERO pivot entry in v (the plain
        # panel keeps 1 there)
        assert tau[zero_col] == 0 and v[row0 + zero_col, zero_col] == 0
        assert ref[1][row0 + zero_col, zero_col] == 0


@pytest.mark.parametrize("x", [0.0, -0.0, 2.5, -2.5, np.nan, np.inf, -np.inf])
def test_sign_safe_matches(x):
    want = np.asarray(jqr._sign_safe(jnp.asarray([x])))
    got = tk._sign_safe(torch.tensor([x], dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(got, want)


def test_batched_offset_twin_is_per_panel():
    a = np.stack([_panel(40, 8, np.float64, seed=s, row0=r) for s, r in ((1, 0), (2, 8), (3, 32))])
    got = tk.qr_panel_offset(_t(a), [0, 8, 32])
    for i, r0 in enumerate((0, 8, 32)):
        for g, w in zip(got, tk.qr_panel_offset_plain(_t(a[i]), r0)):
            assert torch.equal(g[i], w)
    with pytest.raises(ValueError, match="row0"):
        tk.qr_panel_offset(_t(a), [0, 8, 33])
    with pytest.raises(ValueError, match="offsets"):
        tk.qr_panel_offset(_t(a), [0, 8])


# ---------------------------------------------------------------------------
# single-chip factorizations and solves
# ---------------------------------------------------------------------------


def _jax_pallas(fn, *args):
    with po.use_panel_impl("pallas"):
        return fn(*args)


@pytest.mark.parametrize("m,n", [(128, 64), (130, 70), (200, 128), (64, 30)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_geqrf_array_matches(m, n, dtype):
    a = generate("randn", m, n, dtype=dtype, seed=m * n)
    fj = _jax_pallas(jqr.geqrf_array, jnp.asarray(a))
    f = tqr.geqrf_array(_t(a))
    amax = float(np.abs(a).max())
    _close(f.vr.numpy(), fj.vr, 100, m, dtype, amax * np.sqrt(m))
    _close(f.t.numpy(), fj.t, 100, m, dtype)
    # Q R = A and Q^H Q = I through the port's own unmqr
    q = tqr.geqrf_q(f).numpy().astype(np.float64)
    r = tqr.geqrf_r(f).numpy().astype(np.float64)
    _close(q @ r, a.astype(np.float64), 4, m, dtype, amax * np.sqrt(m))
    _close(q.T @ q, np.eye(n), 4, m, dtype, 1.0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_geqrf_scan_array_and_unmqr_scan(dtype):
    m, n, nb = 96, 40, 16
    a = generate("randn", m, n, dtype=dtype, seed=7)
    c = generate("randn", m, 3, dtype=dtype, seed=8)
    fj = _jax_pallas(jqr.geqrf_scan_array, jnp.asarray(a), nb)
    f = tqr.geqrf_scan_array(_t(a), nb)
    scale = float(np.abs(a).max()) * np.sqrt(m)
    _close(f.r.numpy(), fj.r, 4, m, dtype, scale)
    _close(f.v.numpy(), fj.v, 4, m, dtype)
    _close(f.t.numpy(), fj.t, 4, m, dtype)
    for op in ("NoTrans", "ConjTrans"):
        want = np.asarray(jqr.unmqr_scan_array(fj, jnp.asarray(c), getattr(jt.Op, op)))
        got = tqr.unmqr_scan_array(f, _t(c), getattr(tt.Op, op)).numpy()
        _close(got, want, 4, m, dtype)
    with pytest.raises(ValueError, match="m >= n"):
        tqr.geqrf_scan_array(_t(a.T.copy()), nb)


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("op", ["NoTrans", "Trans", "ConjTrans"])
def test_unmqr_array_all_side_op(side, op):
    m, n = 70, 30
    a = generate("randn", m, n, dtype=np.float64, seed=3)
    c = generate("randn", m, 4, dtype=np.float64, seed=4)
    if side == "Right":
        c = c.T.copy()
    fj = jqr.geqrf_array(jnp.asarray(a))
    f = tqr.geqrf_array(_t(a))
    want = np.asarray(jqr.unmqr_array(getattr(jt.Side, side), getattr(jt.Op, op), fj, jnp.asarray(c)))
    got = tqr.unmqr_array(getattr(tt.Side, side), getattr(tt.Op, op), f, _t(c)).numpy()
    _close(got, want, 4, m, np.float64)


@pytest.mark.parametrize("side", ["Left", "Right"])
@pytest.mark.parametrize("op", ["NoTrans", "ConjTrans"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gelqf_and_unmlq(side, op, dtype):
    m, n = 30, 90
    a = generate("randn", m, n, dtype=dtype, seed=5)
    c = generate("randn", n, 3, dtype=dtype, seed=6)
    if side == "Right":
        c = c.T.copy()
    fj = _jax_pallas(jqr.gelqf_array, jnp.asarray(a))
    f = tqr.gelqf_array(_t(a))
    scale = float(np.abs(a).max()) * np.sqrt(n)
    _close(tqr.gelqf_l(f).numpy(), jqr.gelqf_l(fj), 100, n, dtype, scale)
    want = np.asarray(jqr.unmlq_array(getattr(jt.Side, side), getattr(jt.Op, op), fj, jnp.asarray(c)))
    got = tqr.unmlq_array(getattr(tt.Side, side), getattr(tt.Op, op), f, _t(c)).numpy()
    _close(got, want, 100, n, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_cholqr_array(dtype):
    m, n = 120, 20
    a = generate("randn", m, n, dtype=dtype, seed=9)
    qj, rj = jqr.cholqr_array(jnp.asarray(a))
    q, r = tqr.cholqr_array(_t(a))
    _close(r.numpy(), rj, 4, m, dtype)
    _close(q.numpy(), qj, 100, m, dtype)
    q64 = q.numpy().astype(np.float64)
    _close(q64.T @ q64, np.eye(n), 100, m, dtype, 1.0)


def _gels_gate(a, x, b):
    """tester.py's run_gels residual: |A^H (A X - B)| / (max|A|^2 max|X| m)."""
    wide = np.complex128 if np.iscomplexobj(a) else np.float64
    a, x, b = (np.asarray(v).astype(wide) for v in (a, x, b))
    m = a.shape[0]
    r = np.abs(a.conj().T @ (a @ x - b)).max()
    return r / (np.abs(a).max() ** 2 * np.abs(x).max() * m)


@pytest.mark.parametrize("m,n,method", [(90, 40, "QR"), (40, 90, "QR"), (90, 40, "CholQR"),
                                        (129, 65, "QR")])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gels_array(m, n, method, dtype):
    a = generate("randn", m, n, dtype=dtype, seed=m + n)
    b = generate("randn", m, 3, dtype=dtype, seed=m + n + 1)
    xj = np.asarray(_jax_pallas(jqr.gels_array, jnp.asarray(a), jnp.asarray(b),
                                {jt.Option.MethodGels: getattr(jt.MethodGels, method)}))
    x = tqr.gels_array(_t(a), _t(b), {tt.Option.MethodGels: getattr(tt.MethodGels, method)}).numpy()
    assert x.shape == (n, 3) and np.isfinite(x).all()
    _close(x, xj, 100, max(m, n), dtype)
    if m >= n:
        assert _gels_gate(a, x, b) < 100 * n * _eps(dtype)
    else:  # minimum norm: A X = B exactly, X in the row space of A
        _close(a.astype(np.float64) @ x, b, 100, n, dtype, float(np.abs(b).max()))
    named = tqr.gels_qr_array if method == "QR" else tqr.gels_cholqr_array
    assert torch.equal(named(_t(a), _t(b)), torch.from_numpy(x))


HALF = [(torch.bfloat16, 2.0 ** -7), (torch.float16, 2.0 ** -10)]  # (dtype, its eps)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype,heps", HALF)
def test_half_panels_are_the_f32_panel_rounded(offset, dtype, heps):
    """A bf16/f16 panel is factored in f32 (the kernel's dtype) and rounded
    back: within one rounding (eps/2 relative, tolerance eps) of
    ``slate_tpu``'s f32 Pallas panel, plus the f32 class 4 m eps max|ref|."""
    m, w, row0 = 48, 8, 16
    a = _panel(m, w, np.float32, seed=77, row0=row0 if offset else 0)
    a = torch.from_numpy(a).to(dtype).float().numpy()  # exactly representable
    if offset:
        ref = po.qr_panel_offset_pallas(jnp.asarray(a), row0)
        got = tqr._panel_qr_offset_t(_t(a).to(dtype), row0)
    else:
        ref = po.qr_panel_pallas(jnp.asarray(a))
        got = tqr._panel_qr_t(_t(a).to(dtype))
    for g, r in zip(got, ref):
        assert g.dtype == dtype
        r = np.asarray(r)
        atol = 4 * m * _eps(np.float32) * float(np.abs(r).max())
        np.testing.assert_allclose(g.float().numpy(), r, rtol=heps, atol=atol)


@pytest.mark.parametrize("dtype,heps", HALF)
def test_gels_half_precision(dtype, heps):
    """gels_array in bf16/f16 (panels and triangular solves in f32, the
    products in the operand dtype) against ``slate_tpu``'s f32 solution of
    the same rounded operands, within 10 eps_half max|X| (reads ~1 eps:
    cond(A)^2 ~ 30 times the bf16/f16 products' rounding)."""
    m, n = 120, 50
    a = torch.from_numpy(generate("randn", m, n, dtype=np.float32, seed=81)).to(dtype)
    b = torch.from_numpy(generate("randn", m, 2, dtype=np.float32, seed=82)).to(dtype)
    xj = np.asarray(_jax_pallas(jqr.gels_array, jnp.asarray(a.float().numpy()),
                                jnp.asarray(b.float().numpy())))
    x = tqr.gels_array(a, b)
    assert x.dtype == dtype and x.shape == (n, 2)
    err = float(np.abs(x.float().numpy() - xj).max())
    assert err < 10 * heps * float(np.abs(xj).max()), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gels_omega_gate_refuses_lower_precision_products(dtype, monkeypatch):
    """The componentwise gate (20 eps / sqrt(m), the one chip_smoke holds
    gels to) passes the sound solve and refuses the same solve with
    linalg.qr's products one precision lower (bf16-rounded f32 operands for
    f32, f32 for f64); in f32 the normwise gate of run_gels passes it."""
    from slate_tpu_torch.ops.matmul import matmul
    from slate_tpu_torch.utils.testing import gels_omega, gels_omega_gate

    m, n = 512, 256
    a = torch.from_numpy(generate("randn", m, n, dtype=np.float64, seed=91)).to(dtype)
    b = torch.from_numpy(generate("randn", m, 8, dtype=np.float64, seed=92)).to(dtype)
    gate = gels_omega_gate(m, dtype)
    x = tqr.gels_array(a, b)
    assert gels_omega(a, x, b) < gate
    if dtype == torch.float32:
        low = lambda p, q, **kw: matmul(p, q, precision=tt.Precision.Fast)  # noqa: E731
    else:
        low = lambda p, q, **kw: matmul(p.float(), q.float()).to(p.dtype)  # noqa: E731
    monkeypatch.setattr(tqr, "matmul", low)
    xl = tqr.gels_array(a, b)
    assert gels_omega(a, xl, b) > 10 * gate
    if dtype == torch.float32:
        assert _gels_gate(a.numpy(), xl.numpy(), b.numpy()) < 100 * n * _eps(np.float32)


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qr_panel_check_refuses_each_zeroed_part(offset, dtype):
    """utils.testing.qr_panel_check, the rule chip_smoke and the card tests
    hold the kernels to: a panel rounded from its f64 factor passes; V
    zeroed below its pivots, R off its pivots and T's off-diagonal each
    fail their own reading, a doubled T column fails WY; every limit stays
    below 1e-2 of the scale it holds."""
    from slate_tpu_torch.utils.testing import qr_panel_check, qr_panel_mutants, qr_panel_ok

    m, w, row0 = 600, 32, (200 if offset else 0)
    a = torch.from_numpy(_panel(m, w, np.float64, seed=93, zero_col=5, row0=row0))
    if offset:
        want = tk.qr_panel_offset_plain(a.to(dtype), row0)
        got = tuple(x.to(dtype) for x in tk.qr_panel_offset_plain(a, row0))
    else:
        want = tk.qr_panel_plain(a.to(dtype))
        got = tuple(x.to(dtype) for x in tk.qr_panel_plain(a))
    a = a.to(dtype)
    if dtype == torch.float32:  # the f64 factor rounded: within the f32 limits
        c = qr_panel_check(a, got, want, offset, row0)
        assert qr_panel_ok(c), c
    else:
        got = want
    assert qr_panel_ok(qr_panel_check(a, want, want, offset, row0))
    for reading, bad in qr_panel_mutants(got, offset, row0).items():
        assert qr_panel_check(a, bad, want, offset, row0)[reading] > 1, reading


def test_complex_takes_the_plain_forms_and_refuses_trans():
    m, n = 50, 20
    a = generate("randn", m, n, dtype=np.complex64, seed=11)
    b = generate("randn", m, 2, dtype=np.complex64, seed=12)
    with tk.use_panel_impl("pallas"):
        f = tqr.geqrf_array(_t(a))
        fj = _jax_pallas(jqr.geqrf_array, jnp.asarray(a))
        x = tqr.gels_array(_t(a), _t(b)).numpy()
    _close(f.vr.numpy(), fj.vr, 100, m, np.float32, float(np.abs(a).max()) * np.sqrt(m))
    _close(x, jqr.gels_array(jnp.asarray(a), jnp.asarray(b)), 100, m, np.float32)
    assert _gels_gate(a, x, b) < 100 * n * _eps(np.float32)
    with pytest.raises(tt.SlateError, match="Op.Trans"):
        tqr.unmqr_array(tt.Side.Left, tt.Op.Trans, f, _t(b))
    lq = tqr.gelqf_array(_t(a.T.copy()))
    with pytest.raises(tt.SlateError, match="Op.Trans"):
        tqr.unmlq_array(tt.Side.Left, tt.Op.Trans, lq, _t(b))
    fs = tqr.geqrf_scan_array(_t(a), 8)
    with pytest.raises(tt.SlateError, match="Op.Trans"):
        tqr.unmqr_scan_array(fs, _t(b), tt.Op.Trans)


@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_impl_lowerings_bitwise_on_cpu(dtype):
    # on a CPU tensor the kernel wrappers take the twins, which ARE the
    # plain pairs: pallas/auto and xla give the same bits
    a = _t(generate("randn", 150, 90, dtype=dtype, seed=13))
    runs = {}
    for impl in ("xla", "pallas", "auto"):
        with tk.use_panel_impl(impl):
            f = tqr.geqrf_array(a)
            s = tqr.geqrf_scan_array(a, 32)
        runs[impl] = (f.vr, f.t, s.r, s.v, s.t)
    for impl in ("pallas", "auto"):
        for x, y in zip(runs[impl], runs["xla"]):
            assert torch.equal(x, y)


def test_qr_wrappers_take_twins_on_cpu_without_counting():
    a = _t(_panel(40, 8, np.float64, seed=21))
    before = (tk.qr_panel.launches, tk.qr_panel_offset.launches)
    for got, want in zip(tk.qr_panel(a), tk.qr_panel_plain(a)):
        assert torch.equal(got, want)
    for got, want in zip(tk.qr_panel_offset(a, 8), tk.qr_panel_offset_plain(a, 8)):
        assert torch.equal(got, want)
    assert (tk.qr_panel.launches, tk.qr_panel_offset.launches) == before


def test_geqrf_leaf_count_follows_the_split():
    # the number of 64-wide leaves of _geqrf_rec (the qr_panel launches of a
    # geqrf_array on the card): n / 64 for a multiple of 64, ceil otherwise
    def leaves(n):
        return 1 if n <= tqr._QR_PANEL else leaves(tqr._split_qr(n)) + leaves(n - tqr._split_qr(n))

    assert tqr._split_qr(16384) == jqr._split_qr(16384) == 8192
    assert leaves(16384) == 256 and leaves(8192) == 128 and leaves(70) == 2 and leaves(130) == 3


# ---------------------------------------------------------------------------
# the API verbs and the enum
# ---------------------------------------------------------------------------


def test_api_qr_verbs_match():
    m, n = 60, 25
    a = generate("randn", m, n, dtype=np.float64, seed=31)
    b = generate("randn", m, 2, dtype=np.float64, seed=32)
    _close(tapi.least_squares_solve(a, b, device="cpu").numpy(),
           japi.least_squares_solve(jnp.asarray(a), jnp.asarray(b)), 100, m, np.float64)
    f, fj = tapi.qr_factor(a, device="cpu"), japi.qr_factor(jnp.asarray(a))
    _close(f.vr.numpy(), fj.vr, 100, m, np.float64, float(np.abs(a).max()) * np.sqrt(m))
    _close(tapi.qr_multiply_by_q(f, b, tt.Side.Left, tt.Op.ConjTrans).numpy(),
           japi.qr_multiply_by_q(fj, jnp.asarray(b), jt.Side.Left, jt.Op.ConjTrans), 100, m, np.float64)
    lq, lqj = tapi.lq_factor(a.T.copy(), device="cpu"), japi.lq_factor(jnp.asarray(a.T.copy()))
    _close(tapi.lq_multiply_by_q(lq, b).numpy(), japi.lq_multiply_by_q(lqj, jnp.asarray(b)),
           100, m, np.float64)
    assert f.vr.device.type == "cpu" and lq.lv.device.type == "cpu"
    _close(tapi.qr_multiply_by_q(f, np.eye(m)[:, :n]).numpy(), np.asarray(jqr.geqrf_q(fj)), 100, m,
           np.float64, 1.0)
    assert {e.name: e.value for e in tt.MethodGels} == {e.name: e.value for e in jt.MethodGels}
