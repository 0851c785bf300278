"""The blocking of the diagonal-block kernels (csrc/chol_diag_inv.cu,
csrc/lu_diag_inv.cu, csrc/diag_block.cuh), modelled in PyTorch on the CPU and
held against the plain twins of ``slate_tpu_torch.ops.kernels``.

The CUDA kernels run only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold them against the same twins there).  This file rehearses
their algorithm here: the same 32-wide panels, identity padding of a ragged n,
the left-looking Cholesky and Crout LU steps (a product over the finished
panels, the 32 x 32 diagonal block by its column loop, the panel below by
substitution one row at a time), the inverses by block rows with the product
skipping each slab's structural zeros, U^-1 as the forward inverse of the
exchange-mirrored matrix, and the NaN rule for the twins' full-row products.

Tolerances: each output within 100 n eps of its own largest entry (L and U of
a packed LU each at their own scale), factors and inverses by reconstruction
within 3 n eps |X||Y| elementwise, the products in f64 (gamma_n of any
summation order, with room).  NaN masks (non-SPD Cholesky) and finite masks
(zero LU pivot) are held exactly, and the structural triangles are exact
zeros.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slate_tpu.ops import pallas_ops as po
from slate_tpu_torch.ops import kernels as tk

# the suite runs in several worker processes that share the cores: one
# intra-op thread each (torch defaults to one a core, which oversubscribes them)
torch.set_num_threads(1)

B = 32
NS = [1, 7, 31, 32, 33, 72, 200, 256]
DTYPES = [torch.float32, torch.float64]
# the columns that stress the blocking: the first sub-block, both sides of a
# sub-block boundary, the last column
BAD_COLS = [(n, j) for n in NS for j in sorted({0, 31, 32, n - 1}) if j < n]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _logical(m, npad, flip, diag_one):
    """The kernels' logical npad x npad view of the n x n matrix m: entries
    off the matrix read 0 (1 on the diagonal where ``diag_one``), ``flip``
    is the exchange mirror i -> npad - 1 - i."""
    n = m.shape[0]
    out = torch.eye(npad, dtype=m.dtype) if diag_one else torch.zeros((npad, npad), dtype=m.dtype)
    out[:n, :n] = m
    return out.flip(0, 1) if flip else out


def _warp_potrf(d):
    """The 32 x 32 diagonal Cholesky by its column loop (lower triangle)."""
    d = d.clone()
    for k in range(B):
        s = torch.sqrt(d[k, k])
        d[k + 1:, k] = d[k + 1:, k] * (1 / s)
        d[k, k] = s
        d[k + 1:, k + 1:] -= torch.tril(d[k + 1:, k, None] * d[None, k + 1:, k])
    return torch.tril(d)


def _warp_getrf(d):
    """The 32 x 32 no-pivot LU by its column loop, the pivot's denom rule."""
    d = d.clone()
    for k in range(B):
        piv = d[k, k]
        den = torch.where(piv == 0, torch.ones_like(piv), piv)
        d[k + 1:, k] = d[k + 1:, k] * (1 / den)
        d[k + 1:, k + 1:] -= d[k + 1:, k, None] * d[None, k, k + 1:]
    return d


def _row_solve(rows, d, chol):
    """Each row u of ``rows`` solves u L^T = w (chol) or u U = w (denom rule),
    one row per thread in the kernel, column by column.  Like the kernels,
    every division here is a product with the divisor's reciprocal (the same
    inf and NaN as the twins' divisions)."""
    rows = rows.clone()
    for c in range(B):
        dc = d[c, c]
        rows[:, c] = rows[:, c] * (1 / (dc if chol else torch.where(dc == 0, torch.ones_like(dc), dc)))
        coef = d[c + 1:, c] if chol else d[c, c + 1:]
        rows[:, c + 1:] -= rows[:, c, None] * coef[None, :]
    return rows


def model_chol(a):
    """Left-looking blocked Cholesky of the lower triangle of a (n x n)."""
    n = a.shape[0]
    npad = -(-n // B) * B
    ap = _logical(torch.tril(a), npad, False, True)
    lp = torch.zeros_like(ap)
    for jb in range(0, npad, B):
        p = ap[jb:, jb:jb + B] - lp[jb:, :jb] @ lp[jb:jb + B, :jb].T
        p[:B] = _warp_potrf(p[:B])
        p[B:] = _row_solve(p[B:], p[:B], chol=True)
        lp[jb:, jb:jb + B] = p
    return torch.tril(lp[:n, :n])


def model_getrf(a):
    """Crout LU without pivoting: packed L\\U of a (n x n)."""
    n = a.shape[0]
    npad = -(-n // B) * B
    ap = _logical(a, npad, False, True)
    lu = torch.zeros_like(ap)
    for jb in range(0, npad, B):
        e = jb + B
        # the finished panels: L left of column jb, U above row jb
        col = ap[jb:, jb:e] - lu[jb:, :jb] @ lu[:jb, jb:e]
        row = ap[jb:e, e:] - lu[jb:e, :jb] @ lu[:jb, e:]
        col[:B] = _warp_getrf(col[:B])
        col[B:] = _row_solve(col[B:], col[:B], chol=False)
        lu[jb:, jb:e] = col
        lkk = torch.tril(col[:B], -1) + torch.eye(B, dtype=a.dtype)
        for j in range(B):  # the U columns right of the block: unit-lower substitution
            row[j + 1:] -= lkk[j + 1:, j, None] * row[None, j]
        lu[jb:e, e:] = row
    return lu[:n, :n]


def model_tri_inverse(m, unit=False, flip=False):
    """X = L^-1 of the logical lower triangle of m (unit diagonal: strict
    lower read), or with ``flip`` U^-1 of its upper triangle, by block rows."""
    n = m.shape[0]
    npad = -(-n // B) * B
    real = torch.zeros(npad, dtype=torch.bool)
    real[:n] = True
    if flip:
        real = real.flip(0)
    lg = _logical(m, npad, flip, True)
    low = torch.tril(lg, -1 if unit else 0) + (torch.eye(npad, dtype=m.dtype) if unit else 0)
    # the first real row whose diagonal is zero or NaN (the NaN rule)
    first = npad
    if not unit:
        bad = torch.nonzero(real & ~(torch.diagonal(low) != 0))
        first = int(bad[0]) if len(bad) else npad
    x = torch.zeros_like(low)
    cols = torch.arange(npad)
    for ib in range(0, npad, B):
        c = torch.zeros((B, npad), dtype=m.dtype)
        c[:, ib:ib + B] = torch.eye(B, dtype=m.dtype)
        for s in range(0, ib, B):  # skip the slab's structural zeros: columns <= s + 31
            c[:, :s + B] -= low[ib:ib + B, s:s + B] @ x[s:s + B, :s + B]
        d = low[ib:ib + B, ib:ib + B]
        for t in range(B):
            if not unit:
                c[t] = c[t] * (1 / d[t, t])
            c[t + 1:] -= d[t + 1:, t, None] * c[None, t]
        rows = torch.arange(ib, ib + B)[:, None]
        c = torch.where(cols[None, :] <= rows, c, torch.zeros((), dtype=m.dtype))
        if not unit:
            c = torch.where((cols[None, :] > first) & (cols[None, :] <= rows),
                            torch.full((), float("nan"), dtype=m.dtype), c)
        # only the real entries are stored; the padded ones read back as 0
        c = torch.where(real[ib:ib + B, None] & real[None, :], c, torch.zeros((), dtype=m.dtype))
        x[ib:ib + B] = c
    if flip:
        x = x.flip(0, 1)
    return x[:n, :n]


def model_chol_diag_inv(a):
    l = model_chol(a)
    return l, model_tri_inverse(l)


def model_lu_diag_inv(a):
    lu = model_getrf(a)
    return lu, model_tri_inverse(lu, flip=True)


def model_unit_linv(lu):
    return model_tri_inverse(lu, unit=True)


# ---------------------------------------------------------------------------
# inputs and checks
# ---------------------------------------------------------------------------


def _spd(n, dtype, seed):
    g = np.random.default_rng(seed).standard_normal((n, n))
    return torch.from_numpy(g @ g.T / n + np.eye(n)).to(dtype)


def _lu_block(n, dtype, seed):
    """randn + n I: factors stably without pivoting."""
    g = np.random.default_rng(seed).standard_normal((n, n)) + n * np.eye(n)
    return torch.from_numpy(g).to(dtype)


def _eps(dtype):
    return torch.finfo(dtype).eps


def _close(got, want, n, dtype):
    """Within 100 n eps of the twin's largest entry (a limit below 1e-2 of it
    from n = 32 in f32 on)."""
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 100 * n * _eps(dtype) * scale


def _rec_ratio(lhs, rhs, want, dtype):
    """max |lhs rhs - want| / (3 n eps |lhs||rhs|), in f64; 0/0 reads 0."""
    n = lhs.shape[0]
    l64, r64 = lhs.double(), rhs.double()
    res = (l64 @ r64 - want.double()).abs()
    bound = 3 * n * _eps(dtype) * (l64.abs() @ r64.abs())
    return float(torch.nan_to_num(res / bound, nan=0.0, posinf=float("inf")).max())


# ---------------------------------------------------------------------------
# the model against the twins
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_model_matches_twin(n, dtype):
    a = _spd(n, dtype, seed=n)
    l, x = model_chol_diag_inv(a)
    lp, xp = tk.chol_diag_inv_plain(a)
    _close(l, lp, n, dtype)
    _close(x, xp, n, dtype)
    eye = torch.eye(n, dtype=torch.float64)
    assert _rec_ratio(l, l.T, a, dtype) <= 1
    assert _rec_ratio(l, x, eye, dtype) <= 1
    assert torch.equal(l.triu(1), torch.zeros_like(l)) and torch.equal(x.triu(1), torch.zeros_like(x))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_model_matches_twin(n, dtype):
    a = _lu_block(n, dtype, seed=n + 1)
    lu, x = model_lu_diag_inv(a)
    lup, xp = tk.lu_diag_inv_plain(a)
    _close(lu.tril(-1), lup.tril(-1), n, dtype)
    _close(lu.triu(), lup.triu(), n, dtype)
    _close(x, xp, n, dtype)
    eye = torch.eye(n, dtype=torch.float64)
    lo = lu.tril(-1) + torch.eye(n, dtype=dtype)
    assert _rec_ratio(lo, lu.triu(), a, dtype) <= 1
    assert _rec_ratio(lu.triu(), x, eye, dtype) <= 1
    assert torch.equal(x.tril(-1), torch.zeros_like(x))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_unit_linv_model_matches_twin(n, dtype):
    lu = tk.lu_diag_inv_plain(_lu_block(n, dtype, seed=n + 2))[0]
    x = model_unit_linv(lu)
    xp = tk.unit_linv_plain(lu)
    _close(x, xp, n, dtype)
    lo = lu.tril(-1) + torch.eye(n, dtype=dtype)
    assert _rec_ratio(lo, x, torch.eye(n, dtype=torch.float64), dtype) <= 1
    assert torch.equal(x.triu(1), torch.zeros_like(x))


@pytest.mark.parametrize("n,j", BAD_COLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_model_nan_pattern_of_a_bad_pivot(n, j, dtype):
    # a[j, j] = -1 makes pivot j the first non-positive one; L and L^-1 must
    # be NaN exactly where the twin's are (its full-row products included)
    a = _spd(n, dtype, seed=3 * n + j)
    a[j, j] = -1.0
    l, x = model_chol_diag_inv(a)
    lp, xp = tk.chol_diag_inv_plain(a)
    assert torch.equal(torch.isnan(l), torch.isnan(lp))
    assert torch.equal(torch.isnan(x), torch.isnan(xp))
    nan_diag = torch.nonzero(torch.isnan(torch.diagonal(l)))
    assert int(nan_diag[0]) == j
    assert torch.equal(l.triu(1), torch.zeros_like(l)) and torch.equal(x.triu(1), torch.zeros_like(x))
    good = ~torch.isnan(lp)
    if bool(good.any()):
        _close(l[good], lp[good], n, dtype)


@pytest.mark.parametrize("n,j", BAD_COLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_model_zero_pivot_pattern(n, j, dtype):
    # row j zero: U(j, j) = 0 exactly.  The factor divides by 1 there and
    # stays finite; U^-1 divides by the raw 0, and every row above the last
    # zero pivot is non-finite in the twin's full-row back substitution
    a = _lu_block(n, dtype, seed=5 * n + j)
    a[j, :] = 0
    lu, x = model_lu_diag_inv(a)
    lup, xp = tk.lu_diag_inv_plain(a)
    assert bool(torch.isfinite(lu).all()) and float(lu[j, j]) == 0.0
    assert torch.equal(torch.isfinite(x), torch.isfinite(xp))
    assert torch.equal(x.tril(-1), torch.zeros_like(x))
    _close(lu.tril(-1), lup.tril(-1), n, dtype)
    _close(lu.triu(), lup.triu(), n, dtype)
    linv, linvp = model_unit_linv(lu), tk.unit_linv_plain(lup)
    assert bool(torch.isfinite(linv).all()) and bool(torch.isfinite(linvp).all())
    _close(linv, linvp, n, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_model_two_zero_pivots_in_different_sub_blocks(dtype):
    n = 72
    a = _lu_block(n, dtype, seed=7)
    a[5, :] = 0
    a[40, :] = 0
    lu, x = model_lu_diag_inv(a)
    _, xp = tk.lu_diag_inv_plain(a)
    assert torch.equal(torch.isfinite(x), torch.isfinite(xp))
    upper = torch.ones((41, n), dtype=torch.bool).triu()
    assert not bool(torch.isfinite(x[:41][upper]).any()) and bool(torch.isfinite(x[41:]).all())


def test_the_nan_rule_is_what_makes_the_masks_equal():
    # without the rule the triangular order leaves entries left of the zero
    # pivot finite (e.g. U^-1(0, 0) = 1 / U(0, 0)) that the twin has non-finite
    n, j = 72, 40
    a = _lu_block(n, torch.float64, seed=8)
    a[j, :] = 0
    lu = model_getrf(a)
    xp = tk.lu_diag_inv_plain(a)[1]
    assert not math.isfinite(float(xp[0, 0]))
    u = torch.triu(lu)
    tri = torch.zeros_like(u)
    for c in range(n):  # column by column, rows <= c only
        for t in range(c, -1, -1):
            tri[t, c] = ((1.0 if t == c else 0.0) - (u[t, t + 1:c + 1] * tri[t + 1:c + 1, c]).sum()) / u[t, t]
    assert math.isfinite(float(tri[0, 0]))
    assert not torch.equal(torch.isfinite(tri), torch.isfinite(xp))
    assert torch.equal(torch.isfinite(model_tri_inverse(lu, flip=True)), torch.isfinite(xp))


# ---------------------------------------------------------------------------
# the model against slate_tpu's bodies (what the TPU kernels run)
# ---------------------------------------------------------------------------


def test_chol_model_matches_slate_tpu_body():
    n = 64
    a = _spd(n, torch.float32, seed=64)
    l_ref, x_ref = (torch.from_numpy(np.array(v)) for v in po._chol_inv_body(jnp.asarray(a.numpy())))
    l, x = model_chol_diag_inv(a)
    _close(l, l_ref, n, torch.float32)
    _close(x, x_ref, n, torch.float32)


def test_lu_model_matches_slate_tpu_body():
    n = 64
    a = _lu_block(n, torch.float32, seed=65)
    lu_ref, x_ref = (torch.from_numpy(np.array(v)) for v in po._lu_inv_body(jnp.asarray(a.numpy())))
    lu, x = model_lu_diag_inv(a)
    _close(lu.tril(-1), lu_ref.tril(-1), n, torch.float32)
    _close(lu.triu(), lu_ref.triu(), n, torch.float32)
    _close(x, x_ref, n, torch.float32)


def test_unit_linv_model_matches_slate_tpu_body():
    n = 64
    lu = tk.lu_diag_inv_plain(_lu_block(n, torch.float32, seed=66))[0]
    x_ref = torch.from_numpy(np.array(po._unit_linv_body(jnp.asarray(lu.numpy()))))
    _close(model_unit_linv(lu), x_ref, n, torch.float32)
