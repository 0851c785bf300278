"""f64 matmul as a sum of exact int8 products: the Ozaki split-integer GEMM.

Counterpart of ``slate_tpu/ops/ozaki.py``, with its constants, functions and
order of operations:

  1. Split each f64 element exactly into two f32 components x = hi + lo
     (hi = f32(x), lo = f32(x - hi)).
  2. Row-scale A (column-scale B) by a power of two 2^-e so |x'| < 1 per row
     (e read from the IEEE exponent field of the f32 row max).
  3. Slice hi' and lo' into signed 6-bit digits on the shared row grid
     (weights 2^(-6(t+1))) in f32; every step is exact.  Summing the hi and
     lo digit planes gives int8 digits of x' in [-64, 64].
  4. Every digit-plane product is EXACT in int32 (the contraction is chunked
     at ``_K_CHUNK`` so the accumulator stays below 2^31).
  5. C = 2^(ea+eb) sum_{t+u<S} (qa_t @ qb_u) 2^(-6(t+u+2)).

The t + u = s anti-diagonals are one integer product each over a joint
(slice, k) contraction axis.  Here that product is ``torch._int_mm`` (int8 x
int8 -> int32, exact): ``slate_tpu`` computes it outside any Pallas kernel
too, with ``lax.dot_general`` into int32.  ``_int_mm`` on the card wants
m > 16 and k, n multiples of 8, so :func:`_int_mm_nt` pads with zero
digits (exact) on every device.

Every other step is an elementwise IEEE operation in ``slate_tpu``'s order
(the hi/lo split, the digit slicing, the f32 TwoSum pair cascade of
:func:`matmul_planes`, the f64 fold of :func:`accumulate_diag_planes`, the
power-of-two scales), so the results are bitwise ``slate_tpu``'s.  One rule
makes that hold for tiny elements: the TPU has no f32 subnormals and XLA's
CPU backend runs with flush-to-zero, so ``slate_tpu``'s hi and lo are 0
wherever f32 would be subnormal.  :func:`_split_f32` flushes them the same
way (PyTorch keeps subnormals on the CPU and the card).

Elements whose row max is outside the f32 exponent range (> ~1e38 or
< ~1e-38) are not supported, as in ``slate_tpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

_W = 5          # magnitude bits per digit: |digit component| <= 2^_W = 32
_D = _W + 1     # grid step in bits; hi+lo digit sums are <= 2^_D = 64
# Largest contraction chunk whose int32 accumulator cannot overflow:
# (s+1) * k * 2^(2*_D) < 2^31 with s+1 <= 16  =>  k < 2^(31-12-4) = 2^15.
_K_CHUNK = 8192
_DEFAULT_SLICES = 9  # 6*9 = 54 bits > f64's 53-bit significand

_TINY32 = torch.finfo(torch.float32).tiny


def _exp2i(e: Tensor) -> Tensor:
    """Exact f32 2^e for integer-valued f32 ``e`` in [-126, 127], from the
    IEEE-754 bit pattern (no libm exp2)."""
    bits = (e.to(torch.int32) + 127) << 23
    return bits.view(torch.float32)


def _row_exp(absmax32: Tensor) -> Tensor:
    """Exponent e (f32) with absmax < 2^e, read from the f32 exponent field,
    clipped so 2^e and 2^-e stay normal."""
    bits = absmax32.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 126  # unbiased exponent + 1: 2^e > absmax
    e = torch.where(absmax32 > 0, e, torch.zeros_like(e))
    return e.clamp(-125, 126).to(torch.float32)


def _slice_digits(hi: Tensor, lo: Tensor, e: Tensor, n_slices: int) -> Tensor:
    """Digit planes (n_slices, *x.shape) int8 of (hi + lo) * 2^-e: each f32
    component sliced on the shared per-row grid, then the planes summed."""
    scale = _exp2i(-e)  # exact f32 power of two

    def planes(comp):
        r = comp * scale
        digs = []
        for t in range(n_slices):
            shift = float(2.0 ** (_D * (t + 1)))  # exact in f32
            q = torch.floor(r * shift + 0.5)
            r = r - q / shift
            digs.append(q.to(torch.int8))
        return torch.stack(digs)

    return planes(hi) + planes(lo)


def _flush32(x: Tensor) -> Tensor:
    """f32 subnormals to zero, as on ``slate_tpu``'s platforms."""
    return torch.where(x.abs() < _TINY32, torch.zeros_like(x), x)


def _split_f32(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact two-f32 decomposition of f64 ``x`` (hi = f32(x), lo = rest),
    with f32 subnormals flushed (module doc)."""
    hi = _flush32(x.to(torch.float32))
    lo = _flush32((x - hi.to(x.dtype)).to(torch.float32))
    return hi, lo


def split_rows(x: Tensor, n_slices: int = _DEFAULT_SLICES, e: Optional[Tensor] = None):
    """Digit planes + row exponents of an (m, k) f64 operand: ``(q, e)``
    with q (n_slices, m, k) int8 and e (m, 1) f32.  A given ``e`` must bound
    every row (|x[i, :]| < 2^e[i]); ``slate_tpu`` documents the contract."""
    hi, lo = _split_f32(x)
    if e is None:
        e = _row_exp(hi.abs().amax(dim=1, keepdim=True))
    return _slice_digits(hi, lo, e, n_slices), e


def matmul_f64(a: Tensor, b: Tensor, n_slices: int = _DEFAULT_SLICES) -> Tensor:
    """f64-accurate ``a @ b`` as Ozaki-split int8 products (a (m, k), b
    (k, n), both f64).  n_slices = 9 is full f64 accuracy, 6 the faster
    ~2^-36 tier."""
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"matmul_f64 requires f64 operands, got {a.dtype}, {b.dtype}")
    qa, ea = split_rows(a, n_slices)
    qb, eb = split_rows(b.T, n_slices)
    return matmul_planes(qa, ea, qb, eb)


def _pad_to(x: Tensor, rows: int, cols: int) -> Tensor:
    if x.shape == (rows, cols):
        return x
    return torch.nn.functional.pad(x, (0, cols - x.shape[1], 0, rows - x.shape[0]))


def _int_mm_nt(a: Tensor, bt: Tensor) -> Tensor:
    """int32 ``a @ bt.T`` of int8 (m, k) and (n, k) row-major operands by
    ``torch._int_mm`` (its second operand column-major, the layout its card
    path takes), padded with zero digits to its shape rules (m > 16; k and
    n multiples of 8)."""
    m, k = a.shape
    n = bt.shape[0]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    out = torch._int_mm(_pad_to(a, mp, kp).contiguous(), _pad_to(bt, np_, kp).contiguous().T)
    return out[:m, :n]


def matmul_planes(qa: Tensor, ea: Tensor, qb: Tensor, eb: Tensor) -> Tensor:
    """f64 product A @ B^T from pre-split digit planes (split_rows of A
    (m, k) and of B^T (n, k)): the reuse entry point."""
    n_slices, m, k = qa.shape
    assert qb.shape[0] == n_slices and qb.shape[2] == k, (qa.shape, qb.shape)
    n = qb.shape[1]
    nchunks = -(-k // _K_CHUNK)

    def diag_term(s):
        # [qa_0 .. qa_s] against [qb_s .. qb_0] over a joint (slice, k)
        # contraction axis, chunked in k
        at, bt = qa[: s + 1], qb[: s + 1].flip(0)
        acc = None
        for c in range(nchunks):
            sl = slice(c * _K_CHUNK, min((c + 1) * _K_CHUNK, k))
            a2 = at[..., sl].permute(1, 0, 2).reshape(m, -1)
            b2 = bt[..., sl].permute(1, 0, 2).reshape(n, -1)
            ci = _int_mm_nt(a2, b2)
            acc = ci if acc is None else acc + ci
        return acc

    sa = _exp2i(ea).to(torch.float64)          # (m, 1)
    sb = _exp2i(eb).to(torch.float64).T        # (1, n)
    # weighted terms summed in f32 pairs (TwoSum cascade), slate_tpu's order
    hi = torch.zeros((m, n), dtype=torch.float32, device=qa.device)
    lo = torch.zeros((m, n), dtype=torch.float32, device=qa.device)
    for s in range(n_slices):
        w = float(2.0 ** (-_D * (s + 2)))
        t = diag_term(s)
        th = t.to(torch.float32)
        tl = (t - th.to(torch.int32)).to(torch.float32)
        for x in (th * w, tl * w):
            ssum = hi + x
            bb = ssum - hi
            err = (hi - (ssum - bb)) + (x - bb)
            hi = ssum
            lo = lo + err
    out = hi.to(torch.float64) + lo.to(torch.float64)
    return out * sa * sb


# ---------------------------------------------------------------------------
# Block-cyclic tile-stack forms: the pieces the mesh residual SUMMA
# (parallel/summa.gemm_summa_ozaki) composes.  The summation order is fixed
# by the logical k order whatever the mesh shape, so results are bitwise the
# same across (p, q) grids.
# ---------------------------------------------------------------------------


def row_exp_from_absmax(absmax32: Tensor) -> Tensor:
    """Per-row digit-grid exponents from an f32 row-max tensor of any shape."""
    return _row_exp(absmax32)


def split_tiles(x: Tensor, e: Tensor, n_slices: int = _DEFAULT_SLICES) -> Tensor:
    """Digit planes (n_slices, *x.shape) int8 of an f64 tile stack; ``e``
    broadcasts against ``x`` and bounds each scaled row (the split_rows
    contract)."""
    hi, lo = _split_f32(x)
    return _slice_digits(hi, lo, e, n_slices)


def plane_diag_term(qa: Tensor, qb: Tensor, s: int) -> Tensor:
    """One t + u == s anti-diagonal of a batched tile product: qa (S, I, nb,
    nb) planes of an A tile column, qb (S, J, nb, nb) of a B tile row;
    returns (I, J, nb, nb) int32 = sum_{t+u=s} qa_t[i] @ qb_u[j], EXACT.
    ``slate_tpu``'s einsum "tiab,tjbc->ijac" as one 2-D product of an
    (I nb) x ((s+1) nb) matrix by a ((s+1) nb) x (J nb) one (held as its
    (J nb) x ((s+1) nb) transpose)."""
    _, I, nb, nbk = qa.shape
    J, nbc = qb.shape[1], qb.shape[3]
    at = qa[: s + 1]                         # (s+1, I, nb, nbk)
    bt = qb[: s + 1].flip(0)                 # qb[s::-1]: (s+1, J, nbk, nbc)
    a2 = at.permute(1, 2, 0, 3).reshape(I * nb, (s + 1) * nbk)
    b2 = bt.permute(1, 3, 0, 2).reshape(J * nbc, (s + 1) * nbk)
    c2 = _int_mm_nt(a2, b2)
    return c2.reshape(I, nb, J, nbc).permute(0, 2, 1, 3)


def accumulate_diag_planes(acc: Tensor, qa: Tensor, qb: Tensor, n_slices: int) -> Tensor:
    """Fold every t + u == s diagonal of one (A tile column) x (B tile row)
    product into the f64 accumulator, in place: the per-k-step consume of
    the mesh Ozaki SUMMA.  The int32 -> f64 conversion and the power-of-two
    weight are exact, so each slice costs one rounding f64 add, in
    ``slate_tpu``'s order.  Returns ``acc``."""
    for s in range(n_slices):
        w = 2.0 ** (-_D * (s + 2))
        t = plane_diag_term(qa, qb, s)
        acc.add_(t.to(torch.float64).mul_(w))
    return acc


def scale_rows_cols_f64(acc: Tensor, sa: Tensor, sb: Tensor) -> Tensor:
    """Final epilogue: the exact power-of-two row/column scales."""
    return acc * sa * sb


def exp2_scale_f64(e: Tensor) -> Tensor:
    """2^e as exact f64 (an f32 power of two widened)."""
    return _exp2i(e).to(torch.float64)


def matmul_c128(a: Tensor, b: Tensor, n_slices: int = _DEFAULT_SLICES) -> Tensor:
    """complex128 ``a @ b`` as three real Ozaki products (Karatsuba):
    (m1 - m2) + i (m3 - m1 - m2), m1 = ar br, m2 = ai bi,
    m3 = (ar + ai)(br + bi)."""
    if a.dtype != torch.complex128 or b.dtype != torch.complex128:
        raise TypeError(f"matmul_c128 requires c128 operands, got {a.dtype}, {b.dtype}")
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    m1 = matmul_f64(ar, br, n_slices=n_slices)
    m2 = matmul_f64(ai, bi, n_slices=n_slices)
    m3 = matmul_f64(ar + ai, br + bi, n_slices=n_slices)
    return torch.complex(m1 - m2, m3 - m1 - m2)
