"""Level-3 BLAS drivers of the port.

Counterpart of ``slate_tpu/blas3/blas3.py`` (``src/{gemm,hemm,symm,herk,
syrk,her2k,syr2k,trmm,trsm,gbmm,hbmm}.cc``): gemm; hemm / symm (the full
matrix rebuilt from its stored triangle, one product); herk / syrk /
her2k / syr2k (the products, then only the ``uplo`` triangle of C
updated); the recursive triangular multiply and solve; gbmm / hbmm (band
operands stored dense, projected on their (kl, ku)).  The recursions keep
``slate_tpu``'s blocking: split at a power-of-two multiple of ``_NB``, one
``matmul`` for the off-diagonal block.  The solve's leaves are
``torch.linalg.solve_triangular`` (cuBLAS/LAPACK trsm), the counterpart of
XLA's ``triangular_solve`` (:func:`solve_tri`: in f32 for bf16/f16, which
PyTorch's solve does not take).  Every product is ``ops.matmul.matmul`` at
Option.Precision (Highest unless asked: never TF32).  ``tbsm`` solves a
triangular band (stored dense) after applying LU pivots as LAPACK's laswp
does: the interchanges one after another.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Union

import numpy as np
import torch

from ..core.matrix import (
    BaseMatrix,
    HermitianMatrix,
    SymmetricMatrix,
    TriangularMatrix,
    band_project,
    operand_device,
    symmetrize,
    tri_project,
)
from ..ops.matmul import matmul
from ..types import Diag, Op, Option, Options, Precision, Side, Uplo, get_option

ArrayLike = Union[torch.Tensor, BaseMatrix]

# base-case size for the recursive triangular algorithms
_NB = 256


def _arr(x: ArrayLike, device: torch.device) -> torch.Tensor:
    """The logical tensor of ``x`` (a view with its op applied, a tensor, a
    numpy array or a list) on ``device``."""
    return torch.as_tensor(x.array if isinstance(x, BaseMatrix) else x, device=device)


def _mul_prec(opts: Optional[Options]) -> Precision:
    """Precision tier for multiply-class drivers: Highest unless
    Option.Precision says otherwise."""
    p = get_option(opts, Option.Precision, None) if opts else None
    if p is not None:
        return Precision(p)
    return Precision.Highest


def _wrap_like(c: ArrayLike, data: torch.Tensor):
    if isinstance(c, BaseMatrix):
        if c.op != Op.NoTrans:
            und = data.T if c.op == Op.Trans else data.conj().T
            return replace(c, data=und)
        return replace(c, data=data)
    return data


def _other(uplo: Uplo) -> Uplo:
    return Uplo.Upper if uplo == Uplo.Lower else Uplo.Lower


def conj_scalar(x):
    """conj of a scalar alpha / beta (a Python number or a 0-d tensor)."""
    if isinstance(x, torch.Tensor):
        return x.conj()
    return x.conjugate() if isinstance(x, complex) else x


def gemm_array(
    alpha, a: torch.Tensor, b: torch.Tensor, beta, c: torch.Tensor,
    precision: Optional[Precision] = None,
) -> torch.Tensor:
    """C := alpha*A@B + beta*C on plain tensors."""
    ab = matmul(a, b, precision=precision)
    return alpha * ab.to(c.dtype) + beta * c


def gemm(alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike, opts: Optional[Options] = None,
         device=None):
    """slate::gemm over matrix views, on ``operand_device(a, device)``."""
    dev = operand_device(a, device)
    return _wrap_like(c, gemm_array(alpha, _arr(a, dev), _arr(b, dev), beta, _arr(c, dev),
                                    precision=_mul_prec(opts)))


def _side_mul(side: Side, alpha, afull: torch.Tensor, b: torch.Tensor, beta, c: torch.Tensor,
              precision: Optional[Precision] = None) -> torch.Tensor:
    prod = matmul(afull, b, precision=precision) if side == Side.Left else matmul(b, afull, precision=precision)
    return alpha * prod.to(c.dtype) + beta * c


def _sym_mul(side: Side, alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike, opts, device,
             conj: bool):
    dev = operand_device(a, device)
    kind = HermitianMatrix if conj else SymmetricMatrix
    am = a if isinstance(a, BaseMatrix) else kind.from_array(a, Uplo.Lower)
    afull = symmetrize(torch.as_tensor(am.data, device=dev), am.uplo, conj=conj)
    return _wrap_like(c, _side_mul(side, alpha, afull, _arr(b, dev), beta, _arr(c, dev),
                                   precision=_mul_prec(opts)))


def hemm(side: Side, alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike,
         opts: Optional[Options] = None, device=None):
    """slate::hemm (src/hemm.cc): C := alpha A B + beta C (Left) or
    alpha B A + beta C (Right), A Hermitian; a plain tensor is read as its
    lower triangle."""
    return _sym_mul(side, alpha, a, b, beta, c, opts, device, conj=True)


def symm(side: Side, alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike,
         opts: Optional[Options] = None, device=None):
    """slate::symm (src/symm.cc): A symmetric (not conjugated)."""
    return _sym_mul(side, alpha, a, b, beta, c, opts, device, conj=False)


def _rank_k_update(alpha, a: torch.Tensor, beta, c, uplo: Uplo, conj: bool,
                   two_sided_b: Optional[torch.Tensor] = None,
                   precision: Optional[Precision] = None):
    """alpha A op(A) (or alpha A op(B) + op(alpha) B op(A)) + beta C, where
    only the ``uplo`` triangle of C is written; a Hermitian / symmetric
    view of C is read through its stored triangle."""
    cm = c if isinstance(c, BaseMatrix) else None
    cdata = torch.as_tensor(cm.data if cm is not None else c, device=a.device)
    at = a.conj().T if conj else a.T
    if two_sided_b is None:
        new = alpha * matmul(a, at, precision=precision).to(cdata.dtype)
    else:
        bt = two_sided_b.conj().T if conj else two_sided_b.T
        upd1 = matmul(a, bt, precision=precision).to(cdata.dtype)
        upd2 = matmul(two_sided_b, at, precision=precision).to(cdata.dtype)
        new = alpha * upd1 + (conj_scalar(alpha) if conj else alpha) * upd2
    full = new + beta * (symmetrize(cdata, uplo, conj) if cm is not None else cdata)
    out = (tri_project(full, uplo) + tri_project(cdata, _other(uplo), Diag.NonUnit)
           - torch.diag(cdata.diagonal()))
    return replace(cm, data=out) if cm is not None else out


def _c_uplo(c, uplo: Optional[Uplo]) -> Uplo:
    return uplo or (c.uplo if isinstance(c, BaseMatrix) else Uplo.Lower)


def herk(alpha, a: ArrayLike, beta, c: ArrayLike, uplo: Optional[Uplo] = None,
         opts: Optional[Options] = None, device=None):
    """slate::herk (src/herk.cc): C := alpha A A^H + beta C, C Hermitian."""
    dev = operand_device(a, device)
    return _rank_k_update(alpha, _arr(a, dev), beta, c, _c_uplo(c, uplo), conj=True,
                          precision=_mul_prec(opts))


def syrk(alpha, a: ArrayLike, beta, c: ArrayLike, uplo: Optional[Uplo] = None,
         opts: Optional[Options] = None, device=None):
    """slate::syrk: C := alpha A A^T + beta C, C symmetric."""
    dev = operand_device(a, device)
    return _rank_k_update(alpha, _arr(a, dev), beta, c, _c_uplo(c, uplo), conj=False,
                          precision=_mul_prec(opts))


def her2k(alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike, uplo: Optional[Uplo] = None,
          opts: Optional[Options] = None, device=None):
    """slate::her2k: C := alpha A B^H + conj(alpha) B A^H + beta C."""
    dev = operand_device(a, device)
    return _rank_k_update(alpha, _arr(a, dev), beta, c, _c_uplo(c, uplo), conj=True,
                          two_sided_b=_arr(b, dev), precision=_mul_prec(opts))


def syr2k(alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike, uplo: Optional[Uplo] = None,
          opts: Optional[Options] = None, device=None):
    """slate::syr2k: C := alpha A B^T + alpha B A^T + beta C."""
    dev = operand_device(a, device)
    return _rank_k_update(alpha, _arr(a, dev), beta, c, _c_uplo(c, uplo), conj=False,
                          two_sided_b=_arr(b, dev), precision=_mul_prec(opts))


# below this size the dense-masked multiply (one matmul on the projected
# triangle) replaces the recursion, as in slate_tpu
_TRMM_DENSE_MAX = 1024


def _tri_full(a: torch.Tensor, uplo: Uplo, diag: Diag) -> torch.Tensor:
    return tri_project(a, uplo, diag)


def _trmm_ll(a: torch.Tensor, b: torch.Tensor, diag: Diag, precision) -> torch.Tensor:
    """B := L B, recursive blocked (half the flops of the dense-masked form)."""
    n = a.shape[0]
    if n <= _TRMM_DENSE_MAX:
        return matmul(_tri_full(a, Uplo.Lower, diag), b, precision=precision).to(b.dtype)
    h = _split(n)
    top = _trmm_ll(a[:h, :h], b[:h], diag, precision)
    bot = matmul(a[h:, :h], b[:h], precision=precision).to(b.dtype)
    bot = bot + _trmm_ll(a[h:, h:], b[h:], diag, precision)
    return torch.cat([top, bot], dim=0)


def _trmm_lu(a: torch.Tensor, b: torch.Tensor, diag: Diag, precision) -> torch.Tensor:
    """B := U B, recursive blocked."""
    n = a.shape[0]
    if n <= _TRMM_DENSE_MAX:
        return matmul(_tri_full(a, Uplo.Upper, diag), b, precision=precision).to(b.dtype)
    h = _split(n)
    top = _trmm_lu(a[:h, :h], b[:h], diag, precision)
    top = top + matmul(a[:h, h:], b[h:], precision=precision).to(b.dtype)
    bot = _trmm_lu(a[h:, h:], b[h:], diag, precision)
    return torch.cat([top, bot], dim=0)


def trmm_array(side: Side, uplo: Uplo, op: Op, diag: Diag, alpha, a: torch.Tensor,
               b: torch.Tensor, precision: Optional[Precision] = None) -> torch.Tensor:
    """B := alpha op(A) B (Left) or alpha B op(A) (Right), A triangular
    (src/trmm.cc).  All eight (side, uplo, op) combinations reduce to the
    two left-notrans recursions, as trsm_array's routing."""
    b = torch.as_tensor(b, device=a.device)
    if side == Side.Right:
        # B op(A) = (op(A)^T B^T)^T
        if op == Op.NoTrans:
            out = trmm_array(Side.Left, uplo, Op.Trans, diag, alpha, a, b.T, precision)
        elif op == Op.Trans:
            out = trmm_array(Side.Left, uplo, Op.NoTrans, diag, alpha, a, b.T, precision)
        else:  # B A^H = (conj(A) B^T)^T
            out = trmm_array(Side.Left, uplo, Op.NoTrans, diag, alpha, a.conj(), b.T, precision)
        return out.T
    if op == Op.Trans:
        return trmm_array(Side.Left, _other(uplo), Op.NoTrans, diag, alpha, a.T, b, precision)
    if op == Op.ConjTrans:
        return trmm_array(Side.Left, _other(uplo), Op.NoTrans, diag, alpha, a.conj().T, b,
                          precision)
    core = _trmm_ll if uplo == Uplo.Lower else _trmm_lu
    return alpha * core(a, b, diag, precision)


def trmm(side: Side, alpha, a: ArrayLike, b: ArrayLike, opts: Optional[Options] = None,
         device=None):
    """slate::trmm over matrix views, on ``operand_device(a, device)``; a
    plain tensor is read as its lower triangle."""
    dev = operand_device(a, device)
    am = a if isinstance(a, BaseMatrix) else TriangularMatrix.from_array(_arr(a, dev), Uplo.Lower)
    out = trmm_array(side, am.uplo, am.op, am.diag, alpha, torch.as_tensor(am.data, device=dev),
                     _arr(b, dev), precision=_mul_prec(opts))
    return _wrap_like(b, out)


def split_pow2(n: int, base: int) -> int:
    """Largest power-of-two multiple of ``base`` below n — the split policy
    of every recursive blocked algorithm."""
    h = base
    while h * 2 < n:
        h *= 2
    return h


def _split(n: int) -> int:
    return split_pow2(n, _NB)


def solve_tri(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """``torch.linalg.solve_triangular`` for every real dtype: PyTorch has
    no bf16/f16 triangular solve on either device, so half precision is
    solved in f32 and cast back."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return torch.linalg.solve_triangular(a.float(), b.float(), **kw).to(b.dtype)
    return torch.linalg.solve_triangular(a, b, **kw)


def _trsm_left_lower_notrans(a: torch.Tensor, b: torch.Tensor, diag: Diag) -> torch.Tensor:
    """Solve L X = B, L lower triangular, recursive blocked."""
    n = a.shape[0]
    unit = diag == Diag.Unit
    if n <= _NB:
        if b.shape[1] > n:
            # wide RHS: invert the small triangle against eye and ride one
            # gemm (the explicit-inverse trade of slate_tpu, O(eps cond(L11)))
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            linv = solve_tri(a, eye, upper=False, unitriangular=unit)
            return matmul(linv, b).to(b.dtype)
        return solve_tri(a, b, upper=False, unitriangular=unit)
    h = _split(n)
    # slate_tpu concatenates the two halves; here they are written into one
    # preallocated result
    x = torch.empty_like(b)
    x[:h] = _trsm_left_lower_notrans(a[:h, :h], b[:h], diag)
    rhs2 = b[h:] - matmul(a[h:, :h], x[:h]).to(b.dtype)
    x[h:] = _trsm_left_lower_notrans(a[h:, h:], rhs2, diag)
    return x


def trsm_array(
    side: Side, uplo: Uplo, op: Op, diag: Diag, alpha, a: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Solve op(A) X = alpha B / X op(A) = alpha B.

    All eight (side, uplo, op) combinations reduce to the left-lower-notrans
    recursion via transposition identities, as in ``slate_tpu``."""
    b = torch.as_tensor(b, device=a.device) * alpha
    if side == Side.Right:
        # X op(A) = B  <=>  op(A)^T X^T = B^T
        if op == Op.NoTrans:
            out = trsm_array(Side.Left, uplo, Op.Trans, diag, 1.0, a, b.T)
        elif op == Op.Trans:
            out = trsm_array(Side.Left, uplo, Op.NoTrans, diag, 1.0, a, b.T)
        else:  # conj(A) X^T = B^T
            out = trsm_array(Side.Left, uplo, Op.NoTrans, diag, 1.0, a.conj(), b.T)
        return out.T
    if op == Op.Trans:
        return trsm_array(Side.Left, _other(uplo), Op.NoTrans, diag, 1.0, a.T, b)
    if op == Op.ConjTrans:
        return trsm_array(Side.Left, _other(uplo), Op.NoTrans, diag, 1.0, a.conj().T, b)
    if uplo == Uplo.Upper:
        # U X = B: flip to lower by reversing indices (torch has no negative
        # strides, so torch.flip copies where slate_tpu takes a[::-1, ::-1])
        x = _trsm_left_lower_notrans(torch.flip(a, (0, 1)), torch.flip(b, (0,)), diag)
        return torch.flip(x, (0,))
    return _trsm_left_lower_notrans(a, b, diag)


def trsm(side: Side, alpha, a: ArrayLike, b: ArrayLike, opts: Optional[Options] = None,
         device=None):
    """slate::trsm over matrix views, on ``operand_device(a, device)``;
    ``opts`` is accepted for option symmetry with the other drivers."""
    dev = operand_device(a, device)
    am = a if isinstance(a, BaseMatrix) else TriangularMatrix.from_array(_arr(a, dev), Uplo.Lower)
    out = trsm_array(side, am.uplo, am.op, am.diag, alpha, torch.as_tensor(am.data, device=dev), _arr(b, dev))
    return _wrap_like(b, out)


# ---------------------------------------------------------------------------
# band (src/gbmm.cc, hbmm.cc): dense storage, the zero pattern by (kl, ku)
# ---------------------------------------------------------------------------


def gbmm(alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike, opts: Optional[Options] = None,
         device=None):
    """slate::gbmm: general band times dense; a band view is projected on
    its (kl, ku) first, a plain tensor taken whole."""
    dev = operand_device(a, device)
    am = a if isinstance(a, BaseMatrix) else None
    ad = _arr(a, dev)
    if am is not None and am.kl is not None:
        ad = band_project(ad, am.kl, am.ku)
    return _wrap_like(c, gemm_array(alpha, ad, _arr(b, dev), beta, _arr(c, dev),
                                    precision=_mul_prec(opts)))


def hbmm(side: Side, alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike,
         opts: Optional[Options] = None, device=None):
    """slate::hbmm: Hermitian band times dense; a plain tensor is read as
    its lower triangle."""
    dev = operand_device(a, device)
    am = a if isinstance(a, BaseMatrix) else None
    if am is not None and am.kl is not None:
        stored = band_project(torch.as_tensor(am.data, device=dev), am.kl, am.ku)
        afull = symmetrize(stored, am.uplo, conj=True)
    else:
        afull = symmetrize(_arr(a, dev), Uplo.Lower, conj=True)
    return _wrap_like(c, _side_mul(side, alpha, afull, _arr(b, dev), beta, _arr(c, dev),
                                   precision=_mul_prec(opts)))


def tbsm(side: Side, alpha, a: ArrayLike, b: ArrayLike, pivots=None, device=None):
    """slate::tbsm: triangular-band solve, optionally applying LU pivots
    first (src/tbsm.cc, the tbsmPivots path), on ``operand_device(a,
    device)``; a plain tensor ``a`` is read as its lower triangle."""
    dev = operand_device(a, device)
    am = a if isinstance(a, BaseMatrix) else TriangularMatrix.from_array(_arr(a, dev), Uplo.Lower)
    bd = _arr(b, dev)
    if pivots is not None:
        bd = _apply_pivots(bd, pivots, forward=True)
    out = trsm_array(side, am.uplo, am.op, am.diag, alpha, torch.as_tensor(am.data, device=dev), bd)
    return _wrap_like(b, out)


def _apply_pivots(b: torch.Tensor, pivots, forward: bool) -> torch.Tensor:
    """Row interchanges in sequence, LAPACK laswp style: step i swaps rows i
    and pivots[i] of the result of step i - 1 (in reverse order when not
    ``forward``).  The pivots are read on the host once; a swap of a row
    with itself is skipped (it moves nothing)."""
    piv = np.asarray(torch.as_tensor(pivots).cpu()).astype(np.int64)
    out = b.clone()
    steps = range(len(piv)) if forward else range(len(piv) - 1, -1, -1)
    for i in steps:
        p = int(piv[i])
        if p != i:
            out[[i, p]] = out[[p, i]]
    return out
