"""Level-3 BLAS drivers of the port: gemm and the recursive triangular solve.

Counterpart of the gemm and trsm parts of ``slate_tpu/blas3/blas3.py``.
The triangular solve keeps ``slate_tpu``'s recursive blocking: split at a
power-of-two multiple of ``_NB``, solve the leading block, one ``matmul``
for the off-diagonal block, recurse on the trailing block.  The leaves are
``torch.linalg.solve_triangular`` (cuBLAS/LAPACK trsm), the counterpart of
XLA's ``triangular_solve`` (:func:`solve_tri`: in f32 for bf16/f16, which
PyTorch's solve does not take).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Union

import torch

from ..core.matrix import BaseMatrix, TriangularMatrix, operand_device
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
