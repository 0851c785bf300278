"""Simplified verb-named API of the port (multiply, the BLAS-3 verbs, the
LU, Cholesky, QR, eigen and SVD verbs).

Counterpart of ``multiply``, ``hermitian_multiply`` /
``symmetric_multiply`` / ``triangular_multiply`` / ``triangular_solve`` /
``rank_k_update`` / ``rank_2k_update``, ``lu_factor`` / ``lu_solve`` /
``lu_solve_using_factor`` / ``lu_inverse``, ``chol_factor`` /
``chol_solve`` / ``chol_solve_using_factor`` / ``chol_inverse``,
``indefinite_factor`` / ``indefinite_solve`` and
``least_squares_solve`` / ``qr_factor`` /
``qr_multiply_by_q`` / ``lq_factor`` / ``lq_multiply_by_q`` and
``eig_vals`` / ``eig_decompose`` / ``generalized_eig`` / ``svd_vals`` /
``svd_decompose`` and the serving verbs ``chol_solve_batched`` /
``lu_solve_batched`` / ``multiply_batched`` / ``serve_router`` in
``slate_tpu/api.py``; the other verbs come with their slices.  Each verb
computes on ``operand_device(first operand, device)``: tensors where they
lie, anything else on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .blas3 import blas3
from .core.matrix import BaseMatrix, operand_device
from .linalg import chol, eig, indefinite, lu, qr
from .linalg import svd as svd_mod
from .types import MethodLU, Op, Option, Options, Side, Uplo, get_option

ArrayLike = Union[torch.Tensor, BaseMatrix]


def multiply(alpha, a: ArrayLike, b: ArrayLike, beta=0.0, c: Optional[ArrayLike] = None,
             opts: Optional[Options] = None, device=None):
    """C = alpha A B + beta C (slate::multiply -> gemm), on
    ``operand_device(a, device)``.  Option.Precision in ``opts`` selects
    the accumulation tier.  Option.FaultTolerance (an ABFT policy) routes
    this single-array form through ``ft.abft.gemm_checked``: the product
    and its row/column checksums are computed by independent products and
    compared, with single-tile damage repaired under ``correct``, on tiles
    of Option.BlockSize (default 32 here)."""
    from .ft.policy import FtPolicy, resolve_policy

    dev = operand_device(a, device)
    policy = resolve_policy(opts)
    if policy != FtPolicy.Off:
        from .ft.abft import gemm_checked

        nb = int(get_option(opts, Option.BlockSize, default=32))
        return gemm_checked(alpha, blas3._arr(a, dev), blas3._arr(b, dev), beta,
                            None if c is None else blas3._arr(c, dev), nb=nb, policy=policy)
    if c is None:
        am, bm = blas3._arr(a, dev), blas3._arr(b, dev)
        c = torch.zeros((am.shape[0], bm.shape[1]), dtype=am.dtype, device=dev)
    return blas3.gemm(alpha, a, b, beta, c, opts=opts, device=dev)


def hermitian_multiply(side: Side, alpha, a: ArrayLike, b: ArrayLike, beta=0.0, c=None,
                       opts: Optional[Options] = None, device=None):
    """C = alpha A B + beta C (Left) or alpha B A + beta C (Right), A
    Hermitian (slate::multiply -> hemm)."""
    dev = operand_device(a, device)
    if c is None:
        c = torch.zeros_like(blas3._arr(b, dev))
    return blas3.hemm(side, alpha, a, b, beta, c, opts=opts, device=dev)


def symmetric_multiply(side: Side, alpha, a: ArrayLike, b: ArrayLike, beta=0.0, c=None,
                       opts: Optional[Options] = None, device=None):
    """As hermitian_multiply with A symmetric (symm)."""
    dev = operand_device(a, device)
    if c is None:
        c = torch.zeros_like(blas3._arr(b, dev))
    return blas3.symm(side, alpha, a, b, beta, c, opts=opts, device=dev)


def triangular_multiply(side: Side, alpha, a: ArrayLike, b: ArrayLike,
                        opts: Optional[Options] = None, device=None):
    """B = alpha op(A) B or alpha B op(A), A triangular (trmm)."""
    return blas3.trmm(side, alpha, a, b, opts=opts, device=device)


def triangular_solve(side: Side, alpha, a: ArrayLike, b: ArrayLike,
                     opts: Optional[Options] = None, device=None):
    """Solve op(A) X = alpha B or X op(A) = alpha B, A triangular
    (slate::triangular_solve -> trsm); ``opts`` rides through."""
    return blas3.trsm(side, alpha, a, b, opts=opts, device=device)


def rank_k_update(alpha, a: ArrayLike, beta, c: ArrayLike, uplo: Optional[Uplo] = None,
                  opts: Optional[Options] = None, device=None):
    """C = alpha A A^H + beta C on C's ``uplo`` triangle (herk)."""
    return blas3.herk(alpha, a, beta, c, uplo, opts=opts, device=device)


def rank_2k_update(alpha, a: ArrayLike, b: ArrayLike, beta, c: ArrayLike, uplo=None,
                   opts: Optional[Options] = None, device=None):
    """C = alpha A B^H + conj(alpha) B A^H + beta C on C's ``uplo``
    triangle (her2k)."""
    return blas3.her2k(alpha, a, b, beta, c, uplo, opts=opts, device=device)


def _data(a: ArrayLike, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a.data if isinstance(a, BaseMatrix) else a, device=device)


# -- LU (lu_factor / lu_solve / lu_solve_using_factor / lu_inverse) ----------


def lu_factor(a: ArrayLike, method: MethodLU = MethodLU.PartialPiv, device=None):
    """LUFactors of A by ``method`` (PartialPiv, CALU or NoPiv)."""
    ad = blas3._arr(a, operand_device(a, device))
    if method == MethodLU.CALU:
        return lu.getrf_tntpiv_array(ad)
    if method == MethodLU.NoPiv:
        return lu.getrf_nopiv_array(ad)
    return lu.getrf_array(ad)


def lu_solve(a: ArrayLike, b: ArrayLike, method: MethodLU = MethodLU.PartialPiv, device=None):
    """X of A X = B."""
    dev = operand_device(a, device)
    x, _ = lu.gesv_array(blas3._arr(a, dev), blas3._arr(b, dev), method)
    return x


def lu_solve_using_factor(f, b: ArrayLike, op: Op = Op.NoTrans, device=None):
    """X of op(A) X = B from LUFactors (on the factors' device unless
    ``device`` says otherwise)."""
    return lu.getrs_array(f, blas3._arr(b, operand_device(f.lu, device)), op)


def lu_inverse(a: ArrayLike, device=None):
    """A^-1 through getrf and getri."""
    return lu.getri_array(lu.getrf_array(blas3._arr(a, operand_device(a, device))))


# -- Cholesky ------------------------------------------------------------------


def chol_factor(a: ArrayLike, device=None):
    """(factor, info) of an SPD matrix or HermitianMatrix view."""
    uplo = a.uplo if isinstance(a, BaseMatrix) else Uplo.Lower
    return chol.potrf_array(_data(a, operand_device(a, device)), uplo)


def chol_solve(a: ArrayLike, b: ArrayLike, device=None):
    """(x, info) of A X = B, A SPD."""
    dev = operand_device(a, device)
    x, _, info = chol.posv_array(
        _data(a, dev),
        blas3._arr(b, dev),
        a.uplo if isinstance(a, BaseMatrix) else Uplo.Lower,
    )
    return x, info


def chol_solve_using_factor(l: ArrayLike, b: ArrayLike, uplo: Uplo = Uplo.Lower, device=None):
    dev = operand_device(l, device)
    return chol.potrs_array(_data(l, dev), blas3._arr(b, dev), uplo)


def chol_inverse(l: ArrayLike, uplo: Uplo = Uplo.Lower, device=None):
    """A^-1's ``uplo`` triangle from the Cholesky factor (potri)."""
    return chol.potri_array(_data(l, operand_device(l, device)), uplo)


# -- indefinite (indefinite_factor / indefinite_solve) -----------------------


def indefinite_factor(a: ArrayLike, nb: int = 32, device=None):
    """(HetrfFactors, info) of a Hermitian indefinite matrix (hetrf)."""
    return indefinite.hetrf_array(blas3._arr(a, operand_device(a, device)), nb)


def indefinite_solve(a: ArrayLike, b: ArrayLike, nb: int = 32, device=None):
    """(x, info) of A X = B, A Hermitian indefinite (hesv)."""
    dev = operand_device(a, device)
    x, _, info = indefinite.hesv_array(blas3._arr(a, dev), blas3._arr(b, dev), nb)
    return x, info


# -- least squares / QR / LQ -------------------------------------------------


def least_squares_solve(a: ArrayLike, b: ArrayLike, device=None):
    """slate::least_squares_solve -> gels."""
    dev = operand_device(a, device)
    return qr.gels_array(blas3._arr(a, dev), blas3._arr(b, dev))


def qr_factor(a: ArrayLike, device=None):
    return qr.geqrf_array(blas3._arr(a, operand_device(a, device)))


def qr_multiply_by_q(f, c: ArrayLike, side: Side = Side.Left, op: Op = Op.NoTrans, device=None):
    return qr.unmqr_array(side, op, f, blas3._arr(c, operand_device(f.vr, device)))


def lq_factor(a: ArrayLike, device=None):
    return qr.gelqf_array(blas3._arr(a, operand_device(a, device)))


def lq_multiply_by_q(f, c: ArrayLike, side: Side = Side.Left, op: Op = Op.NoTrans, device=None):
    return qr.unmlq_array(side, op, f, blas3._arr(c, operand_device(f.lv, device)))


# -- eig / svd ---------------------------------------------------------------


def eig_vals(a: ArrayLike, device=None):
    """slate::eig_vals (Hermitian): the eigenvalues, ascending."""
    return eig.heev_array(blas3._arr(a, operand_device(a, device)), want_vectors=False)


def eig_decompose(a: ArrayLike, device=None):
    """(w ascending, Z) of a Hermitian matrix."""
    return eig.heev_array(blas3._arr(a, operand_device(a, device)), want_vectors=True)


def generalized_eig(a: ArrayLike, b: ArrayLike, device=None):
    """(w, X, info) of A x = lambda B x, B Hermitian positive definite."""
    dev = operand_device(a, device)
    return eig.hegv_array(blas3._arr(a, dev), blas3._arr(b, dev))


def svd_vals(a: ArrayLike, device=None):
    """The singular values, descending."""
    return svd_mod.svd_array(blas3._arr(a, operand_device(a, device)), want_vectors=False)


def svd_decompose(a: ArrayLike, device=None):
    """(U, s, Vh), thin."""
    return svd_mod.svd_array(blas3._arr(a, operand_device(a, device)), want_vectors=True)


# -- serving (slate_tpu_torch.serve): batched small-problem verbs ------------
# Stacks of same-shaped small problems, each row bitwise its single verb
# above; ``serve_router`` builds the full request path (admission on the
# memory model, condest-keyed accuracy classes, the executable cache and the
# tuned schedule table).


def chol_solve_batched(a, b, device=None):
    """Stacked chol_solve: (B, n, n) x (B, n, k) -> (x, info) stacks."""
    from .serve.batch import posv_batched

    dev = operand_device(a, device)
    return posv_batched(blas3._arr(a, dev), blas3._arr(b, dev))


def lu_solve_batched(a, b, method: MethodLU = MethodLU.PartialPiv, device=None):
    """Stacked lu_solve: (B, n, n) x (B, n, k) -> (x, info) stacks."""
    from .serve.batch import gesv_batched

    dev = operand_device(a, device)
    return gesv_batched(blas3._arr(a, dev), blas3._arr(b, dev), method)


def multiply_batched(alpha, a, b, beta=0.0, c=None, device=None):
    """Stacked multiply over (B, m, k) x (B, k, n) operand stacks."""
    from .serve.batch import gemm_batched

    dev = operand_device(a, device)
    return gemm_batched(alpha, blas3._arr(a, dev), blas3._arr(b, dev), beta,
                        None if c is None else blas3._arr(c, dev))


def serve_router(**kwargs):
    """A ``serve.Router`` over this API's drivers (``serve/router.py``); its
    keywords are the Router's (``mesh``, ``nb``, ``bins``, ``hbm_budget``,
    ``cache``, ``opts``, ``device``)."""
    from .serve.router import Router

    return Router(**kwargs)
