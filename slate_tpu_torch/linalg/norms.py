"""Norm drivers and condition estimators.

Counterpart of ``slate_tpu/linalg/norms.py``: ``norm`` over every matrix
kind (with NormScope Matrix / Rows / Columns), ``col_norms``, the
Higham-Tisseur 1-norm estimator (LAPACK xLACN2) and the reciprocal
condition estimates from LU, Cholesky and triangular factors.  The band
and Hermitian band kinds are carried as data (dense storage with their
(kl, ku)); their norms are the band-projected dense reductions, as in
``slate_tpu``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core.matrix import (
    BandMatrix,
    BaseMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    SymmetricMatrix,
    TrapezoidMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
    operand_device,
)
from ..ops import tile_ops
from ..types import Norm, NormScope, Op, Side, Uplo

ArrayLike = Union[torch.Tensor, BaseMatrix]


def _dense(a: ArrayLike, device=None) -> torch.Tensor:
    return torch.as_tensor(a.array if isinstance(a, BaseMatrix) else a,
                           device=operand_device(a, device))


def norm(norm_type: Norm, a: ArrayLike, scope: NormScope = NormScope.Matrix,
         device=None) -> torch.Tensor:
    """slate::norm (src/norm.cc), dispatched on the matrix kind; a plain
    tensor (or array) is a general matrix, on ``operand_device(a,
    device)``."""
    if isinstance(a, HermitianBandMatrix):
        return tile_ops.hbnorm(norm_type, a.data, a.uplo, a.kd)
    if isinstance(a, TriangularBandMatrix):
        # the band is already projected in storage: the triangle's norm
        return tile_ops.trnorm(norm_type, a.data, a.uplo, a.diag)
    if isinstance(a, BandMatrix):
        return tile_ops.gbnorm(norm_type, a.data, a.kl, a.ku)
    if isinstance(a, (HermitianMatrix, SymmetricMatrix)):
        return tile_ops.henorm(norm_type, a.data, a.uplo)
    if isinstance(a, (TriangularMatrix, TrapezoidMatrix)):
        return tile_ops.trnorm(norm_type, a.data, a.uplo, a.diag)
    return tile_ops.genorm(norm_type, _dense(a, device), scope)


def col_norms(a: ArrayLike, device=None) -> torch.Tensor:
    """slate::colNorms (src/colNorms.cc): per-column max |a|."""
    return tile_ops.col_norms(_dense(a, device))


# ---------------------------------------------------------------------------
# Higham-Tisseur 1-norm estimator (LAPACK xLACN2)
# ---------------------------------------------------------------------------


def norm1est(
    solve: Callable[[torch.Tensor], torch.Tensor],
    solve_h: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    dtype: torch.dtype = torch.float64,
    iters: int = 5,
    device=None,
) -> torch.Tensor:
    """Estimate ||M||_1 from products y = M x (``solve``) and z = M^H x
    (``solve_h``), M = A^-1 for a condition number: the xLACN2 power
    iteration on the 1-norm dual, the fixed itmax (5) with no early exit,
    then the alternating-sign probe.  The probe vectors live on ``device``
    (the card unless named).  Returns a 0-d f64 tensor."""
    dev = operand_device(None, device)
    cplx = dtype.is_complex

    def sign_of(y):
        if cplx:  # y / |y|, and 1 where y == 0 (torch.sgn gives 0 there)
            ay = y.abs()
            one = torch.ones((), dtype=dtype, device=dev)
            return torch.where(ay == 0, one, y / torch.where(ay == 0, 1, ay)).to(dtype)
        return torch.where(y >= 0, 1.0, -1.0).to(dtype)

    x = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    est = torch.zeros((), dtype=torch.float64, device=dev)
    for _ in range(iters):
        y = solve(x)
        est = torch.maximum(est, y.abs().sum().to(torch.float64))
        z = solve_h(sign_of(y))
        j = torch.argmax(z.abs())
        x = torch.zeros((n,), dtype=dtype, device=dev)
        x[j.view(1)] = 1.0
    # the alternating-sign safeguard vector (xLACN2's final stage)
    k = torch.arange(n, dtype=torch.float64, device=dev)
    v = (1.0 - 2.0 * (k % 2)).to(dtype) * (1.0 + k / max(n - 1, 1)).to(dtype)
    alt = 2.0 * solve(v).abs().sum().to(torch.float64) / (3.0 * n)
    return torch.maximum(est, alt)


def _recondest(anorm: torch.Tensor, ainv_norm: torch.Tensor) -> torch.Tensor:
    """1 / (||A|| ||A^-1||), and 0 where that product is not positive."""
    denom = anorm * ainv_norm
    return torch.where(denom > 0, 1.0 / denom, torch.zeros_like(denom))


def _f64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.float64)


def gecondest(norm_type: Norm, lu_factors, anorm) -> torch.Tensor:
    """slate::gecondest: the reciprocal condition estimate from LU factors.
    The Inf norm runs the estimator on A^-H (||A^-1||_inf = ||A^-H||_1)."""
    from .lu import getrs_array

    lu = lu_factors.lu
    n = lu.shape[0]

    def fwd(x):
        return getrs_array(lu_factors, x[:, None])[:, 0]

    def adj(x):
        return getrs_array(lu_factors, x[:, None], Op.ConjTrans)[:, 0]

    if norm_type == Norm.One:
        ainv = norm1est(fwd, adj, n, lu.dtype, device=lu.device)
    elif norm_type == Norm.Inf:
        ainv = norm1est(adj, fwd, n, lu.dtype, device=lu.device)
    else:
        raise ValueError("gecondest: only the One and Inf norms (gecondest.cc)")
    return _recondest(_f64(anorm, lu.device), ainv)


def pocondest(norm_type: Norm, factor, anorm) -> torch.Tensor:
    """slate::pocondest: the SPD reciprocal condition estimate from the
    Cholesky factor (A^-1 is Hermitian: its 1- and Inf-norms agree)."""
    from .chol import potrs_array

    f = factor.data if isinstance(factor, BaseMatrix) else factor
    uplo = factor.uplo if isinstance(factor, BaseMatrix) else Uplo.Lower

    def solve(x):
        return potrs_array(f, x[:, None], uplo)[:, 0]

    ainv = norm1est(solve, solve, f.shape[0], f.dtype, device=f.device)
    return _recondest(_f64(anorm, f.device), ainv)


def trcondest(norm_type: Norm, a: ArrayLike, anorm: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """slate::trcondest: the triangular reciprocal condition estimate; a
    plain tensor is read as a lower triangle."""
    from ..blas3.blas3 import trsm_array

    am = a if isinstance(a, BaseMatrix) else TriangularMatrix.from_array(a, Uplo.Lower)
    t = am.data
    if anorm is None:
        anorm = tile_ops.trnorm(norm_type if norm_type in (Norm.One, Norm.Inf) else Norm.One,
                                t, am.uplo, am.diag)

    def fwd(x):
        return trsm_array(Side.Left, am.uplo, Op.NoTrans, am.diag, 1.0, t, x[:, None])[:, 0]

    def adj(x):
        return trsm_array(Side.Left, am.uplo, Op.ConjTrans, am.diag, 1.0, t, x[:, None])[:, 0]

    if norm_type == Norm.Inf:
        ainv = norm1est(adj, fwd, t.shape[0], t.dtype, device=t.device)
    else:
        ainv = norm1est(fwd, adj, t.shape[0], t.dtype, device=t.device)
    return _recondest(_f64(anorm, t.device), ainv)
