"""Triangular inverse (trtri) and triangle-triangle multiply (trtrm).

Counterpart of ``slate_tpu/linalg/tri.py``: the recursive blocked inverse
(split at a power-of-two multiple of ``_NB``, ``torch.linalg`` triangular
solves against the identity at the leaves, two gemms for the off-diagonal
block), written into one preallocated result where ``slate_tpu`` assembles
``jnp.block``s, and the lauum-style T^H T / T T^H.
"""

from __future__ import annotations

import torch

from ..blas3.blas3 import _NB, _split, solve_tri
from ..core.matrix import tri_project
from ..ops.matmul import matmul
from ..types import Diag, Uplo


def _trtri_lower(a: torch.Tensor, diag: Diag) -> torch.Tensor:
    """inv([[A11, 0], [A21, A22]]) = [[A11^-1, 0], [-A22^-1 A21 A11^-1, A22^-1]]."""
    n = a.shape[0]
    if n <= _NB:
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        return solve_tri(a, eye, upper=False, unitriangular=diag == Diag.Unit)
    h = _split(n)
    out = torch.zeros_like(a)
    out[:h, :h] = i11 = _trtri_lower(a[:h, :h], diag)
    out[h:, h:] = i22 = _trtri_lower(a[h:, h:], diag)
    out[h:, :h] = -matmul(matmul(i22, a[h:, :h]), i11).to(a.dtype)
    return out


def trtri_array(a: torch.Tensor, uplo: Uplo = Uplo.Lower, diag: Diag = Diag.NonUnit
                ) -> torch.Tensor:
    """slate::trtri (src/trtri.cc): the inverse of the uplo triangle."""
    if uplo == Uplo.Upper:
        return _trtri_lower(a.T, diag).T
    return _trtri_lower(a, diag)


def trtrm_array(t: torch.Tensor, uplo: Uplo = Uplo.Lower) -> torch.Tensor:
    """slate::trtrm (src/trtrm.cc): T^H T (lower) or T T^H (upper) of the
    uplo triangle T, the lauum step of potri; returns the uplo triangle of
    the Hermitian product."""
    tt = tri_project(t, uplo)
    th = tt.conj().T
    prod = matmul(th, tt) if uplo == Uplo.Lower else matmul(tt, th)
    return tri_project(prod.to(t.dtype), uplo)
