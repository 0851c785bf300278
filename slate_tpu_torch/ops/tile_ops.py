"""Elementwise, norm and transpose tile operations of the port.

Counterpart of ``slate_tpu/ops/tile_ops.py``, function for function: each
works on whole tensors or ``(..., mb, nb)`` tile stacks, with
``slate_tpu``'s semantics (masks from the shapes, the same scaled
Frobenius sum).  The one that takes a hand-written kernel is
:func:`transpose`: a big f32/bf16 tile stack on the card
(``ops.kernels.use_cuda_tiles``) goes through ``kernels.transpose_tiles``,
as ``slate_tpu``'s goes through ``transpose_pallas`` on a TPU.  ``geadd``
and ``genorm`` stay plain forms here as there (their kernels,
``kernels.geadd_tiles`` and ``kernels.genorm_max_tiles``, have no consumer
in either package).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.matrix import band_project, operand_device, tri_project
from ..types import Diag, Norm, NormScope, Uplo
from . import kernels


def _uplo_mask(a: torch.Tensor, uplo: Uplo) -> torch.Tensor:
    """The uplo trapezoid of the trailing (m, n) dims (diagonal included)."""
    m, n = a.shape[-2:]
    i = torch.arange(m, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    return (i >= j) if uplo == Uplo.Lower else (i <= j)


# ---------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------


def geadd(alpha, a: torch.Tensor, beta, b: torch.Tensor) -> torch.Tensor:
    """alpha A + beta B."""
    return alpha * a + beta * b


def tzadd(uplo: Uplo, alpha, a: torch.Tensor, beta, b: torch.Tensor) -> torch.Tensor:
    """Trapezoid add: only the uplo triangle is updated."""
    return torch.where(_uplo_mask(a, uplo), alpha * a + beta * b, b)


def gecopy(a: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Copy, with an optional precision conversion."""
    return a.to(dtype) if dtype is not None else a.clone()


def tzcopy(uplo: Uplo, a: torch.Tensor, b: torch.Tensor,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The uplo triangle of A over B."""
    if dtype is not None:
        a = a.to(dtype)
    return torch.where(_uplo_mask(a, uplo), a, b)


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def gescale(numer, denom, a: torch.Tensor) -> torch.Tensor:
    """A := (numer / denom) A, the ratio formed in A's dtype (the
    reference's overflow-safe two-scalar form)."""
    return a * (_scalar(numer, a) / _scalar(denom, a))


def tzscale(uplo: Uplo, numer, denom, a: torch.Tensor) -> torch.Tensor:
    return torch.where(_uplo_mask(a, uplo), gescale(numer, denom, a), a)


def gescale_row_col(r: torch.Tensor, c: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """A := diag(r) A diag(c) (row/column equilibration)."""
    return a * r[:, None].to(a.dtype) * c[None, :].to(a.dtype)


def geset(offdiag, diag, shape: Tuple[int, int], dtype: torch.dtype = torch.float32,
          device=None) -> torch.Tensor:
    """A new (m, n) tensor: offdiag everywhere, diag on the diagonal, on
    ``device`` (the card unless named)."""
    dev = operand_device(None, device)
    m, n = shape
    i = torch.arange(m, device=dev)[:, None]
    j = torch.arange(n, device=dev)[None, :]
    return torch.where(i == j, torch.as_tensor(diag, dtype=dtype, device=dev),
                       torch.as_tensor(offdiag, dtype=dtype, device=dev))


def tzset(uplo: Uplo, offdiag, diag, a: torch.Tensor) -> torch.Tensor:
    """Set the uplo triangle to offdiag / diag, leave the rest."""
    m, n = a.shape[-2:]
    i = torch.arange(m, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    vals = torch.where(i == j, _scalar(diag, a), _scalar(offdiag, a))
    return torch.where(_uplo_mask(a, uplo), vals, a)


def transpose(a: torch.Tensor, conj: bool = False) -> torch.Tensor:
    """Tile transpose of the trailing two dims.  A big f32/bf16 tile stack
    on the card (``kernels.use_cuda_tiles``) goes through the
    ``transpose_tiles`` kernel, one launch, as a new contiguous stack;
    anything else is the swapped view (conjugated into a new tensor when
    ``conj``)."""
    if not conj and kernels.use_cuda_tiles(a):
        return kernels.transpose_tiles(a.contiguous())
    at = a.transpose(-1, -2)
    return torch.conj_physical(at) if conj else at


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _fro(aa: torch.Tensor) -> torch.Tensor:
    """Scaled sum of squares (LAPACK lassq's overflow guard)."""
    scale = aa.max()
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    return scale * torch.sqrt(((aa / scale) ** 2).sum())


def genorm(norm: Norm, a: torch.Tensor, scope: NormScope = NormScope.Matrix) -> torch.Tensor:
    """General-matrix norm: Max / One / Inf / Fro of the matrix, or Max /
    sum of |a| per column or row."""
    aa = a.abs()
    if scope in (NormScope.Columns, NormScope.Rows):
        dim = 0 if scope == NormScope.Columns else 1
        return aa.amax(dim=dim) if norm == Norm.Max else aa.sum(dim=dim)
    if norm == Norm.Max:
        return aa.max()
    if norm == Norm.One:
        return aa.sum(dim=0).max()
    if norm == Norm.Inf:
        return aa.sum(dim=1).max()
    if norm == Norm.Fro:
        return _fro(aa)
    raise ValueError(norm)


def _herm_full_abs(a: torch.Tensor, uplo: Uplo) -> torch.Tensor:
    """|A| of the Hermitian matrix whose uplo triangle ``a`` holds."""
    keep = _uplo_mask(a, uplo)
    t = torch.where(keep, a, a.new_zeros(())).abs()
    strict = keep & ~torch.eye(a.shape[0], dtype=torch.bool, device=a.device)
    return t + torch.where(strict.T, t.T, t.new_zeros(()))


def henorm(norm: Norm, a: torch.Tensor, uplo: Uplo) -> torch.Tensor:
    """Hermitian norm from one stored triangle."""
    aa = _herm_full_abs(a, uplo)
    if norm == Norm.Max:
        return aa.max()
    if norm in (Norm.One, Norm.Inf):  # symmetric: row sums == column sums
        return aa.sum(dim=0).max()
    if norm == Norm.Fro:
        return _fro(aa)
    raise ValueError(norm)


synorm = henorm  # the same absolute-value structure


def trnorm(norm: Norm, a: torch.Tensor, uplo: Uplo, diag: Diag = Diag.NonUnit) -> torch.Tensor:
    """Trapezoid / triangular norm."""
    return genorm(norm, tri_project(a, uplo, diag))


def gbnorm(norm: Norm, a: torch.Tensor, kl: int, ku: int) -> torch.Tensor:
    """Band norm: zero outside the band, then reduce."""
    return genorm(norm, band_project(a, kl, ku))


def hbnorm(norm: Norm, a: torch.Tensor, uplo: Uplo, kd: int) -> torch.Tensor:
    kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
    return henorm(norm, band_project(a, kl, ku), uplo)


def col_norms(a: torch.Tensor) -> torch.Tensor:
    """Per-column max |a| (NormScope.Columns)."""
    return a.abs().amax(dim=0)
