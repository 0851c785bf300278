"""Matrix views over torch tensors.

Counterpart of ``slate_tpu/core/matrix.py``: thin immutable wrappers around
one 2-D tensor carrying the mathematical metadata (logical transposition
``op``, triangle ``uplo``, unit-diagonal flag ``diag``), plus the triangle
helpers the factorizations share.  The matrix kinds are the ones the
Cholesky drivers take and return and the ones ``linalg.norms.norm``
dispatches on (the band kinds are carried as data with their (kl, ku):
the band algorithms come with their slice); the views' transpose/slice
helpers come with the slices that use them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from ..types import Diag, Op, SlateError, Uplo

# where a driver computes when neither the caller nor its operand says
DEFAULT_DEVICE = "cuda"


@dataclass(frozen=True)
class BaseMatrix:
    """View over a 2-D tensor with logical-transpose semantics; ``data`` is
    stored un-transposed and ``array`` applies ``op``."""

    data: torch.Tensor
    op: Op = Op.NoTrans
    uplo: Uplo = Uplo.General
    diag: Diag = Diag.NonUnit
    kl: Optional[int] = None  # band: sub-diagonals (None = dense)
    ku: Optional[int] = None  # band: super-diagonals

    @property
    def m(self) -> int:
        return self.data.shape[1] if self.op != Op.NoTrans else self.data.shape[0]

    @property
    def n(self) -> int:
        return self.data.shape[0] if self.op != Op.NoTrans else self.data.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def array(self) -> torch.Tensor:
        """The view with op applied (logical (m, n) tensor)."""
        if self.op == Op.NoTrans:
            return self.data
        if self.op == Op.Trans:
            return self.data.T
        return self.data.conj().T

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}({self.m}x{self.n}, dtype={self.dtype}, "
            f"op={self.op.name}, uplo={self.uplo.name})"
        )


@dataclass(frozen=True)
class Matrix(BaseMatrix):
    """General rectangular matrix."""

    @staticmethod
    def from_array(a: torch.Tensor) -> "Matrix":
        return Matrix(data=a)


@dataclass(frozen=True)
class TrapezoidMatrix(BaseMatrix):
    """Upper/lower trapezoid storage semantics."""

    @staticmethod
    def from_array(a: torch.Tensor, uplo: Uplo, diag: Diag = Diag.NonUnit) -> "TrapezoidMatrix":
        return TrapezoidMatrix(data=a, uplo=uplo, diag=diag)


@dataclass(frozen=True)
class TriangularMatrix(BaseMatrix):
    """Square triangular."""

    @staticmethod
    def from_array(a: torch.Tensor, uplo: Uplo, diag: Diag = Diag.NonUnit) -> "TriangularMatrix":
        if a.shape[0] != a.shape[1]:
            raise SlateError("TriangularMatrix must be square")
        return TriangularMatrix(data=a, uplo=uplo, diag=diag)


@dataclass(frozen=True)
class HermitianMatrix(BaseMatrix):
    """A == A^H, one triangle stored."""

    @staticmethod
    def from_array(a: torch.Tensor, uplo: Uplo) -> "HermitianMatrix":
        return HermitianMatrix(data=a, uplo=uplo)

    @property
    def full(self) -> torch.Tensor:
        return symmetrize(self.data, self.uplo, conj=True)


@dataclass(frozen=True)
class SymmetricMatrix(BaseMatrix):
    """A == A^T, one triangle stored."""

    @staticmethod
    def from_array(a: torch.Tensor, uplo: Uplo) -> "SymmetricMatrix":
        return SymmetricMatrix(data=a, uplo=uplo)

    @property
    def full(self) -> torch.Tensor:
        return symmetrize(self.data, self.uplo, conj=False)


@dataclass(frozen=True)
class BandMatrix(BaseMatrix):
    """General band, kl sub- and ku super-diagonals, stored dense with
    zeros outside the band."""

    @staticmethod
    def from_array(a: torch.Tensor, kl: int, ku: int) -> "BandMatrix":
        return BandMatrix(data=band_project(a, kl, ku), kl=kl, ku=ku)


@dataclass(frozen=True)
class TriangularBandMatrix(BaseMatrix):
    """Triangular band."""

    @staticmethod
    def from_array(a: torch.Tensor, uplo: Uplo, kd: int,
                   diag: Diag = Diag.NonUnit) -> "TriangularBandMatrix":
        kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
        return TriangularBandMatrix(data=band_project(a, kl, ku), uplo=uplo, diag=diag,
                                    kl=kl, ku=ku)


@dataclass(frozen=True)
class HermitianBandMatrix(BaseMatrix):
    """Hermitian band, one triangle significant."""

    @staticmethod
    def from_array(a: torch.Tensor, uplo: Uplo, kd: int) -> "HermitianBandMatrix":
        kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
        return HermitianBandMatrix(data=band_project(a, kl, ku), uplo=uplo, kl=kl, ku=ku)

    @property
    def kd(self) -> int:
        return self.kl if self.uplo == Uplo.Lower else self.ku

    @property
    def full(self) -> torch.Tensor:
        return symmetrize(self.data, self.uplo, conj=True)


def operand_device(x, device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Where a driver computes: ``device`` if the caller names one, else the
    device of ``x`` (a tensor or a view over one), else the card.  A numpy
    array or a list therefore lands on the card, as ``jnp.asarray`` lands on
    the default device; CPU tensors or ``device="cpu"`` ask for the host."""
    if device is not None:
        return torch.device(device)
    data = x.data if isinstance(x, BaseMatrix) else x
    if isinstance(data, torch.Tensor):
        return data.device
    return torch.device(DEFAULT_DEVICE)


def tri_project(a: torch.Tensor, uplo: Uplo, diag: Diag = Diag.NonUnit) -> torch.Tensor:
    """Zero out the unreferenced triangle (a select: NaN there is dropped
    too); force a unit diagonal if requested."""
    out = a.tril() if uplo == Uplo.Lower else a.triu()
    if diag == Diag.Unit:
        out.diagonal().fill_(1)
    return out


def symmetrize(a: torch.Tensor, uplo: Uplo, conj: bool) -> torch.Tensor:
    """Reconstruct the full matrix from one stored triangle (a fresh
    tensor; the other triangle of ``a`` is never read)."""
    lower = uplo == Uplo.Lower
    full = a.tril() if lower else a.triu()
    other = full.conj().T if conj else full.T
    full.add_(other.triu(1) if lower else other.tril(-1))
    if conj and full.is_complex():  # force a real diagonal like LAPACK does
        d = full.diagonal()
        d.copy_(d.real.to(full.dtype))
    return full


def band_project(a: torch.Tensor, kl: int, ku: int) -> torch.Tensor:
    """Zero outside the band [-kl, +ku] (a select: NaN there is dropped)."""
    m, n = a.shape
    i = torch.arange(m, device=a.device)[:, None]
    j = torch.arange(n, device=a.device)[None, :]
    return torch.where((j - i <= ku) & (i - j <= kl), a, a.new_zeros(()))
