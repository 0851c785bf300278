"""The matmul dispatch behind every BLAS-3 routine of the port.

Counterpart of ``slate_tpu/ops/matmul.py:matmul``.  The precision tiers map
onto the card as follows:

- ``Highest`` / ``Emulated``: full f32 or f64, never TF32.  PyTorch's
  default already has ``torch.backends.cuda.matmul.allow_tf32 = False``; if
  a caller turned it on globally, an f32 product on the card switches it
  off for the call.
- ``High``: TF32 tensor cores for f32 operands (about 10 mantissa bits);
  f64 is unchanged.
- ``Fast``: f32 operands rounded to bf16, products summed in f32.  On the
  card a 2-D product is one bf16 cuBLAS GEMM with an f32 result
  (``torch.mm(..., out_dtype=torch.float32)``); elsewhere the bf16-rounded
  operands are multiplied in f32, which gives the same numbers up to the
  order of summation (a product of two bf16 values is exact in f32).

The TF32 flag is process-global: it is written only when an f32 product on
the card needs another setting than the current one, and restored after.

Large plain products stay ``torch.matmul`` (cuBLAS), as the JAX package
leaves them to XLA.  The rest of ``slate_tpu``'s dispatch is here with its
names, so a test can force each branch by monkeypatching as
``tests/test_ozaki.py`` does for ``slate_tpu``:

- the Ozaki branch: f64 and c128 products with at least ``_OZAKI_MIN_ELEMS``
  multiplies and every dim >= ``_OZAKI_MIN_DIM`` go to ``ops/ozaki.py``
  (9 slices, 6 at the Fast tier) when ``_tpu_is_default()`` and
  ``_F64_DISPATCH["ozaki"]`` allow it and the tier is not ``Emulated``.
  ``_tpu_is_default()`` answers False: the card is not a TPU, so f64 and
  c128 products go to cuBLAS, as ``slate_tpu`` routes them off a TPU
  (PERF.md times both forms on the card).
  ``f64_emulation()`` is the global opt-out.  The gate reads 2-D operands
  only (a batched product never takes the branch);
- :func:`matmul_pallas`, the blocked GEMM with an f32 accumulator (the
  port of ``slate_tpu/ops/matmul.py:73``'s Pallas kernel, on
  ``csrc/matmul.cu``).  ``_use_pallas`` stays False, as in ``slate_tpu``:
  the default dispatch never takes it.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..types import Precision

# Ozaki dispatch thresholds (slate_tpu's measured win region on its TPU)
_OZAKI_MIN_ELEMS = 2048**3
_OZAKI_MIN_DIM = 1024

# the global opt-out of the Ozaki f64 path (see f64_emulation)
_F64_DISPATCH = {"ozaki": True}


@contextlib.contextmanager
def f64_emulation():
    """f64/c128 products inside never take the Ozaki branch; per call,
    ``precision=Precision.Emulated`` does the same."""
    old = _F64_DISPATCH["ozaki"]
    _F64_DISPATCH["ozaki"] = False
    try:
        yield
    finally:
        _F64_DISPATCH["ozaki"] = old


def _ceil_mult(x: int, base: int = 128) -> int:
    return max(base, ((x + base - 1) // base) * base)


def _tpu_is_default() -> bool:
    """Whether dispatch targets a TPU: never in the port (module doc)."""
    return False


def _use_pallas(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the default dispatch routes through :func:`matmul_pallas`:
    never, as in ``slate_tpu`` (its kernel lost to XLA at the
    factorizations' thin-k shapes on the TPU; PERF.md times it against
    cuBLAS on the card).  The kernel stays callable as
    ``ops.matmul_pallas``."""
    return False


def pallas_blocks(m: int, k: int, n: int, bm: int = 512, bn: int = 512,
                  bk: int = 512) -> tuple:
    """``slate_tpu``'s block clamp: each block at most its dim rounded up to
    a multiple of 128.  Returns (bm, bn, bk)."""
    return min(bm, _ceil_mult(m)), min(bn, _ceil_mult(n)), min(bk, _ceil_mult(k))


def matmul_pallas(a: torch.Tensor, b: torch.Tensor, bm: int = 512, bn: int = 512,
                  bk: int = 512) -> torch.Tensor:
    """C = A @ B with the products summed in full f32 and C in ``a.dtype``:
    the blocked GEMM of ``slate_tpu``'s ``matmul_pallas``.  ``bm``, ``bn``
    and ``bk`` keep its clamp (:func:`pallas_blocks`); the plain twin pads
    to those blocks, the CUDA kernel picks its own tile and masks the
    ragged edges, and no padding shows in the result.  f32, bf16 and f16
    operands; f64 and complex raise ``TypeError`` (the TPU's Mosaic takes
    neither).  A CPU tensor takes ``ops.kernels.matmul_pallas_plain``, a
    CUDA tensor launches ``csrc/matmul.cu`` or raises."""
    from .kernels import _check_matmul, matmul_pallas as _kernel

    _check_matmul(a, b)
    return _kernel(a, b, *pallas_blocks(a.shape[0], a.shape[1], b.shape[1], bm, bn, bk))


@contextlib.contextmanager
def _tf32(enabled: bool):
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = enabled
    try:
        yield
    finally:
        flags.allow_tf32 = old


def _tf32_scope(a: torch.Tensor, precision: Precision):
    """TF32 on for High and off otherwise, for an f32 product on the card;
    a no-op when the flag already says so (the common case)."""
    want = precision == Precision.High
    if a.dtype != torch.float32 or not a.is_cuda or torch.backends.cuda.matmul.allow_tf32 == want:
        return contextlib.nullcontext()
    return _tf32(want)


def _resolve(precise: bool, precision: Optional[Precision]) -> Precision:
    if precision is None:
        return Precision.Highest if precise else Precision.Fast
    return Precision(precision)


def _fast_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of f32 operands at the Fast tier (see module doc)."""
    if a.is_cuda and a.dim() == 2 and b.dim() == 2:
        return torch.mm(a.to(torch.bfloat16), b.to(torch.bfloat16), out_dtype=torch.float32)
    return torch.matmul(a.to(torch.bfloat16).to(torch.float32), b.to(torch.bfloat16).to(torch.float32))


def _is_fast(precision: Precision, a: torch.Tensor, b: torch.Tensor) -> bool:
    return precision == Precision.Fast and a.dtype == b.dtype == torch.float32


def matmul(
    a: torch.Tensor,
    b: torch.Tensor,
    precise: bool = True,
    precision: Optional[Precision] = None,
) -> torch.Tensor:
    """``a @ b`` at the requested accumulation tier (see module doc);
    ``precise`` maps to Highest/Fast when ``precision`` is None."""
    precision = _resolve(precise, precision)
    if a.dim() == 2 and b.dim() == 2:
        m_, k_, n_ = a.shape[0], a.shape[1], b.shape[1]
        if (_tpu_is_default() and _F64_DISPATCH["ozaki"] and precision != Precision.Emulated
                and m_ * k_ * n_ >= _OZAKI_MIN_ELEMS and min(m_, k_, n_) >= _OZAKI_MIN_DIM):
            from .ozaki import matmul_c128, matmul_f64

            dt = torch.promote_types(a.dtype, b.dtype)
            n_slices = 6 if precision == Precision.Fast else 9
            if dt == torch.float64:
                return matmul_f64(a.to(dt), b.to(dt), n_slices=n_slices)
            if dt == torch.complex128:
                return matmul_c128(a.to(dt), b.to(dt), n_slices=n_slices)
        if precision == Precision.Highest and _use_pallas(a, b):
            return matmul_pallas(a, b)
    if _is_fast(precision, a, b):
        return _fast_mm(a, b)
    with _tf32_scope(a, precision):
        return torch.matmul(a, b)


def matmul_sub_(
    c: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    precision: Optional[Precision] = None,
) -> torch.Tensor:
    """``c -= a @ b`` in place — the trailing update of the factorizations.
    Where ``slate_tpu`` forms the product and subtracts it (XLA fuses the
    two), this is one GEMM with beta = 1, so no n x n temporary is
    allocated; at n = 32768 f32 that temporary would be 4.3 GB.  (The Fast
    tier, off the factorizations' path, forms the product first.)"""
    precision = _resolve(True, precision)
    if _is_fast(precision, a, b):
        return c.sub_(_fast_mm(a, b))
    with _tf32_scope(a, precision):
        return c.addmm_(a, b, alpha=-1)
