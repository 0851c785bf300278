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
leaves them to XLA.  Not ported yet: the Ozaki f64 branch (taken by
``slate_tpu`` only on a TPU backend) and the off-by-default Pallas GEMM
``matmul_pallas``; both wait for their slices.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from ..types import Precision


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
