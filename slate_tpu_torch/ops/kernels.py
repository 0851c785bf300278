"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Counterpart of ``slate_tpu/ops/pallas_ops.py``.  This slice holds:

- the ``Option.PanelImpl`` gate (:func:`resolve_panel_impl`,
  :func:`use_panel_impl`, :func:`panel_engaged`) with ``slate_tpu``'s
  resolve chain, environment name and values ``xla | pallas | auto``;
- :func:`chol_diag_inv`, the wrapper of ``csrc/chol_diag_inv.cu`` (the port
  of ``chol_diag_inv_pallas``), and :func:`chol_diag_inv_plain`, the same
  function in plain PyTorch.

Dispatch: ``pallas`` and ``auto`` take the CUDA kernel for a CUDA tensor and
the plain twin for a CPU tensor (the wrapper decides by the tensor's
device); ``xla`` takes the ``torch.linalg`` cholesky + solve_triangular
pair, the counterpart of the XLA ops ``slate_tpu`` uses there.  A CUDA
tensor never falls back to the twin: the kernel builds and launches, or the
call raises.

The other 13 Pallas kernels of ``pallas_ops.py`` / ``matmul.py`` are not
ported yet (ROADMAP.md, kernel queue).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import Optional, Tuple

import torch

from . import _build
from .matmul import matmul

PANEL_IMPLS = ("xla", "pallas", "auto")
PANEL_IMPL_ENV = "SLATE_TPU_PANEL_IMPL"

_PANEL_DEFAULT = [None]  # process-wide default (use_panel_impl)

# the largest block the CUDA kernel takes (one CTA, see csrc/chol_diag_inv.cu)
CHOL_DIAG_INV_MAX_N = 256
_CUDA_DTYPES = {torch.float32: "chol_diag_inv_f32", torch.float64: "chol_diag_inv_f64"}


def _check_panel_impl(impl: str) -> str:
    if impl not in PANEL_IMPLS:
        raise ValueError(f"unknown panel impl {impl!r}; expected one of {PANEL_IMPLS}")
    return impl


def resolve_panel_impl(impl: Optional[str] = None) -> str:
    """explicit argument > ``use_panel_impl`` context >
    ``SLATE_TPU_PANEL_IMPL`` environment > ``auto``."""
    if impl is None:
        impl = _PANEL_DEFAULT[-1]
    if impl is None:
        impl = os.environ.get(PANEL_IMPL_ENV) or "auto"
    return _check_panel_impl(impl)


@contextlib.contextmanager
def use_panel_impl(impl: str):
    """Set the default panel lowering for calls made inside the block."""
    _PANEL_DEFAULT.append(_check_panel_impl(impl))
    try:
        yield
    finally:
        _PANEL_DEFAULT.pop()


def panel_engaged(dtype: torch.dtype) -> bool:
    """Whether the diagonal-block factor goes through :func:`chol_diag_inv`
    (kernel on CUDA, twin on CPU).  ``xla`` never engages; ``pallas`` and
    ``auto`` engage every real floating dtype (complex keeps the
    torch.linalg pair, as in ``slate_tpu``).  On a CUDA tensor the wrapper
    then takes f32/f64 blocks up to 256 wide and raises on anything else."""
    if resolve_panel_impl() == "xla":
        return False
    return dtype.is_floating_point


# ---------------------------------------------------------------------------
# (L, L^-1) of one diagonal block
# ---------------------------------------------------------------------------


def chol_diag_inv_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: the column loop and the row-wise
    forward substitution of ``slate_tpu``'s ``_chol_inv_body``, op for op.
    Non-SPD input NaN-poisons through the sqrt."""
    n = a.shape[0]
    rows = torch.arange(n, device=a.device)
    cols = rows
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    w = a.clone()
    for j in range(n):
        col = w[:, j]
        d = torch.sqrt(col[j])
        lcol = torch.where(rows >= j, col / d, zero)
        lcol[j] = d
        w = torch.where((cols == j)[None, :], lcol[:, None], w)
        w = w - torch.where((cols > j)[None, :], lcol[:, None] * lcol[None, :], zero)
    l = w.tril()
    x = torch.zeros_like(a)
    for t in range(n):
        lrow = l[t]
        acc = matmul(torch.where(cols < t, lrow, zero)[None, :], x)[0]
        e = (cols == t).to(a.dtype)
        xrow = (e - acc) / lrow[t]
        x = torch.where((rows == t)[:, None], xrow[None, :], x)
    return l, x.tril()


def _chol_diag_inv_fn(dtype: torch.dtype):
    name = _CUDA_DTYPES[dtype]
    lib = _build.load("chol_diag_inv")
    fn = getattr(lib, name)
    # pointers and the stream as c_void_p: ctypes would cut a bare int to 32 bits
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chol_diag_inv(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) of one nb x nb SPD block (lower triangle read).

    A CPU tensor takes :func:`chol_diag_inv_plain`.  A CUDA tensor launches
    ``csrc/chol_diag_inv.cu`` on the current stream without synchronising,
    after checking dtype (f32/f64), shape (square, n <= 256) and
    contiguity; anything else raises.  ``chol_diag_inv.launches`` counts
    kernel launches."""
    if a.device.type == "cpu":
        return chol_diag_inv_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"chol_diag_inv: unsupported device {a.device}")
    if a.dtype not in _CUDA_DTYPES:
        raise TypeError(f"chol_diag_inv: dtype {a.dtype} not supported on CUDA (f32, f64)")
    if a.dim() != 2 or a.shape[0] != a.shape[1] or not 1 <= a.shape[0] <= CHOL_DIAG_INV_MAX_N:
        raise ValueError(
            f"chol_diag_inv: need a square block of side 1..{CHOL_DIAG_INV_MAX_N}, "
            f"got {tuple(a.shape)}"
        )
    if not a.is_contiguous():
        raise ValueError("chol_diag_inv: block must be contiguous")
    fn = _chol_diag_inv_fn(a.dtype)
    l = torch.empty_like(a)
    x = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), l.data_ptr(), x.data_ptr(), a.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"chol_diag_inv: kernel launch failed with CUDA error {rc}")
    chol_diag_inv.launches += 1
    return l, x


chol_diag_inv.launches = 0
