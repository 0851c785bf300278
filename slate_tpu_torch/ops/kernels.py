"""Hand-written CUDA kernels of the port, their wrappers and plain twins.

Counterpart of ``slate_tpu/ops/pallas_ops.py``.  This module holds:

- the ``Option.PanelImpl`` gate (:func:`resolve_panel_impl`,
  :func:`use_panel_impl`, :func:`panel_impl_scope`, :func:`panel_engaged`)
  and the ``Option.UpdateImpl`` gate (:func:`resolve_update_impl`,
  :func:`use_update_impl`, :func:`update_impl_scope`,
  :func:`update_engaged`), with ``slate_tpu``'s resolve chains, environment
  names and values ``xla | pallas | auto``;
- :func:`chol_diag_inv`, the wrapper of ``csrc/chol_diag_inv.cu`` (the port
  of ``chol_diag_inv_pallas``), and :func:`chol_diag_inv_plain`, the same
  function in plain PyTorch;
- the mesh kernels on ``csrc/tile_gemm.cu``: :func:`chol_panel_tiles`
  (``chol_panel_tiles_pallas``), :func:`chol_trailing_update`
  (``chol_trailing_update_pallas``) and :func:`summa_update`
  (``summa_update_pallas``), each with its ``*_plain`` twin;
- the LU kernels: :func:`lu_panel_tiles` (``lu_panel_tiles_pallas``) and
  :func:`lu_rowsolve_tiles` (``lu_rowsolve_tiles_pallas``), whose diagonal
  block runs on ``csrc/lu_diag_inv.cu`` (its ``lu_diag_inv`` and
  ``unit_linv`` entry points) and whose tile solves run on
  ``csrc/tile_gemm.cu``, and :func:`lu_trailing_update`
  (``lu_trailing_update_pallas``) on ``csrc/tile_gemm.cu``, each with its
  ``*_plain`` twin;
- the Householder panels on ``csrc/qr_panel.cu``: :func:`qr_panel`
  (``qr_panel_pallas``: the packed VR, tau and the compact-WY T of an
  (m, w) panel) and :func:`qr_panel_offset` (``qr_panel_offset_pallas``:
  the same with the pivot of column j at row ``row0 + j``), each over a
  batch of panels in one cooperative launch, with their twins
  :func:`qr_panel_plain` and :func:`qr_panel_offset_plain` (the
  ``_panel_qr`` + ``_larft`` and ``_panel_qr_offset`` + ``_larft_v``
  pairs, ``slate_tpu/linalg/qr.py``'s Householder loops op for op);
- the checksum-carrying SUMMA step on ``csrc/ft_summa_update.cu``:
  :func:`ft_summa_update` (``ft_summa_update_pallas``: the tile update and
  the Huang-Abraham weighted row sums in one pass), with its twin
  :func:`ft_summa_update_plain`.  ``ft.abft`` gates it by
  ``Option.PanelImpl`` (:func:`panel_engaged`), as ``slate_tpu`` does;
- the tile kernels on ``csrc/tile_ops.cu``: :func:`transpose_tiles`
  (``transpose_pallas``), :func:`geadd_tiles` (``geadd_pallas``) and
  :func:`genorm_max_tiles` (``genorm_max_pallas``), each with its
  ``*_plain`` twin, and their gate :func:`use_cuda_tiles` (the counterpart
  of ``use_pallas_tiles``, read by ``ops.tile_ops.transpose``).  These take
  no Option: a CPU tensor takes the twin, a CUDA tensor the kernel.

Dispatch of the panel and update kernels: ``pallas`` and ``auto`` take the
CUDA kernel for a CUDA tensor and the plain twin for a CPU tensor (the wrapper decides by the tensor's
device); ``xla`` takes the plain PyTorch forms (``torch.linalg`` for the
panel factor, the batched-matmul twins for the updates), the counterparts
of the XLA ops ``slate_tpu`` uses there.  A CUDA tensor never falls back to
the twin: the kernel builds and launches, or the call raises.  The update
wrappers work in place, where ``slate_tpu``'s return a new array.

- the GEMM on ``csrc/matmul.cu``'s tensor-core core: :func:`matmul_pallas`
  (``slate_tpu/ops/matmul.py``'s ``matmul_pallas``: C = A B summed in f32;
  f32 operands as six bf16 plane products, as the TPU's HIGHEST computes
  them), with its twin :func:`matmul_pallas_plain`, its per-operand layout
  plan :func:`matmul_operand_plan` and its pack :func:`matmul_pack`;
  ``ops.matmul.matmul_pallas`` is the public entry.

Each wrapper counts its kernel launches in ``<wrapper>.launches``; a CPU
call (the twin) does not count.  With ``matmul_pallas`` every Pallas kernel
of ``slate_tpu`` has its counterpart here.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .matmul import _tf32, matmul

PANEL_IMPLS = ("xla", "pallas", "auto")
PANEL_IMPL_ENV = "SLATE_TPU_PANEL_IMPL"

_PANEL_DEFAULT = [None]  # process-wide default (use_panel_impl)
_PANEL_ACTIVE = [None]  # the impl a mesh driver pinned (panel_impl_scope)

UPDATE_IMPLS = ("xla", "pallas", "auto")
UPDATE_IMPL_ENV = "SLATE_TPU_UPDATE_IMPL"

_UPDATE_DEFAULT = [None]  # process-wide default (use_update_impl)
_UPDATE_ACTIVE = [None]  # the impl a mesh driver pinned (update_impl_scope)

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


@contextlib.contextmanager
def panel_impl_scope(impl: str):
    """Pin the panel lowering for the calls inside (a mesh driver wraps its
    loop in it with the impl it resolved)."""
    _PANEL_ACTIVE.append(_check_panel_impl(impl))
    try:
        yield
    finally:
        _PANEL_ACTIVE.pop()


def panel_engaged(dtype: torch.dtype) -> bool:
    """Whether the diagonal-block factor goes through :func:`chol_diag_inv`
    / :func:`chol_panel_tiles` / :func:`lu_panel_tiles` /
    :func:`lu_rowsolve_tiles` (kernel on CUDA, twin on CPU), and a
    Householder panel through :func:`qr_panel` / :func:`qr_panel_offset`.
    ``xla`` never engages; ``pallas`` and ``auto`` engage every real
    floating dtype (complex keeps the torch.linalg pair, as in
    ``slate_tpu``).  On a CUDA tensor the wrappers then take f32/f64 blocks
    up to 256 wide and raise on anything else: the mesh Cholesky casts bf16
    panels to f32 first, as ``slate_tpu`` does, and so do the mesh LU
    panels and ``linalg.qr``'s Householder panels."""
    impl = _PANEL_ACTIVE[-1] or resolve_panel_impl()
    if impl == "xla":
        return False
    return dtype.is_floating_point


def _check_update_impl(impl: str) -> str:
    if impl not in UPDATE_IMPLS:
        raise ValueError(f"unknown update impl {impl!r}; expected one of {UPDATE_IMPLS}")
    return impl


def resolve_update_impl(impl: Optional[str] = None) -> str:
    """explicit argument > ``use_update_impl`` context >
    ``SLATE_TPU_UPDATE_IMPL`` environment > ``auto``."""
    if impl is None:
        impl = _UPDATE_DEFAULT[-1]
    if impl is None:
        impl = os.environ.get(UPDATE_IMPL_ENV) or "auto"
    return _check_update_impl(impl)


@contextlib.contextmanager
def use_update_impl(impl: str):
    """Set the default trailing-update lowering for calls made inside."""
    _UPDATE_DEFAULT.append(_check_update_impl(impl))
    try:
        yield
    finally:
        _UPDATE_DEFAULT.pop()


@contextlib.contextmanager
def update_impl_scope(impl: str):
    """Pin the trailing-update lowering for the calls inside (a mesh
    driver wraps its loop in it with the impl it resolved)."""
    _UPDATE_ACTIVE.append(_check_update_impl(impl))
    try:
        yield
    finally:
        _UPDATE_ACTIVE.pop()


def update_engaged(dtype: torch.dtype) -> bool:
    """Whether a mesh trailing update goes through the update wrappers
    (:func:`summa_update`, :func:`chol_trailing_update`,
    :func:`lu_trailing_update`: kernel on CUDA,
    twin on CPU).  ``xla`` never engages; ``pallas`` and ``auto`` engage
    f32 and f64, the dtypes the kernel takes.  bf16/f16 and complex keep
    the plain batched-matmul form on every device (``slate_tpu`` keeps
    complex on its einsum too)."""
    impl = _UPDATE_ACTIVE[-1] or resolve_update_impl()
    if impl == "xla":
        return False
    return dtype in (torch.float32, torch.float64)


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
    _check_block("chol_diag_inv", a)
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


# ---------------------------------------------------------------------------
# mesh kernels on csrc/tile_gemm.cu: C[r,q,i,j] (=, +=, -=) A[r,q,i] op(B[r,q,j])
# ---------------------------------------------------------------------------

_TILE_GEMM_DTYPES = {torch.float32: "tile_gemm_f32", torch.float64: "tile_gemm_f64"}
_MODE_SET, _MODE_ADD, _MODE_SUB = 0, 1, 2


def _tile_gemm_fn(dtype: torch.dtype):
    lib = _build.load("tile_gemm")
    fn = getattr(lib, _TILE_GEMM_DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda(who: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{who}: unsupported device {dev}")
    dtype = tensors[0].dtype
    if dtype not in _TILE_GEMM_DTYPES:
        raise TypeError(f"{who}: dtype {dtype} not supported on CUDA (f32, f64)")
    for t in tensors:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{who}: operands must share device and dtype, got "
                             f"{[(str(x.device), x.dtype) for x in tensors]}")


def _check_block(who: str, a: torch.Tensor) -> None:
    """A diagonal block the one-CTA kernels take: CUDA, f32/f64, square,
    side <= 256."""
    _check_cuda(who, a)
    if a.dim() != 2 or a.shape[0] != a.shape[1] or not 1 <= a.shape[0] <= CHOL_DIAG_INV_MAX_N:
        raise ValueError(f"{who}: need a square block of side 1..{CHOL_DIAG_INV_MAX_N}, "
                         f"got {tuple(a.shape)}")


def load16(shape, strides, ptr: int, itemsize: int, nb: int) -> bool:
    """Whether the tile-GEMM core (``csrc/tile_mma.cuh``) may load an
    operand of nb x nb tiles 16 bytes at a time: its last index has stride
    1, the stride of every other dim longer than 1 is a multiple of 16
    bytes, its base ``ptr`` is 16-byte aligned and nb is a multiple of the
    16-byte vector, so every copy is whole and aligned.  Otherwise the
    kernel copies one element at a time.  A pure function of the view,
    decided once per launch and operand."""
    vec = 16 // itemsize
    if nb % vec or ptr % 16 or strides[-1] != 1:
        return False
    return all(s % vec == 0 for d, s in zip(shape[:-1], strides[:-1]) if d > 1)


def _load16(t: torch.Tensor, nb: int) -> int:
    return int(load16(t.shape, t.stride(), t.data_ptr(), t.element_size(), nb))


def _tile_gemm(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, mask: Optional[torch.Tensor],
               trans_b: bool, mode: int, who: str) -> None:
    """One launch of the tile-GEMM over strided views: ``c`` is (R, Q, I, J,
    nb, nb); ``a`` broadcasts to (R, Q, I, nb, nb), ``b`` to (R, Q, J, nb,
    nb), ``mask`` (int-valued) to (R, Q, I, J).  Broadcast dims are read
    with stride 0; nothing is copied."""
    _check_cuda(who, c, a, b)
    if c.dim() != 6 or a.dim() != 5 or b.dim() != 5:
        raise ValueError(f"{who}: need c (R,Q,I,J,nb,nb), a (R,Q,I,nb,nb), b (R,Q,J,nb,nb); got "
                         f"{tuple(c.shape)}, {tuple(a.shape)}, {tuple(b.shape)}")
    R, Q, I, J, nb, nb2 = c.shape
    if nb != nb2:
        raise ValueError(f"{who}: tiles must be square, got {nb} x {nb2}")
    try:
        a = a.expand(R, Q, I, nb, nb)
        b = b.expand(R, Q, J, nb, nb)
        if mask is not None:
            if mask.dtype != torch.int32:
                mask = mask.to(torch.int32)
            mask = mask.to(c.device).expand(R, Q, I, J)
    except RuntimeError as e:
        raise ValueError(f"{who}: operand shapes do not broadcast to the tile grid: {e}") from e
    sm = mask.stride() if mask is not None else (0, 0, 0, 0)
    geom = (ctypes.c_longlong * 30)(R, Q, I, J, nb, *a.stride(), *b.stride(), *c.stride(), *sm,
                                    int(trans_b), mode, int(mask is not None),
                                    _load16(a, nb), _load16(b, nb))
    fn = _tile_gemm_fn(c.dtype)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                mask.data_ptr() if mask is not None else None, geom, stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error {rc}")


def summa_update_plain(acc: torch.Tensor, pan: torch.Tensor, urow: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`summa_update`: one batched matmul of every tile
    pair, added in place."""
    return acc.add_(torch.matmul(pan.unsqueeze(-3), urow.unsqueeze(-4)))


def summa_update(acc: torch.Tensor, pan: torch.Tensor, urow: torch.Tensor) -> torch.Tensor:
    """One SUMMA accumulation step over the virtual mesh, in place:
    ``acc[r,q,i,j] += pan[r,q,i] @ urow[r,q,j]`` with ``acc`` (R, Q, I, J,
    nb, nb) and the panels broadcasting to (R, Q, I|J, nb, nb).  A CPU
    tensor takes the twin; a CUDA tensor launches ``csrc/tile_gemm.cu``
    once (``summa_update.launches``) or raises."""
    if acc.device.type == "cpu":
        return summa_update_plain(acc, pan, urow)
    _tile_gemm(acc, pan, urow, None, trans_b=False, mode=_MODE_ADD, who="summa_update")
    summa_update.launches += 1
    return acc


summa_update.launches = 0


def chol_trailing_update_plain(view: torch.Tensor, pan: torch.Tensor, pan_t: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`chol_trailing_update`: the batched product of
    every tile pair, selected by the mask and subtracted in place."""
    upd = torch.matmul(pan.unsqueeze(-3), pan_t.unsqueeze(-4).transpose(-1, -2))
    return view.sub_(torch.where(mask[..., None, None] != 0, upd, torch.zeros((), dtype=upd.dtype,
                                                                               device=upd.device)))


def chol_trailing_update(view: torch.Tensor, pan: torch.Tensor, pan_t: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """The potrf trailing herk over the virtual mesh, in place:
    ``view[r,q,i,j] -= mask[r,q,i,j] ? pan[r,q,i] @ pan_t[r,q,j]^T : 0``.
    ``view`` is (R, Q, I, J, nb, nb), any strides (a bucket's trailing
    window of the tile stack); the panels broadcast to (R, Q, I|J, nb, nb)
    and ``mask`` to (R, Q, I, J).  Masked tiles are neither read nor
    written.  A CPU tensor takes the twin; a CUDA tensor launches
    ``csrc/tile_gemm.cu`` once (``chol_trailing_update.launches``) or
    raises."""
    if view.device.type == "cpu":
        return chol_trailing_update_plain(view, pan, pan_t, mask)
    _tile_gemm(view, pan, pan_t, mask, trans_b=True, mode=_MODE_SUB, who="chol_trailing_update")
    chol_trailing_update.launches += 1
    return view


chol_trailing_update.launches = 0


def _tile_batch(tiles: torch.Tensor) -> torch.Tensor:
    """(..., nb, nb) with at most three leading dims as (R, Q, I, nb, nb)."""
    lead = tiles.dim() - 2
    if not 0 <= lead <= 3:
        raise ValueError(f"panel tiles: need (..., nb, nb) with <= 3 leading dims, "
                         f"got {tuple(tiles.shape)}")
    for _ in range(3 - lead):
        tiles = tiles.unsqueeze(0)
    return tiles


def chol_panel_tiles_plain(dtile: torch.Tensor, tiles: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`chol_panel_tiles`: (L, L^-1) by
    :func:`chol_diag_inv_plain`, then every tile times L^-T."""
    l, x = chol_diag_inv_plain(dtile)
    return l, torch.matmul(tiles, x.T)


def chol_panel_tiles(dtile: torch.Tensor, tiles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The potrf panel phase: (tril L_kk, the tile stack solved against
    L_kk^T, i.e. ``tiles[...] @ L_kk^-T``).  ``dtile`` is the nb x nb
    diagonal tile (lower triangle read), ``tiles`` (..., nb, nb) with up to
    three leading dims, any strides.  A CPU tensor takes the twin.  A CUDA
    tensor launches ``csrc/chol_diag_inv.cu`` for (L, L^-1) and then
    ``csrc/tile_gemm.cu`` for the solve, both on the current stream;
    ``chol_panel_tiles.launches`` counts wrapper calls (one per panel)."""
    if dtile.device.type == "cpu":
        return chol_panel_tiles_plain(dtile, tiles)
    _check_cuda("chol_panel_tiles", dtile, tiles)
    _check_block("chol_panel_tiles", dtile)
    nb = dtile.shape[-1]
    if tiles.shape[-2:] != dtile.shape:
        raise ValueError(f"chol_panel_tiles: tiles {tuple(tiles.shape)} do not match the "
                         f"diagonal tile {tuple(dtile.shape)}")
    dtile = dtile.contiguous()
    l = torch.empty_like(dtile)
    x = torch.empty_like(dtile)
    fn = _chol_diag_inv_fn(dtile.dtype)
    with torch.cuda.device(dtile.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(dtile.data_ptr(), l.data_ptr(), x.data_ptr(), nb, stream)
    if rc != 0:
        raise RuntimeError(f"chol_panel_tiles: factor launch failed with CUDA error {rc}")
    solved = torch.empty(tiles.shape, dtype=tiles.dtype, device=tiles.device)
    _tile_gemm(_tile_batch(solved).unsqueeze(3), _tile_batch(tiles), x[None, None, None],
               None, trans_b=True, mode=_MODE_SET, who="chol_panel_tiles")
    chol_panel_tiles.launches += 1
    return l, solved


chol_panel_tiles.launches = 0


# ---------------------------------------------------------------------------
# the LU panel and trailing kernels: csrc/lu_diag_inv.cu (the diagonal block)
# and csrc/tile_gemm.cu (the tile solves and the update)
# ---------------------------------------------------------------------------

_LU_FNS = {"lu_diag_inv": 3, "unit_linv": 2}  # entry point -> pointer arguments


def lu_diag_inv_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the diagonal-block LU: the column loop and the
    row-wise back substitution of ``slate_tpu``'s ``_lu_inv_body``, op for
    op.  Returns (packed L\\U, U^-1); a zero pivot divides by 1 in the
    factor and by the raw 0 in U^-1 (inf/NaN there)."""
    n = a.shape[0]
    rows = torch.arange(n, device=a.device)
    cols = rows
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    w = a.clone()
    for j in range(n):
        col = w[:, j]
        piv = col[j]
        denom = torch.where(piv == 0, torch.ones_like(piv), piv)
        lcol = torch.where(rows > j, col / denom, zero)
        w = torch.where((cols == j)[None, :], torch.where(rows > j, lcol, col)[:, None], w)
        urow = w[j]
        w = w - torch.where((cols > j)[None, :], lcol[:, None] * urow[None, :], zero)
    x = torch.zeros_like(a)
    for s in range(n):
        t = n - 1 - s
        urow = w[t]
        acc = matmul(torch.where(cols > t, urow, zero)[None, :], x)[0]
        e = (cols == t).to(a.dtype)
        xrow = (e - acc) / urow[t]
        x = torch.where((rows == t)[:, None], xrow[None, :], x)
    return w, x.triu()


def unit_linv_plain(lu: torch.Tensor) -> torch.Tensor:
    """Plain twin of unit-L^-1 from a packed L\\U block: the row-wise
    forward substitution of ``slate_tpu``'s ``_unit_linv_body``."""
    n = lu.shape[0]
    rows = torch.arange(n, device=lu.device)
    cols = rows
    zero = torch.zeros((), dtype=lu.dtype, device=lu.device)
    x = torch.zeros_like(lu)
    for t in range(n):
        lrow = lu[t]
        acc = matmul(torch.where(cols < t, lrow, zero)[None, :], x)[0]
        xrow = (cols == t).to(lu.dtype) - acc
        x = torch.where((rows == t)[:, None], xrow[None, :], x)
    return x.tril()


def _lu_fn(entry: str, dtype: torch.dtype):
    fn = getattr(_build.load("lu_diag_inv"), f"{entry}_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [ctypes.c_void_p] * _LU_FNS[entry] + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_lu(entry: str, who: str, src: torch.Tensor, *outs: torch.Tensor) -> None:
    fn = _lu_fn(entry, src.dtype)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(src.data_ptr(), *(o.data_ptr() for o in outs), src.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"{who}: {entry} launch failed with CUDA error {rc}")


def lu_panel_tiles_plain(dtile: torch.Tensor, tiles: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`lu_panel_tiles`: (L\\U, U^-1) by
    :func:`lu_diag_inv_plain`, then every tile times U^-1."""
    lu, x = lu_diag_inv_plain(dtile)
    return lu, torch.matmul(tiles, x)


def lu_panel_tiles(dtile: torch.Tensor, tiles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The getrf-nopiv panel-column phase: (packed L\\U of the diagonal
    tile, ``tiles[...] @ U^-1``).  ``tiles`` is (..., nb, nb) with up to
    three leading dims, any strides.  A CPU tensor takes the twin.  A CUDA
    tensor launches ``csrc/lu_diag_inv.cu`` for (L\\U, U^-1) and then
    ``csrc/tile_gemm.cu`` for the solve (mode set, U^-1 shared by every
    tile with stride 0); ``lu_panel_tiles.launches`` counts wrapper calls
    (one per panel)."""
    if dtile.device.type == "cpu":
        return lu_panel_tiles_plain(dtile, tiles)
    _check_cuda("lu_panel_tiles", dtile, tiles)
    _check_block("lu_panel_tiles", dtile)
    if tiles.shape[-2:] != dtile.shape:
        raise ValueError(f"lu_panel_tiles: tiles {tuple(tiles.shape)} do not match the "
                         f"diagonal tile {tuple(dtile.shape)}")
    dtile = dtile.contiguous()
    lu, x = torch.empty_like(dtile), torch.empty_like(dtile)
    _launch_lu("lu_diag_inv", "lu_panel_tiles", dtile, lu, x)
    solved = torch.empty(tiles.shape, dtype=tiles.dtype, device=tiles.device)
    _tile_gemm(_tile_batch(solved).unsqueeze(3), _tile_batch(tiles), x[None, None, None],
               None, trans_b=False, mode=_MODE_SET, who="lu_panel_tiles")
    lu_panel_tiles.launches += 1
    return lu, solved


lu_panel_tiles.launches = 0


def lu_rowsolve_tiles_plain(luk: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`lu_rowsolve_tiles`: unit-L^-1 by
    :func:`unit_linv_plain`, then L^-1 times every tile."""
    return torch.matmul(unit_linv_plain(luk), tiles)


def lu_rowsolve_tiles(luk: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """The getrf-nopiv panel-row phase: ``unit-L^-1 @ tiles[...]`` for the
    packed L\\U ``luk``.  ``tiles`` is (..., nb, nb) with up to three
    leading dims, any strides.  A CPU tensor takes the twin.  A CUDA tensor
    launches ``csrc/lu_diag_inv.cu`` for L^-1 and then ``csrc/tile_gemm.cu``
    for the solve (mode set, L^-1 the shared A, the tiles as B);
    ``lu_rowsolve_tiles.launches`` counts wrapper calls (one per panel)."""
    if luk.device.type == "cpu":
        return lu_rowsolve_tiles_plain(luk, tiles)
    _check_cuda("lu_rowsolve_tiles", luk, tiles)
    _check_block("lu_rowsolve_tiles", luk)
    if tiles.shape[-2:] != luk.shape:
        raise ValueError(f"lu_rowsolve_tiles: tiles {tuple(tiles.shape)} do not match the "
                         f"diagonal tile {tuple(luk.shape)}")
    luk = luk.contiguous()
    x = torch.empty_like(luk)
    _launch_lu("unit_linv", "lu_rowsolve_tiles", luk, x)
    solved = torch.empty(tiles.shape, dtype=tiles.dtype, device=tiles.device)
    _tile_gemm(_tile_batch(solved).unsqueeze(2), x[None, None, None], _tile_batch(tiles),
               None, trans_b=False, mode=_MODE_SET, who="lu_rowsolve_tiles")
    lu_rowsolve_tiles.launches += 1
    return solved


lu_rowsolve_tiles.launches = 0


def lu_trailing_update_plain(view: torch.Tensor, pan: torch.Tensor, urow: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`lu_trailing_update`: the batched product of
    every tile pair, selected by the mask and subtracted in place (the
    contraction -> select -> subtract of ``lu_trailing_update_pallas``)."""
    upd = torch.matmul(pan.unsqueeze(-3), urow.unsqueeze(-4))
    return view.sub_(torch.where(mask[..., None, None] != 0, upd,
                                 torch.zeros((), dtype=upd.dtype, device=upd.device)))


def lu_trailing_update(view: torch.Tensor, pan: torch.Tensor, urow: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """The LU trailing update over the virtual mesh, in place:
    ``view[r,q,i,j] -= mask[r,q,i,j] ? pan[r,q,i] @ urow[r,q,j] : 0``.
    ``view`` is (R, Q, I, J, nb, nb), any strides; the panels broadcast to
    (R, Q, I|J, nb, nb) and ``mask`` to (R, Q, I, J).  Masked tiles are
    neither read nor written.  A CPU tensor takes the twin; a CUDA tensor
    launches ``csrc/tile_gemm.cu`` once (``lu_trailing_update.launches``)
    or raises."""
    if view.device.type == "cpu":
        return lu_trailing_update_plain(view, pan, urow, mask)
    _tile_gemm(view, pan, urow, mask, trans_b=False, mode=_MODE_SUB, who="lu_trailing_update")
    lu_trailing_update.launches += 1
    return view


lu_trailing_update.launches = 0


# ---------------------------------------------------------------------------
# the Householder panel kernels: csrc/qr_panel.cu (reflectors, the trailing
# updates inside the panel and the compact-WY T in one cooperative launch)
# ---------------------------------------------------------------------------

# the widest panel the kernel takes (csrc/qr_panel.cu's kMaxW)
QR_PANEL_MAX_W = 256

_QR_FNS = {}  # dtype -> (plan, run) of csrc/qr_panel.cu
_QR_PLANS = {}  # (dtype, batch, m, w, device index) -> (CTAs per panel, scratch elements)


def _qr_fns(dtype: torch.dtype):
    fns = _QR_FNS.get(dtype)
    if fns is None:
        lib = _build.load("qr_panel")
        sfx = "f32" if dtype == torch.float32 else "f64"
        plan = getattr(lib, f"qr_panel_plan_{sfx}")
        plan.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
        plan.restype = ctypes.c_int
        run = getattr(lib, f"qr_panel_{sfx}")
        run.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        run.restype = ctypes.c_int
        fns = _QR_FNS[dtype] = (plan, run)
    return fns


def _qr_plan(dtype: torch.dtype, bsz: int, m: int, w: int, device: torch.device):
    """(CTAs per panel, scratch elements) of one launch, asked of the
    library once per (dtype, batch, m, w, device): the grid depends on the
    shape and the card alone."""
    key = (dtype, bsz, m, w, device.index)
    got = _QR_PLANS.get(key)
    if got is None:
        elems = ctypes.c_longlong(0)
        nc = _qr_fns(dtype)[0](bsz, m, w, ctypes.byref(elems))
        got = _QR_PLANS[key] = (nc, elems.value)
    return got


def _launch_qr(a: torch.Tensor, row0, who: str):
    """One launch of csrc/qr_panel.cu over a (B, m, w) batch of panels;
    ``row0`` is None (the plain panel) or B pivot-row offsets, passed to the
    kernel by value (no copy to the device).  Returns (work, v, tau, t): the
    packed VR (or r), the explicit reflectors (offset form, else None), tau
    (B, w) and T (B, w, w)."""
    _check_cuda(who, a)
    bsz, m, w = a.shape
    if not 1 <= w <= QR_PANEL_MAX_W or m < 1 or bsz < 1:
        raise ValueError(f"{who}: need panels of width 1..{QR_PANEL_MAX_W}, got {tuple(a.shape)}")
    a = a.contiguous()
    with torch.cuda.device(a.device):
        nc, elems = _qr_plan(a.dtype, bsz, m, w, a.device)
        if nc < 1:
            raise RuntimeError(f"{who}: no cooperative grid for {bsz} panel(s) of {m} x {w}")
        work = torch.empty_like(a)
        v = torch.empty_like(a) if row0 is not None else None
        tau = torch.empty((bsz, w), dtype=a.dtype, device=a.device)
        t = torch.empty((bsz, w, w), dtype=a.dtype, device=a.device)
        scratch = torch.empty(elems, dtype=a.dtype, device=a.device)
        r0 = (ctypes.c_int * bsz)(*row0) if row0 is not None else None
        stream = torch.cuda.current_stream().cuda_stream
        rc = _qr_fns(a.dtype)[1](
            a.data_ptr(), work.data_ptr(), v.data_ptr() if v is not None else None,
            tau.data_ptr(), t.data_ptr(), ctypes.cast(r0, ctypes.c_void_p) if r0 is not None else None,
            scratch.data_ptr(), bsz, m, w, nc, int(row0 is not None), stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error {rc}")
    return work, v, tau, t


def qr_sync_ms(dtype: torch.dtype, bsz: int, m: int, w: int, mode: str = "exchange",
               iters: int = 2000) -> float:
    """Milliseconds of one empty round of csrc/qr_panel.cu's synchronisation
    at the grid its plan gives (bsz, m, w) on the current card: ``exchange``,
    the tagged column exchange of a column step (every CTA publishes 32
    values and reads every CTA's), or ``barrier``, the block barrier.
    ``iters`` rounds in one cooperative launch, timed by CUDA events after a
    warm-up launch.  A measurement helper (no path calls it): w exchanges
    and two barriers a 32-column block are the kernel's floor."""
    nc, _ = _qr_plan(dtype, bsz, m, w, torch.device("cuda", torch.cuda.current_device()))
    if nc < 1:
        raise RuntimeError(f"qr_sync_ms: no cooperative grid for {bsz} panel(s) of {m} x {w}")
    lib = _build.load("qr_panel")
    fn = getattr(lib, "qr_probe_f32" if dtype == torch.float32 else "qr_probe_f64")
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    size = lib.qr_probe_scratch_bytes
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    isz = torch.empty((), dtype=dtype).element_size()
    scratch = torch.empty(size(isz, bsz, nc), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    times = []
    for _ in range(2):  # the first is the warm-up
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = fn(bsz, nc, iters, int(mode == "barrier"), scratch.data_ptr(), stream)
        stop.record()
        if rc != 0:
            raise RuntimeError(f"qr_sync_ms: launch failed with CUDA error {rc}")
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return times[-1] / iters


def qr_panel_smem_bytes(dtype: torch.dtype, bsz: int, m: int, w: int) -> int:
    """The dynamic shared memory of csrc/qr_panel.cu's launch for a
    (bsz, m, w) batch on the current card, in bytes."""
    fn = _build.load("qr_panel").qr_panel_smem_bytes
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(torch.empty((), dtype=dtype).element_size(), bsz, m, w))


def _row0_list(a: torch.Tensor, row0) -> list:
    """The pivot-row offsets of a (m, w) panel (an int) or a (B, m, w) batch
    (B ints), checked: the offset form needs row0 + w <= m."""
    m, w = a.shape[-2:]
    if a.dim() == 2:
        r0 = [int(row0)]
    else:
        r0 = [int(r) for r in (row0.tolist() if isinstance(row0, torch.Tensor) else row0)]
        if len(r0) != a.shape[0]:
            raise ValueError(f"qr_panel_offset: {len(r0)} offsets for {a.shape[0]} panels")
    for r in r0:
        if not 0 <= r <= m - w:
            raise ValueError(f"qr_panel_offset: row0 {r} outside 0..{m - w} for a {m} x {w} panel")
    return r0


def _sign_safe(x: torch.Tensor) -> torch.Tensor:
    """sign(x) with sign(0) = 1, complex-safe (LAPACK larfg convention):
    +1 for x >= 0, so -0.0 gives +1 and NaN gives -1."""
    if x.is_complex():
        mag = x.abs()
        return torch.where(mag == 0, torch.ones_like(x), x / torch.where(mag == 0, 1, mag))
    return torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))


def _householder(col: torch.Tensor, alpha: torch.Tensor, below: torch.Tensor):
    """The reflector scalars of one column: (beta, tau, denom, dead)."""
    xnorm2 = torch.sum(torch.where(below, col.abs() ** 2, 0))
    anorm = torch.sqrt(alpha.abs() ** 2 + xnorm2)
    s = _sign_safe(alpha if not col.is_complex()
                   else torch.where(alpha.real == 0, torch.ones_like(alpha), alpha))
    beta = -s * anorm.to(col.dtype)
    dead = anorm == 0
    beta = torch.where(dead, torch.ones_like(beta), beta)
    tj = (beta - alpha) / beta
    tj = torch.where(dead, torch.zeros_like(tj), tj)
    denom = alpha - beta
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    return beta, tj, denom, dead


def _panel_qr(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unblocked Householder QR of (m, w), min(m, w) steps.  Returns
    (packed VR, tau): above the diagonal the updated entries of ``a``, on
    it R, below it V."""
    m, w = a.shape
    rows = torch.arange(m, device=a.device)
    cols = torch.arange(w, device=a.device)
    tau = torch.zeros(w, dtype=a.dtype, device=a.device)
    for j in range(min(m, w)):
        col = a[:, j]
        below = rows > j
        alpha = col[j]
        beta, tj, denom, dead = _householder(col, alpha, below)
        v = torch.where(below, col / denom, torch.zeros_like(col))
        v[j] = 1
        w_row = matmul(v.conj()[None, :], a)[0]  # v^H A
        cmask = (cols > j).to(a.dtype)
        a = a - torch.outer(tj * v, w_row * cmask)
        newcol = torch.where(below, v, a[:, j])
        newcol[j] = torch.where(dead, alpha, beta)
        a[:, j] = newcol
        tau[j] = tj
    return a, tau


def _panel_qr_offset(a: torch.Tensor, row0: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Householder QR of a full-height column block whose pivot row for
    column j is row ``row0 + j`` (w steps; row0 + w <= m).  Rows < row0 of
    ``a`` must be zero and are never touched.  A dead column (no weight at
    or below its pivot) gets tau = 0 and a zero reflector pivot entry.

    Returns (r, v, tau): ``r`` is ``a`` with R at rows row0..row0+w and
    zeros below each pivot, ``v`` the explicit reflectors, ``tau`` the w
    scalar factors."""
    m, w = a.shape
    rows = torch.arange(m, device=a.device)
    cols = torch.arange(w, device=a.device)
    vmat = torch.zeros_like(a)
    tau = torch.zeros(w, dtype=a.dtype, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    one = torch.ones((), dtype=a.dtype, device=a.device)
    for j in range(w):
        gi = int(row0) + j
        col = a[:, j]
        below = rows > gi
        alpha = col[gi]
        beta, tj, denom, dead = _householder(col, alpha, below)
        v = torch.where(below, col / denom, torch.zeros_like(col))
        v[gi] = torch.where(dead, zero, one)
        w_row = matmul(v.conj()[None, :], a)[0]
        cmask = (cols > j).to(a.dtype)
        newcol = torch.where(below, torch.zeros_like(col), col)
        newcol[gi] = torch.where(dead, alpha, beta)
        a = a - torch.outer(tj * v, w_row * cmask)
        a[:, j] = newcol
        vmat[:, j] = v
        tau[j] = tj
    return a, vmat, tau


def _larft_v(v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Compact-WY T from explicit reflectors (columns of ``v``), LAPACK
    larft forward columnwise: T[:j, j] = -tau_j * T[:j, :j] @ (V^H v_j)."""
    w = v.shape[1]
    vhv = matmul(v.conj().T, v)
    t = torch.zeros((w, w), dtype=v.dtype, device=v.device)
    idx = torch.arange(w, device=v.device)
    for j in range(w):
        tcol = -tau[j] * matmul(t, vhv[:, j][:, None])[:, 0]
        t[:, j] = tcol * (idx < j).to(v.dtype)
        t[j, j] = tau[j]
    return t


def _larft(vr: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """Compact-WY T from packed reflectors (unit-lower V read out of the
    packed VR)."""
    m, w = vr.shape
    rows = torch.arange(m, device=vr.device)[:, None]
    cols = torch.arange(w, device=vr.device)[None, :]
    v = torch.where(rows > cols, vr, torch.where(rows == cols, torch.ones_like(vr),
                                                 torch.zeros_like(vr)))
    return _larft_v(v, tau)


def qr_panel_plain(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`qr_panel`: :func:`_panel_qr` then
    :func:`_larft` (the op sequence of ``qr_panel_pallas``'s body), per
    panel of a batch."""
    if a.dim() == 3:
        outs = [qr_panel_plain(x) for x in a]
        return tuple(torch.stack(o) for o in zip(*outs))
    vr, tau = _panel_qr(a)
    return vr, tau, _larft(vr, tau)


def qr_panel(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unblocked Householder QR of an (m, w) panel with its compact-WY T:
    (packed VR, tau, T), Q = I - V T V^T; ``a`` may carry a leading batch
    dim (B, m, w).  A CPU tensor takes :func:`qr_panel_plain`.  A CUDA
    tensor launches ``csrc/qr_panel.cu`` once for the whole batch (f32/f64,
    w <= 256; anything else raises); ``qr_panel.launches`` counts
    launches."""
    if a.device.type == "cpu":
        return qr_panel_plain(a)
    batched = a.dim() == 3
    vr, _, tau, t = _launch_qr(a if batched else a[None], None, "qr_panel")
    qr_panel.launches += 1
    return (vr, tau, t) if batched else (vr[0], tau[0], t[0])


qr_panel.launches = 0


def qr_panel_offset_plain(a: torch.Tensor, row0
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`qr_panel_offset`: :func:`_panel_qr_offset`
    then :func:`_larft_v` (``qr_panel_offset_pallas``'s body), per panel."""
    r0 = _row0_list(a, row0)
    if a.dim() == 3:
        outs = [qr_panel_offset_plain(x, r) for x, r in zip(a, r0)]
        return tuple(torch.stack(o) for o in zip(*outs))
    r, v, tau = _panel_qr_offset(a, r0[0])
    return r, v, tau, _larft_v(v, tau)


def qr_panel_offset(a: torch.Tensor, row0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The offset-pivot panel: the pivot of column j is row ``row0 + j``
    (rows < row0 must be zero and stay untouched).  Returns (r, v, tau, T):
    r holds R at rows row0..row0+w and zeros below each pivot, v the
    explicit reflectors (unit pivot entries; 0 for a dead column, which
    gets tau = 0).  ``a`` is (m, w) with an int ``row0``, or a batch
    (B, m, w) with B offsets (one launch: the mesh factors the owning
    column's p panels together).  CPU: :func:`qr_panel_offset_plain`; CUDA:
    ``csrc/qr_panel.cu`` (``qr_panel_offset.launches``) or a raise."""
    if a.device.type == "cpu":
        return qr_panel_offset_plain(a, row0)
    r0 = _row0_list(a, row0)
    batched = a.dim() == 3
    r, v, tau, t = _launch_qr(a if batched else a[None], r0, "qr_panel_offset")
    qr_panel_offset.launches += 1
    return (r, v, tau, t) if batched else (r[0], v[0], tau[0], t[0])


qr_panel_offset.launches = 0


# ---------------------------------------------------------------------------
# the checksum-carrying SUMMA step: csrc/ft_summa_update.cu
# ---------------------------------------------------------------------------

_FT_SUMMA_DTYPES = {torch.float32: "ft_summa_update_f32", torch.float64: "ft_summa_update_f64"}


def _ft_summa_fn(dtype: torch.dtype):
    lib = _build.load("ft_summa_update")
    fn = getattr(lib, _FT_SUMMA_DTYPES[dtype])
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ft_summa_update_plain(acc: torch.Tensor, pan: torch.Tensor, urow: torch.Tensor,
                          w1: torch.Tensor, w2: torch.Tensor, part: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`ft_summa_update`: one batched matmul of every
    tile pair, added to ``acc``, and its unit / ramp weighted sums over
    the tile rows added to ``part``, in place."""
    upd = torch.matmul(pan.unsqueeze(-3), urow.unsqueeze(-4))  # (R, Q, I, J, nb, nb)
    acc.add_(upd)
    for s, w in enumerate((w1, w2)):
        part[:, :, s].add_((w[..., None, None, None] * upd).sum(2))
    return acc, part


def ft_summa_update(acc: torch.Tensor, pan: torch.Tensor, urow: torch.Tensor,
                    w1: torch.Tensor, w2: torch.Tensor, part: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One checksum-carrying SUMMA step over the virtual mesh, in place:
    ``acc[r,c,i,j] += pan[r,c,i] @ urow[r,c,j]`` and ``part[r,c,s,j] +=
    sum_i w_s[r,c,i] (pan[r,c,i] @ urow[r,c,j])`` for s = 0, 1 (``w1``,
    ``w2``).  ``acc`` is (R, Q, I, J, nb, nb), ``part`` (R, Q, 2, J, nb,
    nb), any strides; ``pan`` / ``urow`` broadcast to (R, Q, I|J, nb, nb)
    and the weights to (R, Q, I), read through stride 0.  CPU tensors take
    :func:`ft_summa_update_plain`; CUDA tensors launch
    ``csrc/ft_summa_update.cu`` once (``ft_summa_update.launches``) or the
    call raises: on a CPU/CUDA mix, a dtype other than f32/f64, a
    non-square tile or shapes that do not broadcast."""
    ops = (acc, pan, urow, w1, w2, part)
    if all(t.device.type == "cpu" for t in ops):
        return ft_summa_update_plain(*ops)
    who = "ft_summa_update"
    dev = acc.device
    if any(t.device != dev for t in ops) or dev.type != "cuda":
        raise ValueError(f"{who}: operands must all lie on one CUDA device, got "
                         f"{[str(t.device) for t in ops]}")
    if acc.dtype not in _FT_SUMMA_DTYPES:
        raise TypeError(f"{who}: dtype {acc.dtype} not supported on CUDA (f32, f64)")
    if any(t.dtype != acc.dtype for t in ops):
        raise ValueError(f"{who}: operands must share one dtype, got {[t.dtype for t in ops]}")
    if acc.dim() != 6 or part.dim() != 6 or pan.dim() != 5 or urow.dim() != 5:
        raise ValueError(f"{who}: need acc (R,Q,I,J,nb,nb), pan (R,Q,I,nb,nb), urow "
                         f"(R,Q,J,nb,nb), part (R,Q,2,J,nb,nb); got {tuple(acc.shape)}, "
                         f"{tuple(pan.shape)}, {tuple(urow.shape)}, {tuple(part.shape)}")
    R, Q, I, J, nb, nb2 = acc.shape
    if nb != nb2:
        raise ValueError(f"{who}: tiles must be square, got {nb} x {nb2}")
    if tuple(part.shape) != (R, Q, 2, J, nb, nb):
        raise ValueError(f"{who}: part {tuple(part.shape)} must be {(R, Q, 2, J, nb, nb)}")
    try:
        pan = pan.expand(R, Q, I, nb, nb)
        urow = urow.expand(R, Q, J, nb, nb)
        w1 = w1.expand(R, Q, I)
        w2 = w2.expand(R, Q, I)
    except RuntimeError as e:
        raise ValueError(f"{who}: operand shapes do not broadcast to the tile grid: {e}") from e
    geom = (ctypes.c_longlong * 35)(R, Q, I, J, nb, *pan.stride(), *urow.stride(), *acc.stride(),
                                    *w1.stride(), *w2.stride(), *part.stride(),
                                    _load16(pan, nb), _load16(urow, nb))
    fn = _ft_summa_fn(acc.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(pan.data_ptr(), urow.data_ptr(), acc.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                part.data_ptr(), geom, stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error {rc}")
    ft_summa_update.launches += 1
    return acc, part


ft_summa_update.launches = 0


# ---------------------------------------------------------------------------
# the tile kernels on csrc/tile_ops.cu: transpose, geadd, per-tile max |a|
# ---------------------------------------------------------------------------

_TILE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# the width the plain geadd forms its sum in: both products are exact there
_GEADD_WIDE = {torch.float32: torch.float64, torch.bfloat16: torch.float32}


def use_cuda_tiles(a) -> bool:
    """Whether a tile stack takes the tile kernels: the counterpart of
    ``slate_tpu``'s ``use_pallas_tiles`` (a TPU backend there, a CUDA
    tensor here), f32 or bf16, a 3-D (k, mb, nb) stack with nb >= 128 and
    k >= 8."""
    if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
        return False
    if a.dtype not in _TILE_DTYPES:
        return False
    return a.dim() == 3 and a.shape[-1] >= 128 and a.shape[0] >= 8


def _tile_fn(kernel: str, dtype: torch.dtype):
    lib = _build.load("tile_ops")
    fn = getattr(lib, f"tile_{kernel}_{_TILE_DTYPES[dtype]}")
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = {"transpose": [vp, vp, ll, ll, ll, vp],
                   "geadd": [vp, vp, vp, ctypes.c_double, ctypes.c_double, ll, vp],
                   "genorm_max": [vp, vp, ll, ll, vp]}[kernel]
    fn.restype = ctypes.c_int
    return fn


def _check_tiles(who: str, *stacks: torch.Tensor) -> None:
    """What the tile kernels take: one CUDA device, f32 or bf16, contiguous
    non-empty (k, mb, nb) stacks of one shape."""
    a = stacks[0]
    if a.device.type != "cuda" or any(s.device != a.device for s in stacks):
        raise ValueError(f"{who}: unsupported device {[str(s.device) for s in stacks]}")
    if a.dtype not in _TILE_DTYPES or any(s.dtype != a.dtype for s in stacks):
        raise TypeError(f"{who}: dtype {[s.dtype for s in stacks]} not supported on CUDA "
                        "(f32, bf16, one dtype)")
    if a.dim() != 3 or a.numel() == 0 or any(s.shape != a.shape for s in stacks):
        raise ValueError(f"{who}: need non-empty (k, mb, nb) stacks of one shape, got "
                         f"{[tuple(s.shape) for s in stacks]}")
    if not all(s.is_contiguous() for s in stacks):
        raise ValueError(f"{who}: stacks must be contiguous")


def _launch_tiles(who: str, kernel: str, dtype: torch.dtype, device, *args) -> None:
    fn = _tile_fn(kernel, dtype)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error {rc}")


def transpose_tiles_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`transpose_tiles`: every tile transposed,
    (k, mb, nb) -> (k, nb, mb), as a new contiguous tensor."""
    return a.transpose(-1, -2).contiguous()


def transpose_tiles(a: torch.Tensor) -> torch.Tensor:
    """Batched tile transpose (``transpose_pallas``): (k, mb, nb) ->
    (k, nb, mb).  A CPU tensor takes :func:`transpose_tiles_plain`; a CUDA
    tensor launches ``csrc/tile_ops.cu`` once (``transpose_tiles.launches``)
    or the call raises (a dtype other than f32/bf16, a non-contiguous or
    non-3-D stack)."""
    if a.device.type == "cpu":
        return transpose_tiles_plain(a)
    _check_tiles("transpose_tiles", a)
    k, mb, nb = a.shape
    out = torch.empty((k, nb, mb), dtype=a.dtype, device=a.device)
    _launch_tiles("transpose_tiles", "transpose", a.dtype, a.device,
                  a.data_ptr(), out.data_ptr(), k, mb, nb)
    transpose_tiles.launches += 1
    return out


transpose_tiles.launches = 0


def _rounded(x, dtype: torch.dtype) -> float:
    """A host scalar rounded to ``dtype`` (``jnp.asarray([x], dtype)``),
    returned as the Python float it is exactly."""
    return float(torch.tensor(float(x), dtype=dtype))


def geadd_tiles_plain(alpha, a: torch.Tensor, beta, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`geadd_tiles`: alpha and beta rounded to
    ``a.dtype``, ``alpha a + beta b`` formed in the wider type (f64 for f32,
    f32 for bf16), where both products are exact, and rounded once (other
    dtypes: in their own)."""
    wide = _GEADD_WIDE.get(a.dtype, a.dtype)
    al, be = _rounded(alpha, a.dtype), _rounded(beta, a.dtype)
    return (al * a.to(wide) + be * b.to(wide)).to(a.dtype)


def geadd_tiles(alpha, a: torch.Tensor, beta, b: torch.Tensor) -> torch.Tensor:
    """``alpha A + beta B`` over a (k, mb, nb) tile stack (``geadd_pallas``),
    a new tensor.  A CPU tensor takes :func:`geadd_tiles_plain`; a CUDA
    tensor launches ``csrc/tile_ops.cu`` once (``geadd_tiles.launches``),
    which rounds alpha and beta to the stack's dtype and forms the sum as
    the twin does, or the call raises."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return geadd_tiles_plain(alpha, a, beta, b)
    _check_tiles("geadd_tiles", a, b)
    out = torch.empty_like(a)
    _launch_tiles("geadd_tiles", "geadd", a.dtype, a.device, a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), _rounded(alpha, a.dtype), _rounded(beta, a.dtype), a.numel())
    geadd_tiles.launches += 1
    return out


geadd_tiles.launches = 0


def genorm_max_tiles_plain(a: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`genorm_max_tiles`: ``slate_tpu``'s two stages,
    each tile's column maxima of |a|, then their max; NaN propagates."""
    return a.abs().amax(dim=-2).amax(dim=-1)


def genorm_max_tiles(a: torch.Tensor) -> torch.Tensor:
    """Per-tile max |a| of a (k, mb, nb) stack, (k,) in ``a.dtype``
    (``genorm_max_pallas``); a tile holding a NaN gives NaN.  A CPU tensor
    takes :func:`genorm_max_tiles_plain`; a CUDA tensor launches
    ``csrc/tile_ops.cu`` once (``genorm_max_tiles.launches``) or the call
    raises."""
    if a.device.type == "cpu":
        return genorm_max_tiles_plain(a)
    _check_tiles("genorm_max_tiles", a)
    k, mb, nb = a.shape
    out = torch.empty((k,), dtype=a.dtype, device=a.device)
    _launch_tiles("genorm_max_tiles", "genorm_max", a.dtype, a.device,
                  a.data_ptr(), out.data_ptr(), k, mb * nb)
    genorm_max_tiles.launches += 1
    return out


genorm_max_tiles.launches = 0


# ---------------------------------------------------------------------------
# the blocked GEMM with an f32 accumulator: csrc/matmul.cu
# ---------------------------------------------------------------------------

# the core's dtype codes (matmul.cu's C interface): f32 as three bf16 planes
_MATMUL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the 16-bit form the core reads of each operand dtype
_MATMUL_PLANE_DTYPE = {torch.float32: torch.bfloat16, torch.bfloat16: torch.bfloat16,
                       torch.float16: torch.float16}


class MatmulOperand(NamedTuple):
    """How one operand of :func:`matmul_pallas` reaches the GEMM core, which
    reads 16-bit planes through TMA: ``in_place`` (the tensor as it lies) or
    packed into scratch by ``csrc/matmul.cu``'s pack kernel; ``k_major``
    (k contiguous; False only for a B read in place with n contiguous);
    ``planes`` (3 for f32: x = x0 + x1 + x2 in bf16, else 1), and the row
    stride ``ld`` and plane stride ``plane_stride`` in elements of the form
    the core reads."""

    in_place: bool
    k_major: bool
    planes: int
    ld: int
    plane_stride: int


def _tma_rows(inner: int, outer: int, s_inner: int, s_outer: int, ptr: int) -> Optional[int]:
    """The row stride a TMA tensor map reads a 16-bit (outer, inner) view at,
    inner contiguous: its own if the inner index has stride 1 (or one
    element), the base is 16-byte aligned and the outer stride is a multiple
    of 16 bytes and at least inner (or one row: then any legal stride);
    None if TMA cannot read the view as it lies."""
    if ptr % 16 or not (inner == 1 or s_inner == 1):
        return None
    if outer == 1:
        return -(-inner // 8) * 8
    return s_outer if s_outer % 8 == 0 and s_outer >= inner else None


def matmul_operand_plan(which: str, shape, strides, ptr: int, itemsize: int) -> MatmulOperand:
    """Whether operand ``which`` ("a": (m, k); "b": (k, n)) goes to the GEMM
    core in place or through the pack, as a pure function of the view.

    In place takes a 16-bit operand that a TMA tensor map reads as it lies
    (``_tma_rows``): A with k contiguous; B with k contiguous (K-major) or,
    failing that, n contiguous (MN-major, a row-major B).  Anything else, and
    every f32 operand (split into three bf16 planes), is packed K-major at
    row stride k rounded up to 8 elements (16 bytes), the planes one after
    the other."""
    if which == "a":
        (rows, k), (s_row, s_k) = shape, strides
    elif which == "b":
        (k, rows), (s_k, s_row) = shape, strides
    else:
        raise ValueError(f"matmul_operand_plan: operand 'a' or 'b', got {which!r}")
    if itemsize == 2:
        ld = _tma_rows(k, rows, s_k, s_row, ptr)
        if ld is not None:
            return MatmulOperand(True, True, 1, ld, rows * ld)
        ld = _tma_rows(rows, k, s_row, s_k, ptr) if which == "b" else None
        if ld is not None:
            return MatmulOperand(True, False, 1, ld, k * ld)
    ld = -(-k // 8) * 8
    return MatmulOperand(False, True, 3 if itemsize == 4 else 1, ld, rows * ld)


def _matmul_plan(t: torch.Tensor, which: str) -> MatmulOperand:
    return matmul_operand_plan(which, t.shape, t.stride(), t.data_ptr(), t.element_size())


def _check_matmul(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype not in _MATMUL_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"matmul_pallas: operands must share one of f32, bf16, f16 "
                        f"(the TPU kernel's Mosaic takes no f64 or complex), got "
                        f"{a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul_pallas: need (m, k) @ (k, n), got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")


def matmul_pallas_plain(a: torch.Tensor, b: torch.Tensor, bm: int = 512, bn: int = 512,
                        bk: int = 512) -> torch.Tensor:
    """Plain twin of :func:`matmul_pallas`: both operands zero-padded to the
    block multiples, as ``slate_tpu`` pads, then for each bk block
    ``acc += a_blk.float() @ b_blk.float()`` in f32 (TF32 off), cast to
    ``a.dtype`` and sliced back to (m, n)."""
    _check_matmul(a, b)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = -(-m // bm) * bm, -(-k // bk) * bk, -(-n // bn) * bn
    ap = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m))
    bp = torch.nn.functional.pad(b, (0, np_ - n, 0, kp - k))
    acc = torch.zeros((mp, np_), dtype=torch.float32, device=a.device)
    with _tf32(False):
        for k0 in range(0, kp, bk):
            acc += ap[:, k0:k0 + bk].float() @ bp[k0:k0 + bk].float()
    return acc.to(a.dtype)[:m, :n]


def _matmul_fn(name: str, nargs: str):
    """matmul.cu's ``name``: an int dtype code, then pointers (c_void_p),
    sizes (c_longlong) and flags (c_int) as ``nargs`` gives them ("p" / "i"
    / "f"), then the stream."""
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_longlong, "f": ctypes.c_int}
    fn = getattr(_build.load("matmul"), name)
    fn.argtypes = [ctypes.c_int] + [kinds[x] for x in nargs] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _matmul_rc(rc: int, what: str) -> None:
    if rc != 0:
        cause = ("no CUDA driver found" if rc == -1 else f"tensor map refused, CUresult {-1 - rc}"
                 if rc < 0 else f"CUDA error {rc}")
        raise RuntimeError(f"matmul_pallas: {what} failed: {cause}")


def matmul_pack(t: torch.Tensor, which: str) -> torch.Tensor:
    """The K-major planes of operand ``which`` of a CUDA tensor, as the pack
    kernel writes them: a (planes, rows, ld) tensor of the core's 16-bit
    dtype (rows m for "a", n for "b"; columns k..ld-1 are padding).  One
    launch of the pack kernel, whatever the plan says (the wrapper packs only
    what the plan does not take in place); counted in ``matmul_pack.launches``."""
    k, rows = (t.shape[1], t.shape[0]) if which == "a" else t.shape
    s_row, s_k = (t.stride(0), t.stride(1)) if which == "a" else (t.stride(1), t.stride(0))
    ld = -(-k // 8) * 8
    planes = 3 if t.dtype == torch.float32 else 1
    out = torch.empty((planes, rows, ld), dtype=_MATMUL_PLANE_DTYPE[t.dtype], device=t.device)
    fn = _matmul_fn("matmul_pack", "ppiiiiii")
    with torch.cuda.device(t.device):
        rc = fn(_MATMUL_DTYPES[t.dtype], t.data_ptr(), out.data_ptr(), rows, k, s_row, s_k, ld,
                rows * ld, torch.cuda.current_stream().cuda_stream)
    _matmul_rc(rc, "the pack kernel's launch")
    matmul_pack.launches += 1
    return out


matmul_pack.launches = 0


def matmul_pallas(a: torch.Tensor, b: torch.Tensor, bm: int = 512, bn: int = 512,
                  bk: int = 512) -> torch.Tensor:
    """C = A @ B, products summed in f32, C in ``a.dtype`` (the port of
    ``matmul_pallas``; ``ops.matmul.matmul_pallas`` is the public entry and
    clamps the blocks).  A CPU tensor takes :func:`matmul_pallas_plain`.  A
    CUDA tensor (f32, bf16 or f16, any strides) runs ``csrc/matmul.cu``: the
    pack kernel for each operand :func:`matmul_operand_plan` does not take
    in place, then the GEMM core (f32 as six bf16 plane products), counted
    once per call in ``matmul_pallas.launches`` (its tile is its own; the
    blocks are the twin's), or the call raises."""
    if a.device.type == "cpu":
        return matmul_pallas_plain(a, b, bm, bn, bk)
    _check_matmul(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"matmul_pallas: operands on {a.device} and {b.device}")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c  # nothing to launch, nothing counted
    forms = []  # (tensor the core reads, row stride, plane stride, k-major) of a and b
    for t, which in ((a, "a"), (b, "b")):
        plan = _matmul_plan(t, which)
        if k == 0:
            forms.append((None, 0, 0, True))  # the core reads nothing and writes zeros
        elif plan.in_place:
            forms.append((t, plan.ld, plan.plane_stride, plan.k_major))
        else:
            forms.append((matmul_pack(t, which), plan.ld, plan.plane_stride, True))
    (ta, a_ld, a_ps, _), (tb, b_ld, b_ps, b_k_major) = forms
    fn = _matmul_fn("matmul_core", "piipiifpiii")
    with torch.cuda.device(a.device):
        rc = fn(_MATMUL_DTYPES[a.dtype], ta.data_ptr() if ta is not None else None, a_ld, a_ps,
                tb.data_ptr() if tb is not None else None, b_ld, b_ps, int(not b_k_major),
                c.data_ptr(), m, n, k, torch.cuda.current_stream().cuda_stream)
    _matmul_rc(rc, "the GEMM core's launch")
    matmul_pallas.launches += 1
    return c


matmul_pallas.launches = 0


def matmul_core_smem_bytes(dtype: torch.dtype, k: int) -> int:
    """The GEMM core's dynamic shared memory for ``dtype`` at depth ``k``
    (bytes; the f32 form's stage depth follows k)."""
    fn = _build.load("matmul").matmul_core_smem
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_longlong], ctypes.c_int
    return fn(_MATMUL_DTYPES[dtype], k)
