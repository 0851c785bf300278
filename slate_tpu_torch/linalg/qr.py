"""QR / LQ factorization and least squares.

Counterpart of ``slate_tpu/linalg/qr.py`` (the reference's
``src/{geqrf,gelqf,unmqr,unmlq,cholqr,gels,gels_qr,gels_cholqr}.cc``):
recursive compact-WY QR (Elmroth-Gustavson: factor the left half, apply
``I - Y T Y^H`` to the right half with three products, recurse, merge the T
blocks), the scanned form over fixed-width offset panels, LQ through the QR
of A^H, CholeskyQR, and the least-squares drivers.

The unblocked panels are ``slate_tpu``'s Householder loops op for op
(``_panel_qr``, ``_panel_qr_offset``, LAPACK larfg/larf semantics,
complex-safe) with the larft T builders (``_larft``, ``_larft_v``); they
live in ``ops.kernels`` beside the kernel wrappers they are the twins of.
Under ``Option.PanelImpl`` ``pallas``/``auto`` a real panel goes through
``ops.kernels.qr_panel`` / ``qr_panel_offset``: the hand-written kernel
``csrc/qr_panel.cu`` on a CUDA tensor, the plain pair on a CPU tensor; a
bf16/f16 panel is factored in f32 and cast back.  ``xla`` and complex
panels take the plain pair on every device (``slate_tpu``'s Pallas gate
refuses complex too).

Factors are packed LAPACK-style: V below the diagonal (unit first element
implicit), R on and above; plus the upper-triangular T with
Q = I - V T V^H.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..obs.span import instrument
from ..blas3.blas3 import trsm_array
from ..core.matrix import tri_project
from ..ops.kernels import (
    panel_engaged,
    qr_panel,
    qr_panel_offset,
    qr_panel_offset_plain,
    qr_panel_plain,
)
from ..ops.matmul import matmul
from ..types import Diag, MethodGels, Op, Option, Options, Side, SlateError, Uplo, get_option

_QR_PANEL = 64


class QRFactors(NamedTuple):
    """Packed QR: ``vr`` has V below diag / R above; ``t`` is the WY
    accumulator, upper triangular (n, n): Q = I - V T V^H."""

    vr: torch.Tensor
    t: torch.Tensor


class LQFactors(NamedTuple):
    """Packed LQ: ``lv`` has L on/below diag, V^H above (rows are
    reflectors); ``t`` as in QR for the transposed problem."""

    lv: torch.Tensor
    t: torch.Tensor


_LOW = (torch.bfloat16, torch.float16)  # panels the kernel runs in f32


def _panel_qr_t(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed VR, tau, T) of one panel (or a batch): ``ops.kernels.qr_panel``
    when ``Option.PanelImpl`` engages (the kernel on a CUDA tensor; a
    bf16/f16 panel is factored in f32 and cast back, as the mesh Cholesky
    and LU panels are), else its twin, the ``_panel_qr`` + ``_larft`` pair."""
    if not panel_engaged(a.dtype):
        return qr_panel_plain(a)
    if a.dtype in _LOW:
        return tuple(x.to(a.dtype) for x in qr_panel(a.float()))
    return qr_panel(a)


def _panel_qr_offset_t(a: torch.Tensor, row0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(r, v, tau, T) of one offset-pivot panel, or of a (B, m, w) batch
    with B offsets: ``ops.kernels.qr_panel_offset`` when ``Option.PanelImpl``
    engages (half precision in f32, as :func:`_panel_qr_t`), else its twin,
    ``_panel_qr_offset`` + ``_larft_v`` per panel."""
    if not panel_engaged(a.dtype):
        return qr_panel_offset_plain(a, row0)
    if a.dtype in _LOW:
        return tuple(x.to(a.dtype) for x in qr_panel_offset(a.float(), row0))
    return qr_panel_offset(a, row0)


def _v_of(vr: torch.Tensor, k: Optional[int] = None) -> torch.Tensor:
    """Extract unit-lower V from packed storage (first k reflectors)."""
    m, n = vr.shape
    k = n if k is None else k
    rows = torch.arange(m, device=vr.device)[:, None]
    cols = torch.arange(k, device=vr.device)[None, :]
    block = vr[:, :k]
    return torch.where(rows > cols, block, torch.where(rows == cols, torch.ones_like(block),
                                                       torch.zeros_like(block)))


def _split_qr(n: int) -> int:
    h = _QR_PANEL
    while h * 2 < n:
        h *= 2
    return h


def _geqrf_rec(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive blocked QR. Returns (packed VR, T)."""
    m, n = a.shape
    if n <= _QR_PANEL:
        vr, _, t = _panel_qr_t(a)
        return vr, t
    h = _split_qr(n)
    vr1, t1 = _geqrf_rec(a[:, :h])
    v1 = _v_of(vr1)
    # apply Q1^H to the right block: A2 -= V1 T1^H V1^H A2
    a2 = a[:, h:]
    w = matmul(v1.conj().T, a2)
    a2 = a2 - matmul(v1, matmul(t1.conj().T, w)).to(a.dtype)
    del w
    r12, a2b = a2[:h], a2[h:]
    vr2, t2 = _geqrf_rec(a2b)
    v2 = torch.cat([torch.zeros((h, a2b.shape[1]), dtype=a.dtype, device=a.device), _v_of(vr2)], dim=0)
    # merged T: [[T1, -T1 (V1^H V2) T2], [0, T2]]
    t12 = -matmul(t1, matmul(matmul(v1.conj().T, v2), t2)).to(a.dtype)
    del v1, v2
    nt = h + t2.shape[0]
    t = torch.zeros((nt, nt), dtype=a.dtype, device=a.device)
    t[:h, :h] = t1
    t[:h, h:] = t12
    t[h:, h:] = t2
    top = torch.cat([vr1[:h], r12], dim=1)
    bot = torch.cat([vr1[h:], vr2], dim=1)
    return torch.cat([top, bot], dim=0), t


@instrument("geqrf_array")
def geqrf_array(a: torch.Tensor) -> QRFactors:
    """slate::geqrf (src/geqrf.cc) -- A = Q R."""
    vr, t = _geqrf_rec(a)
    return QRFactors(vr, t)


class QRScanFactors(NamedTuple):
    """Scanned QR: R in ``r`` (upper), stacked per-panel global-coordinate
    reflectors ``v`` (K, mp, nb) + WY accumulators ``t`` (K, nb, nb)."""

    r: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    nb: int


def geqrf_scan_array(a: torch.Tensor, nb: int = _QR_PANEL) -> QRScanFactors:
    """The scanned QR: one loop over fixed-width panels.  Per panel: the
    offset-pivot Householder QR of the masked full-height block column
    (``_panel_qr_offset_t``), then one global compact-WY update of the
    trailing columns."""
    m, n = a.shape
    if m < n:
        raise ValueError(f"geqrf_scan_array requires m >= n, got {tuple(a.shape)}")
    nblocks = -(-n // nb)
    mp = max(m, (nblocks + 1) * nb)
    np_ = max(n, (nblocks + 1) * nb)
    ap = torch.nn.functional.pad(a, (0, np_ - n, 0, mp - m))
    rows = torch.arange(mp, device=a.device)
    cols = torch.arange(np_, device=a.device)
    vs = torch.zeros((nblocks, mp, nb), dtype=a.dtype, device=a.device)
    ts = torch.zeros((nblocks, nb, nb), dtype=a.dtype, device=a.device)
    for k in range(nblocks):
        j0, j1 = k * nb, k * nb + nb
        colblk = ap[:, j0:j1]
        masked = torch.where((rows >= j0)[:, None], colblk, 0)
        r_a, v, _tau, t = _panel_qr_offset_t(masked, j0)
        w1 = matmul(v.conj().T, ap)
        upd = matmul(v, matmul(t.conj().T, w1)).to(ap.dtype)
        ap = ap - upd * (cols >= j1)[None, :].to(ap.dtype)
        ap[:, j0:j1] = torch.where((rows >= j0)[:, None], r_a, colblk)
        vs[k] = v
        ts[k] = t
    return QRScanFactors(tri_project(ap[:m, :n], Uplo.Upper), vs, ts, nb)


def unmqr_scan_array(f: QRScanFactors, c: torch.Tensor, op: Op = Op.NoTrans) -> torch.Tensor:
    """Apply Q (or Q^H) from scanned factors: a loop over the panel stack,
    each step three products."""
    if op == Op.Trans and f.v.is_complex():
        raise SlateError("unmqr_scan: Op.Trans unsupported for complex")
    nsteps, mp, _ = f.v.shape
    n0 = c.shape[0]
    cp = torch.nn.functional.pad(c, (0, 0) * (c.dim() - 1) + (0, mp - n0))
    adjoint = op != Op.NoTrans
    for i in range(nsteps):
        k = i if adjoint else nsteps - 1 - i
        v, t = f.v[k], f.t[k]
        t = t.conj().T if adjoint else t
        cp = cp - matmul(v, matmul(t, matmul(v.conj().T, cp))).to(cp.dtype)
    return cp[:n0]


def unmqr_array(side: Side, op: Op, f: QRFactors, c: torch.Tensor) -> torch.Tensor:
    """Apply Q / Q^H from geqrf factors (src/unmqr.cc): 3 products.
    Op.Trans on complex factors is undefined for compact-WY (LAPACK unmqr
    allows only 'N'/'C' for complex) and raises."""
    if op == Op.Trans and f.vr.is_complex():
        raise SlateError("unmqr: Op.Trans unsupported for complex; use ConjTrans")
    v = _v_of(f.vr, f.t.shape[0])
    t = f.t if op == Op.NoTrans else f.t.conj().T
    c = torch.as_tensor(c, device=v.device)
    if side == Side.Left:
        w = matmul(v.conj().T, c)
        return c - matmul(v, matmul(t, w)).to(c.dtype)
    w = matmul(c, v)
    return c - matmul(matmul(w, t), v.conj().T).to(c.dtype)


def qr_multiply_by_q(f: QRFactors, c: torch.Tensor, side: Side = Side.Left,
                     op: Op = Op.NoTrans) -> torch.Tensor:
    return unmqr_array(side, op, f, c)


def geqrf_r(f: QRFactors) -> torch.Tensor:
    """Extract R (min(m,n) x n upper triangular)."""
    n = f.vr.shape[1]
    return tri_project(f.vr[: min(f.vr.shape[0], n)], Uplo.Upper)


def geqrf_q(f: QRFactors, full: bool = False) -> torch.Tensor:
    """Materialize Q -- thin (m, k) by default."""
    m = f.vr.shape[0]
    k = f.t.shape[0] if not full else m
    eye = torch.eye(m, k, dtype=f.vr.dtype, device=f.vr.device)
    return unmqr_array(Side.Left, Op.NoTrans, f, eye)


# ---------------------------------------------------------------------------
# LQ (src/gelqf.cc, unmlq.cc): A = L Q via QR of A^H
# ---------------------------------------------------------------------------


def gelqf_array(a: torch.Tensor) -> LQFactors:
    """slate::gelqf -- A = L Q.  QR of A^H gives A^H = Qr R, so
    A = R^H Qr^H: L = R^H and the LQ reflectors are the QR reflectors
    conjugate-transposed."""
    f = geqrf_array(a.conj().T)
    return LQFactors(f.vr.conj().T, f.t)


def unmlq_array(side: Side, op: Op, f: LQFactors, c: torch.Tensor) -> torch.Tensor:
    """Apply Q from gelqf: Q_lq^H = Qr, so multiply by Qr with the op
    flipped.  Op.Trans on a complex factor raises (LAPACK unmlq defines
    only 'N'/'C' for complex)."""
    if op == Op.Trans and f.lv.is_complex():
        raise SlateError("unmlq: Op.Trans unsupported for complex; use ConjTrans")
    qr_f = QRFactors(f.lv.conj().T, f.t)
    flip = {Op.NoTrans: Op.ConjTrans, Op.ConjTrans: Op.NoTrans, Op.Trans: Op.NoTrans}[op]
    return unmqr_array(side, flip, qr_f, c)


def gelqf_l(f: LQFactors) -> torch.Tensor:
    m = f.lv.shape[0]
    return tri_project(f.lv[:, : min(m, f.lv.shape[1])], Uplo.Lower)


# ---------------------------------------------------------------------------
# CholeskyQR (src/cholqr.cc, MethodCholQR)
# ---------------------------------------------------------------------------


def cholqr_array(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Q, R with R from the Cholesky factor of the Gram matrix
    (A^H A = R^H R): one herk, one potrf, one trsm."""
    from .chol import potrf_array

    g = matmul(a.conj().T, a).to(a.dtype)
    u, _info = potrf_array(g, Uplo.Upper)
    q = trsm_array(Side.Right, Uplo.Upper, Op.NoTrans, Diag.NonUnit, 1.0, u, a)
    return q, u


# ---------------------------------------------------------------------------
# Least squares (src/gels.cc, gels_qr.cc, gels_cholqr.cc)
# ---------------------------------------------------------------------------


@instrument("gels_array")
def gels_array(a: torch.Tensor, b: torch.Tensor, opts: Optional[Options] = None) -> torch.Tensor:
    """Least-squares / minimum-norm solve of A X ~= B (src/gels.cc).
    m >= n: QR (or CholeskyQR under ``Option.MethodGels``); m < n: the
    minimum-norm solution via LQ."""
    m, n = a.shape
    b = torch.as_tensor(b, device=a.device)
    method = get_option(opts, Option.MethodGels, MethodGels.QR)
    if m >= n:
        if method == MethodGels.CholQR:
            q, r = cholqr_array(a)
            y = matmul(q.conj().T, b).to(b.dtype)
            return trsm_array(Side.Left, Uplo.Upper, Op.NoTrans, Diag.NonUnit, 1.0, r, y)
        f = geqrf_array(a)
        qhb = unmqr_array(Side.Left, Op.ConjTrans, f, b)
        r = f.vr[:n]
        return trsm_array(Side.Left, Uplo.Upper, Op.NoTrans, Diag.NonUnit, 1.0, r, qhb[:n])
    # minimum norm: A = L Q, x = Q^H L^-1 b
    f = gelqf_array(a)
    l = f.lv[:, :m]
    y = trsm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.NonUnit, 1.0, l, b)
    ypad = torch.cat([y, torch.zeros((n - m,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)])
    return unmlq_array(Side.Left, Op.ConjTrans, f, ypad)


def gels_qr_array(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gels_array(a, b, {Option.MethodGels: MethodGels.QR})


def gels_cholqr_array(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gels_array(a, b, {Option.MethodGels: MethodGels.CholQR})
