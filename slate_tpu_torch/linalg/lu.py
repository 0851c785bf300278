"""The LU helpers the mesh LU reads.

Counterpart of the part of ``slate_tpu/linalg/lu.py`` that
``parallel/dist_lu.py`` uses: the no-pivot tile LU (``_nopiv_base``, the
recursive ``_getrf_nopiv_rec`` -- the ``xla`` branch of the mesh panel), the
unblocked partial-pivot panel ``_panel_lu`` and the tournament
``_tournament_reduce`` of the tournament-pivoted mesh LU.  Each keeps
``slate_tpu``'s op sequence; where ``slate_tpu`` maps a function over blocks
with ``vmap``, the port carries a leading batch dim.

The single-chip drivers of ``slate_tpu/linalg/lu.py`` (``getrf_array``,
``gesv_array``, the scan and tournament forms, getri, the band forms) are
not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..blas3.blas3 import _NB, _split, trsm_array
from ..ops.matmul import matmul
from ..types import Diag, Op, Side, Uplo

_PANEL_W = 64  # unblocked panel width (reference ib, enums InnerBlocking)


def _nopiv_base(a: torch.Tensor) -> torch.Tensor:
    """Unblocked no-pivot LU (packed L\\U) by the column loop; a zero
    pivot divides by 1, as in ``slate_tpu``."""
    m, n = a.shape
    rows = torch.arange(m, device=a.device)
    cols = torch.arange(n, device=a.device)
    a = a.clone()
    for j in range(min(m, n)):
        piv = a[j, j]
        denom = torch.where(piv == 0, torch.ones_like(piv), piv)
        below = (rows > j).to(a.dtype)
        lcol = a[:, j] / denom * below
        a[:, j] = a[:, j] * (1 - below) + lcol
        cmask = (cols > j).to(a.dtype)
        a = a - torch.outer(lcol, a[j] * cmask)
    return a


def _getrf_nopiv_rec(a: torch.Tensor) -> torch.Tensor:
    """Recursive no-pivot LU of a square block (packed L\\U, unit L)."""
    n = min(a.shape)
    if n <= _NB:
        return _nopiv_base(a)
    h = _split(n)
    a11, a12, a21, a22 = a[:h, :h], a[:h, h:], a[h:, :h], a[h:, h:]
    lu11 = _nopiv_base(a11) if h <= _NB else _getrf_nopiv_rec(a11)
    u12 = trsm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.Unit, 1.0, lu11, a12)
    l21 = trsm_array(Side.Right, Uplo.Upper, Op.NoTrans, Diag.NonUnit, 1.0, lu11, a21)
    s = a22 - matmul(l21, u12).to(a.dtype)
    lu22 = _getrf_nopiv_rec(s)
    return torch.cat([torch.cat([lu11, u12], dim=1), torch.cat([l21, lu22], dim=1)], dim=0)


def _panel_lu(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Partial-pivot LU of a batch of (m, w) panels, (..., m, w) -> (lu,
    perm (..., m)).  Per column: the first largest |a| at or below the
    diagonal (argmax), a full-row swap, multipliers scaled by the pivot (a
    zero pivot divides by 1) and a rank-1 update of the columns right of
    it.  Only min(m, w) steps exist."""
    lead = a.shape[:-2]
    m, w = a.shape[-2:]
    a = a.reshape(-1, m, w).clone()
    bsz = a.shape[0]
    rows = torch.arange(m, device=a.device)
    cols = torch.arange(w, device=a.device)
    bidx = torch.arange(bsz, device=a.device)
    perm = rows.expand(bsz, m).clone()
    neg_inf = torch.tensor(float("-inf"), dtype=a.dtype, device=a.device)
    for j in range(min(m, w)):
        col = torch.where(rows >= j, a[:, :, j].abs(), neg_inf)
        p = torch.argmax(col, dim=-1)  # (B,): the first maximum
        rj, rp = a[:, j].clone(), a[bidx, p].clone()
        a[:, j] = rp
        a[bidx, p] = rj  # p == j: the same row back
        pj, pp = perm[:, j].clone(), perm[bidx, p].clone()
        perm[:, j] = pp
        perm[bidx, p] = pj
        piv = a[:, j, j]
        denom = torch.where(piv == 0, torch.ones_like(piv), piv)
        below = (rows > j).to(a.dtype)
        lcol = a[:, :, j] / denom[:, None] * below
        a[:, :, j] = a[:, :, j] * (1 - below) + lcol
        cmask = (cols > j).to(a.dtype)
        a = a - lcol[:, :, None] * (a[:, j] * cmask)[:, None, :]
    return a.reshape(*lead, m, w), perm.reshape(*lead, m)


def _tournament_reduce(ap: torch.Tensor, idx: torch.Tensor, w: int, sentinel: int):
    """Binary-tree reduction of pivot candidates, batched over a leading
    dim: ``ap`` (B, rows, w) with invalid rows zeroed, ``idx`` (B, rows)
    their ids (``sentinel`` for invalid ones).  Small partial-pivot LUs
    pick the w best rows per block of max(2w, 64) rows, pairs of blocks
    merge until one is left.  Returns the (B, w, w) values and (B, w) ids
    of the winners."""
    bsz, mp, _ = ap.shape
    block = max(2 * w, _PANEL_W)
    nblk = -(-mp // block)
    pad = nblk * block - mp
    ap = torch.nn.functional.pad(ap, (0, 0, 0, pad))
    idx = torch.nn.functional.pad(idx, (0, pad), value=sentinel)
    tops_a = ap.reshape(bsz, nblk, block, w)
    tops_i = idx.reshape(bsz, nblk, block)

    def local_top(a_blk, i_blk):
        _, p = _panel_lu(a_blk)
        return (torch.take_along_dim(a_blk, p[..., None], dim=-2)[..., :w, :],
                torch.take_along_dim(i_blk, p, dim=-1)[..., :w])

    tops_a, tops_i = local_top(tops_a, tops_i)
    while tops_a.shape[1] > 1:
        k = tops_a.shape[1]
        if k % 2 == 1:  # odd: pad a dead block
            tops_a = torch.cat([tops_a, tops_a[:, -1:] * 0], dim=1)
            tops_i = torch.cat([tops_i, torch.full_like(tops_i[:, -1:], sentinel)], dim=1)
            k += 1
        tops_a, tops_i = local_top(tops_a.reshape(bsz, k // 2, 2 * w, w),
                                   tops_i.reshape(bsz, k // 2, 2 * w))
    return tops_a[:, 0], tops_i[:, 0]
