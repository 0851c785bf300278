"""LU family of the port: getrf (partial pivot, scanned, no-pivot,
tournament), getrs, gesv, getri and the band drivers gbtrf / gbtrs / gbsv.

Counterpart of ``slate_tpu/linalg/lu.py``.  Each form keeps ``slate_tpu``'s op sequence and pivot
rule (the first largest |a| at or below the diagonal; a zero pivot divides
by 1), so pivots and info codes are ``slate_tpu``'s; where ``slate_tpu``
maps a function over blocks with ``vmap``, the port carries a leading batch
dim.  PyTorch runs eagerly, so ``fori_loop``s become Python loops, blocks
are written into preallocated tensors in place of ``jnp.concatenate`` /
``jnp.block``, and the row swaps of the scanned forms are simulated on the
host from one small device-to-host copy of the panel's pivots per step.

``getrf_array`` picks its form as ``slate_tpu`` does, with a CUDA tensor in
the place of a TPU backend (the reading ``Option.PanelImpl=auto`` makes):

- a CUDA tensor, f64 or c128, square with 4096 <= n <= 8192:
  :func:`_getrf_left_looking` (nb = 2048 panels, all-gemm recursive panel
  LUs with their unit-L inverses);
- a CUDA tensor, f64 or c128, square with n > 8192: :func:`getrf_scan_array`
  (64-wide panels over four shrinking trailing views);
- everything else, and every CPU tensor: the recursive :func:`_getrf_rec`
  with 64-wide :func:`_panel_lu` leaves.

``gbsv_array`` routes a narrow band (4 (max(kl, 1) + max(ku, 1)) <= n) to
the windowed ``linalg.band.gbsv_band``, whose factor carries per-window
permutations, and a wide one to the dense partial-pivot factor of the
band-projected operand (``gbtrf_array``).

The mesh LU (``parallel/dist_lu.py``) reads ``_getrf_nopiv_rec`` (the
``xla`` branch of its panel), ``_panel_lu`` and ``_tournament_reduce``;
the windowed band LU reads ``_panel_lu_masked``, ``_swaps_to_perm`` and
``_apply_bounded_perm``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..blas3.blas3 import _NB, _arr, _split, solve_tri, split_pow2, trsm_array
from ..core.matrix import BaseMatrix, Matrix, band_project, operand_device, tri_project
from ..ops.matmul import matmul, matmul_sub_
from ..types import Diag, MethodLU, Op, Option, Options, Side, Uplo, get_option

ArrayLike = Union[torch.Tensor, BaseMatrix]

_PANEL_W = 64  # unblocked panel width (reference ib, enums InnerBlocking)
_GETRF_LL_MIN_N = 4096  # f64/c128 on the card: left-looking from here ...
_GETRF_LL_MAX_N = 8192  # ... up to here; the scanned form above (slate_tpu's bounds)


class LUFactors(NamedTuple):
    """Packed LU: unit-lower L below the diagonal, U on and above; ``perm``
    applied to the rows (PA = LU: row i of PA is row perm[i] of A);
    ``info`` = 1 + the first zero or non-finite pivot, else 0 (int32)."""

    lu: torch.Tensor
    perm: torch.Tensor
    info: torch.Tensor


class _StepMasks(NamedTuple):
    """The per-column masks of an unblocked LU loop over an (m, w) panel,
    made once per panel (one eager op each per step otherwise): row j of
    each table is step j's.  slate_tpu multiplies by the 0/1 masks, which
    XLA turns into selects (a NaN outside the mask is dropped), so the loops
    select with ``below`` and ``right``; ``keep`` (1 - below, in the
    panel's dtype) stays a multiply, as there."""

    at_or_below: torch.Tensor  # (steps, m): rows >= j
    below: torch.Tensor  # (steps, m): rows > j
    keep: torch.Tensor  # (steps, m): 1 - (rows > j)
    right: torch.Tensor  # (steps, w): columns > j


def _step_masks(m: int, w: int, steps: int, first: int, dtype: torch.dtype, device
                ) -> _StepMasks:
    """Masks for steps j = 0 .. steps - 1, whose pivot row is first + j."""
    gi = first + torch.arange(steps, device=device)[:, None]
    rows = torch.arange(m, device=device)[None, :]
    below = rows > gi
    return _StepMasks(rows >= gi, below, (~below).to(dtype),
                      torch.arange(w, device=device)[None, :] > gi - first)


def _eliminate(a: torch.Tensor, j: int, gi: int, masks: _StepMasks) -> torch.Tensor:
    """One elimination step on (..., m, w) panels whose pivot a[..., gi, j]
    is in place: multipliers below the pivot (a zero pivot divides by 1),
    then the rank-1 update of the columns right of j.  Returns the new
    panels (column j is written in place first)."""
    piv = a[..., gi, j]
    denom = torch.where(piv == 0, 1, piv)
    col = a[..., :, j]
    lcol = torch.where(masks.below[j], col / denom[..., None], 0)
    col.mul_(masks.keep[j]).add_(lcol)
    urow = torch.where(masks.right[j], a[..., gi, :], 0)
    return a - lcol[..., :, None] * urow[..., None, :]


def _nopiv_base(a: torch.Tensor) -> torch.Tensor:
    """Unblocked no-pivot LU (packed L\\U) by the column loop; a zero
    pivot divides by 1, as in ``slate_tpu``."""
    m, n = a.shape
    steps = min(m, n)
    masks = _step_masks(m, n, steps, 0, a.dtype, a.device)
    a = a.clone()
    for j in range(steps):
        a = _eliminate(a, j, j, masks)
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
    steps = min(m, w)
    masks = _step_masks(m, w, steps, 0, a.dtype, a.device)
    ident = torch.arange(m, device=a.device).expand(bsz, m)
    perm = ident.clone()
    # the sentinel in the real dtype of |a|: a complex one would promote
    # |a| back to complex, which argmax refuses
    neg_inf = torch.tensor(float("-inf"), dtype=a.real.dtype, device=a.device)
    for j in range(steps):
        col = torch.where(masks.at_or_below[j], a[:, :, j].abs(), neg_inf)
        p = torch.argmax(col, dim=-1, keepdim=True)  # (B, 1): the first maximum
        # swap rows j and p (p == j: no move) as one gather of a and of perm
        swap = ident.clone()
        swap[:, j] = p[:, 0]
        swap.scatter_(1, p, j)
        a = a.gather(1, swap[:, :, None].expand(bsz, m, w))
        perm = perm.gather(1, swap)
        a = _eliminate(a, j, j, masks)
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


def _window(x: torch.Tensor, r0: int, c0: int, h: int, w: int) -> torch.Tensor:
    """x[r0:r0+h, c0:c0+w], refusing a short window: torch slicing never
    clamps like ``lax.dynamic_slice`` does, it returns fewer rows or
    columns, so the scanned forms pad and every panel slice is checked."""
    out = x[r0:r0 + h, c0:c0 + w]
    if out.shape != (h, w):
        raise RuntimeError(f"LU panel window ({r0}:{r0 + h}, {c0}:{c0 + w}) of a "
                           f"{tuple(x.shape)} matrix is {tuple(out.shape)}")
    return out


def _lu_info(lu: torch.Tensor) -> torch.Tensor:
    """0, or 1 + the index of the first zero or non-finite diagonal entry."""
    d = lu.diagonal()
    bad = (d == 0) | ~torch.isfinite(d)
    first = bad.to(torch.int8).argmax()  # argmax takes no bool: the first True
    return torch.where(bad.any(), first + 1, 0).to(torch.int32)


# ---------------------------------------------------------------------------
# recursive blocked LU (partial pivoting)
# ---------------------------------------------------------------------------


def _split_panel(n: int) -> int:
    return split_pow2(n, _PANEL_W)


def _getrf_rec(a: torch.Tensor, out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recursive LU of (m, n), m >= n: factor the left half, gather the
    right half's rows by its pivots, solve U12, one gemm on the trailing
    block, recurse, and gather L21 by the trailing pivots.  Returns (lu,
    perm).  ``slate_tpu`` concatenates the blocks at every level; here the
    factor is written into ``out`` ((m, n), allocated when None) and each
    level keeps only its gathered right half, so the peak stays near two
    copies of A plus half of one."""
    m, n = a.shape
    if out is None:
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if n <= _PANEL_W:
        lu, perm = _panel_lu(a)
        out.copy_(lu)
        return out, perm
    h = _split_panel(n)
    lu1 = out[:, :h]
    _, p1 = _getrf_rec(a[:, :h], lu1)
    a2 = a[:, h:][p1]  # this level's own copy of the right half
    u12 = trsm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.Unit, 1.0, lu1[:h], a2[:h])
    out[:h, h:] = u12
    s = a2[h:]
    matmul_sub_(s, lu1[h:], u12)
    _, p2 = _getrf_rec(s, out[h:, h:])
    out[h:, :h] = lu1[h:][p2]
    return out, torch.cat([p1[:h], p1[h:][p2]])


def _getrf_rec_inv(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recursive LU of (m, w), m >= w, that also returns inv(unit L11): the
    U12 solve is a gemm against the left child's unit-L inverse and the
    combined inverse is assembled blockwise (i21 = -i22 L21 i11), so every
    O(m w^2) flop is a gemm.  The left-looking form's panel."""
    m, w = a.shape
    if w <= _PANEL_W:
        lu, perm = _panel_lu(a)
        l11 = lu[:w].tril(-1) + torch.eye(w, dtype=a.dtype, device=a.device)
        if a.dtype == torch.float64:
            linv = _unit_linv_f64(l11)
        else:
            eye = torch.eye(w, dtype=a.dtype, device=a.device)
            linv = solve_tri(l11, eye, upper=False, unitriangular=True)
        return lu, perm, linv
    h = _split_panel(w)
    lu1, p1, i1 = _getrf_rec_inv(a[:, :h])
    a2 = a[:, h:][p1]
    u12 = matmul(i1, a2[:h]).to(a.dtype)
    s = a2[h:]
    matmul_sub_(s, lu1[h:, :h], u12)
    lu2, p2, i2 = _getrf_rec_inv(s)
    l21 = lu1[h:, :h][p2]
    lu = torch.empty((m, w), dtype=a.dtype, device=a.device)
    lu[:h, :h], lu[:h, h:] = lu1[:h], u12
    lu[h:, :h], lu[h:, h:] = l21, lu2
    linv = torch.zeros((w, w), dtype=a.dtype, device=a.device)
    linv[:h, :h], linv[h:, h:] = i1, i2
    linv[h:, :h] = -matmul(i2, matmul(l21[:w - h], i1).to(a.dtype)).to(a.dtype)
    return lu, torch.cat([p1[:h], p1[h:][p2]]), linv


def _unit_linv_f64(l11: torch.Tensor) -> torch.Tensor:
    """inv(unit-lower L) of a small f64 block, ``slate_tpu``'s leaf: the f32
    triangular solve as a seed, two Newton sweeps X <- X (2I - L X) in f64,
    and a residual gate that takes the exact f64 solve when the seed failed
    (one host sync: ``lax.cond`` becomes a Python branch)."""
    w = l11.shape[0]
    dt = l11.dtype
    eye = torch.eye(w, dtype=dt, device=l11.device)
    x32 = torch.linalg.solve_triangular(l11.to(torch.float32), eye.to(torch.float32),
                                        upper=False, unitriangular=True)
    x = torch.where(torch.isfinite(x32), x32, 0).to(dt)
    for _ in range(2):
        x = x @ (2.0 * eye - l11 @ x)
    resid = torch.linalg.norm(eye - l11 @ x)
    tol = 1e3 * w * torch.finfo(dt).eps * torch.linalg.norm(x) * torch.linalg.norm(l11)
    if bool(torch.isfinite(resid) & (resid <= tol)):
        return x.tril()
    return torch.linalg.solve_triangular(l11, eye, upper=False, unitriangular=True)


def _getrf_left_looking(a: torch.Tensor, nb: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-looking blocked partial-pivot LU (the f64 form on the card).
    Per panel: the U rows above it by blocked forward substitution (gemms
    against the cached unit-L inverses of the factored diagonal blocks),
    one large-k Schur gemm for the rows below, the all-gemm recursive panel
    LU, then the panel's row permutation applied to the factored history
    and the trailing columns in one row gather.  Works in place on one
    padded copy (a unit diagonal in the pad).  Returns (lu, perm)."""
    m, n = a.shape
    if nb is None:
        nb = 4096 if n >= 16384 else 2048
    if n <= nb or m != n:
        return _getrf_rec(a)
    nsteps = -(-n // nb)
    np_ = nsteps * nb
    if np_ == n:
        ap = a.clone()
    else:
        ap = torch.zeros((np_, np_), dtype=a.dtype, device=a.device)
        ap[:n, :n] = a
        ap.diagonal()[n:] = 1
    perm = torch.arange(np_, device=a.device)
    linvs = []  # the unit-L inverses of the factored diagonal blocks
    for j in range(nsteps):
        r0 = j * nb
        panel = ap[:, r0:r0 + nb]
        if j:
            for k in range(j):  # the U rows above the panel, written in place
                k0 = k * nb
                bk = panel[k0:k0 + nb]
                if k:
                    matmul_sub_(bk, ap[k0:k0 + nb, :k0], panel[:k0])
                bk.copy_(matmul(linvs[k], bk).to(ap.dtype))
            matmul_sub_(panel[r0:], ap[r0:, :r0], panel[:r0])
        lu_p, pv, linv = _getrf_rec_inv(panel[r0:])
        linvs.append(linv)
        # only rows r0: move; lu_p is already in their pivoted order
        ap[r0:] = ap[r0:][pv]
        perm[r0:] = perm[r0:][pv]
        ap[r0:, r0:r0 + nb] = lu_p
    return ap[:n, :n], perm[:n]


def getrf_array(a: torch.Tensor) -> LUFactors:
    """Partial-pivot LU, PA = LU (src/getrf.cc); the form by the module
    doc's dispatch rule."""
    n = a.shape[0]
    if (a.is_cuda and a.dtype in (torch.float64, torch.complex128) and a.dim() == 2
            and a.shape[1] == n >= _GETRF_LL_MIN_N):
        if n > _GETRF_LL_MAX_N:
            return getrf_scan_array(a)
        lu, perm = _getrf_left_looking(a)
        return LUFactors(lu, perm, _lu_info(lu))
    lu, perm = _getrf_rec(a)
    return LUFactors(lu, perm, _lu_info(lu))


# ---------------------------------------------------------------------------
# the scanned form: fixed-width panels over shrinking trailing views
# ---------------------------------------------------------------------------


def _swaps_to_perm(piv: np.ndarray, kk: int, m: int) -> np.ndarray:
    """The permutation vector of a panel's swap sequence: piv[j] is the row
    swapped with row kk + j at step j (LAPACK ipiv, 0-based)."""
    pv = np.arange(m)
    for j, p in enumerate(piv):
        gi = kk + j
        pv[gi], pv[p] = pv[p], pv[gi]
    return pv


def _apply_bounded_perm(x: torch.Tensor, pv: np.ndarray, targets: np.ndarray) -> None:
    """x = x[pv] in place, where pv differs from the identity only at
    ``targets``: gathers and scatters those rows (at most 2 nb) only."""
    t = np.unique(targets)
    src = torch.from_numpy(pv[t]).to(x.device)
    x[torch.from_numpy(t).to(x.device)] = x[src]


def _panel_lu_masked(panel: torch.Tensor, kk: int, nmin: int, m_true: int,
                     pivot: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """LU of the full-height panel columns [kk, kk + nb) with rows < kk
    frozen; returns (factored panel, the pivot row per column as a device
    tensor).  Rows >= m_true are padding.  A zero column keeps its row in
    place (p = kk + j, LAPACK's keep-in-place zero pivot).  Steps with
    kk + j >= nmin are masked off in ``slate_tpu`` (no swap, all-zero
    multipliers); here they are skipped.  ``pivot=False``: no interchanges
    (the tournament's pre-pivoted panels)."""
    mp, nb = panel.shape
    dev = panel.device
    pan = panel.clone()
    steps = max(0, min(nb, nmin - kk))
    masks = _step_masks(mp, nb, steps, kk, pan.dtype, dev)
    valid = masks.at_or_below & (torch.arange(mp, device=dev) < m_true)
    piv = kk + torch.arange(nb, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=pan.real.dtype, device=dev)
    for j in range(steps):
        gi = kk + j
        if pivot:
            mag = torch.where(valid[j], pan[:, j].abs(), neg_inf)
            p = torch.argmax(mag).view(1)  # (1,): index without a host sync
            p = torch.where(mag.gather(0, p) > 0, p, gi)
            r_gi, r_p = pan[gi].clone(), pan.index_select(0, p)[0]
            pan[gi] = r_p
            pan.index_copy_(0, p, r_gi[None])
            piv[j:j + 1] = p
        pan = _eliminate(pan, j, gi, masks)
    return pan, piv


def _scan_step_update(out: torch.Tensor, pan: torch.Tensor, perm: torch.Tensor,
                      piv: np.ndarray, kk: int, nb: int, pv: Optional[np.ndarray] = None) -> None:
    """One scanned panel step, in place on ``out`` and ``perm``: the panel's
    row swaps (a bounded gather/scatter), the factored panel written back,
    the U row block by an explicit unit-L inverse gemm, and the masked
    full-width trailing gemm."""
    mp, n = out.shape
    dev = out.device
    if pv is None:
        pv = _swaps_to_perm(piv, kk, mp)
    targets = np.concatenate([kk + np.arange(nb), piv])
    _apply_bounded_perm(out, pv, targets)
    _apply_bounded_perm(perm, pv, targets)
    _window(out, 0, kk, mp, nb).copy_(pan)
    l11 = tri_project(_window(pan, kk, 0, nb, nb), Uplo.Lower, Diag.Unit)
    rowblk = _window(out, kk, 0, nb, n)
    eye = torch.eye(nb, dtype=out.dtype, device=dev)
    # the row solve as an explicit-inverse gemm, as in slate_tpu
    linv = solve_tri(l11, eye, upper=False, unitriangular=True)
    u12 = matmul(linv, rowblk).to(out.dtype)
    right = (torch.arange(n, device=dev) >= kk + nb)[None, :]
    rowblk.copy_(torch.where(right, u12, rowblk))
    # broadcast 0/1 masks stay multiplies in XLA (NaN * 0 = NaN), unlike
    # the same-shape masks of the panel loops
    l21 = pan * (torch.arange(mp, device=dev) >= kk + nb)[:, None].to(pan.dtype)
    matmul_sub_(out, l21, rowblk * right.to(pan.dtype))


def getrf_scan_array(a: torch.Tensor, nb: int = _PANEL_W, nbuckets: int = 4) -> LUFactors:
    """Partial-pivot LU over fixed-width panels (PA = LU), ``slate_tpu``'s
    scanned form: the same pivot choices as :func:`getrf_array`, except
    that on an exactly singular input a zero-pivot row stays in place
    (info > 0 flags it).  The k-range is cut into ``nbuckets`` shrinking
    trailing views; pivot search and swaps touch only rows >= k, so each
    bucket works on ``out[off:, off:]``, and the finished L columns receive
    the bucket's composed row permutation in one gather at its end.  Rows
    and columns are padded to whole panels, so no panel slice is short."""
    m, n = a.shape
    nmin = min(m, n)
    nsteps = -(-nmin // nb)
    mp = max(m, nsteps * nb)
    np_ = max(n, nsteps * nb)
    out = torch.zeros((mp, np_), dtype=a.dtype, device=a.device)
    out[:m, :n] = a
    perm = torch.arange(mp, device=a.device)
    bounds = [nsteps * g // nbuckets for g in range(nbuckets)] + [nsteps]
    for g in range(nbuckets):
        k0, k1 = bounds[g], bounds[g + 1]
        if k0 == k1:
            continue
        off = k0 * nb
        view = out[off:, off:]  # updates land in out
        mv = mp - off
        pl = torch.arange(mv, device=a.device)
        for k in range(k0, k1):
            kk = k * nb - off  # view-local row/column of the panel head
            pan, piv = _panel_lu_masked(_window(view, 0, kk, mv, nb), kk, nmin - off, m - off)
            _scan_step_update(view, pan, pl, piv.cpu().numpy(), kk, nb)
        if off:
            out[off:, :off] = out[off:, :off][pl]
        perm[off:] = perm[off:][pl]
    lu = out[:m, :n]
    return LUFactors(lu, perm[:m], _lu_info(lu))


# ---------------------------------------------------------------------------
# no-pivot and tournament-pivoted LU
# ---------------------------------------------------------------------------


def getrf_nopiv_array(a: torch.Tensor) -> LUFactors:
    """No-pivot LU (src/getrf_nopiv.cc); perm is the identity."""
    lu = _getrf_nopiv_rec(a)
    return LUFactors(lu, torch.arange(a.shape[0], device=a.device), _lu_info(lu))


def _tournament_pivots_masked(panel: torch.Tensor, w: int, kk: int, m_true: int
                              ) -> torch.Tensor:
    """Tournament pivot selection over the full-height panel with rows < kk
    (factored) and >= m_true (padding) masked out; returns the w winning
    row ids (the sentinel mp in a slot when fewer than w rows remain)."""
    mp = panel.shape[0]
    rows = torch.arange(mp, device=panel.device)
    valid = (rows >= kk) & (rows < m_true)
    ap = torch.where(valid[:, None], panel, panel.new_zeros(()))
    idx = torch.where(valid, rows, mp)  # sentinel rows sort last in each LU
    _, tops_i = _tournament_reduce(ap[None], idx[None], w, mp)
    return tops_i[0]


def _tournament_swap_seq(piv: np.ndarray, kk: int, mp: int) -> np.ndarray:
    """The selected rows as a LAPACK-style sequential swap sequence (swap i
    brings selected row i to kk + i), tracking where earlier swaps moved
    each row."""
    w = len(piv)
    seq = kk + np.arange(w)
    pos2row = np.arange(mp)
    row2pos = np.arange(mp)
    for i in range(w):
        tgt = kk + i
        cur = row2pos[min(piv[i], mp - 1)] if piv[i] < mp else tgt
        r1, r2 = pos2row[tgt], pos2row[cur]
        pos2row[tgt], pos2row[cur] = r2, r1
        row2pos[r2], row2pos[r1] = tgt, cur
        seq[i] = cur
    return seq


def getrf_tntpiv_array(a: torch.Tensor, nb: int = _PANEL_W) -> LUFactors:
    """Blocked LU with tournament pivoting (CALU) over fixed-width panels:
    per panel the tournament tree picks nb pivot rows, they are swapped to
    the top LAPACK-style, and the panel factors without interchanges."""
    m, n = a.shape
    nmin = min(m, n)
    nb = min(nb, nmin)
    nsteps = -(-nmin // nb)
    mp = max(m, nsteps * nb)
    np_ = max(n, nsteps * nb)
    out = torch.zeros((mp, np_), dtype=a.dtype, device=a.device)
    out[:m, :n] = a
    perm = torch.arange(mp, device=a.device)
    for k in range(nsteps):
        kk = k * nb
        panel = _window(out, 0, kk, mp, nb).clone()
        piv_rows = _tournament_pivots_masked(panel, nb, kk, m).cpu().numpy()
        piv = _tournament_swap_seq(piv_rows, kk, mp)
        pv = _swaps_to_perm(piv, kk, mp)
        _apply_bounded_perm(panel, pv, np.concatenate([kk + np.arange(nb), piv]))
        pan, _ = _panel_lu_masked(panel, kk, nmin, m, pivot=False)
        _scan_step_update(out, pan, perm, piv, kk, nb, pv=pv)
    lu = out[:m, :n]
    return LUFactors(lu, perm[:m], _lu_info(lu))


# ---------------------------------------------------------------------------
# solves and drivers
# ---------------------------------------------------------------------------


def getrs_array(f: LUFactors, b: torch.Tensor, op: Op = Op.NoTrans) -> torch.Tensor:
    """Solve op(A) X = B from the factors (src/getrs.cc)."""
    lu, perm = f.lu, f.perm
    if op == Op.NoTrans:
        y = trsm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.Unit, 1.0, lu, b[perm])
        return trsm_array(Side.Left, Uplo.Upper, Op.NoTrans, Diag.NonUnit, 1.0, lu, y)
    # op(A) = A^T or A^H: U^op y = b, L^op z = y, x = P^T z
    y = trsm_array(Side.Left, Uplo.Upper, op, Diag.NonUnit, 1.0, lu, b)
    z = trsm_array(Side.Left, Uplo.Lower, op, Diag.Unit, 1.0, lu, y)
    return z[torch.argsort(perm)]


def gesv_array(a: torch.Tensor, b: torch.Tensor, method: MethodLU = MethodLU.PartialPiv):
    """Factor and solve (src/gesv.cc).  Returns (x, factors); under
    MethodLU.RBT the factors are ``rbt.RBTFactors``."""
    if method == MethodLU.PartialPiv:
        f = getrf_array(a)
    elif method == MethodLU.CALU:
        f = getrf_tntpiv_array(a)
    elif method == MethodLU.NoPiv:
        f = getrf_nopiv_array(a)
    elif method == MethodLU.RBT:
        from .rbt import gesv_rbt_array

        return gesv_rbt_array(a, b)
    else:
        raise ValueError(method)
    return getrs_array(f, b), f


def getri_array(f: LUFactors) -> torch.Tensor:
    """The inverse from the factors (src/getri.cc): A^-1 = U^-1 L^-1 P."""
    from .tri import trtri_array

    uinv = trtri_array(tri_project(f.lu, Uplo.Upper), Uplo.Upper, Diag.NonUnit)
    linv = trtri_array(tri_project(f.lu, Uplo.Lower, Diag.Unit), Uplo.Lower, Diag.Unit)
    x = matmul(uinv, linv).to(f.lu.dtype)
    # right-multiplying by P permutes the columns by perm^-1
    return x[:, torch.argsort(f.perm)]


def getri_oop_array(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Out-of-place inverse (src/getriOOP.cc): factor A and solve A X = I.
    Returns (A^-1, info)."""
    f = getrf_array(a)
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return getrs_array(f, eye), f.info


def getrf(a: ArrayLike, opts: Optional[Options] = None, device=None
          ) -> Tuple[Matrix, LUFactors]:
    """slate::getrf over a matrix view, on ``operand_device(a, device)``.
    Option.MethodLU picks the form; under CALU, Option.MaxPanelThreads
    widens the tournament panel (64 x threads, at most 8x), which changes
    which pivots win, as in ``slate_tpu``."""
    ad = _arr(a, operand_device(a, device))
    method = get_option(opts, Option.MethodLU, MethodLU.PartialPiv)
    if method == MethodLU.CALU:
        threads = int(get_option(opts, Option.MaxPanelThreads, 1))
        f = getrf_tntpiv_array(ad, nb=_PANEL_W * min(max(1, threads), 8))
    elif method == MethodLU.NoPiv:
        f = getrf_nopiv_array(ad)
    else:
        f = getrf_array(ad)
    return Matrix(data=f.lu), f


def gesv(a: ArrayLike, b: ArrayLike, opts: Optional[Options] = None, device=None):
    """slate::gesv over matrix views, on ``operand_device(a, device)``;
    returns (x, factors), x wrapped like ``b``."""
    dev = operand_device(a, device)
    method = get_option(opts, Option.MethodLU, MethodLU.PartialPiv)
    x, f = gesv_array(_arr(a, dev), _arr(b, dev), method)
    if isinstance(b, BaseMatrix):
        x = replace(b, data=x)
    return x, f


# ---------------------------------------------------------------------------
# band LU (src/gbtrf.cc, gbtrs.cc, gbsv.cc)
# ---------------------------------------------------------------------------


def gbtrf_array(a: torch.Tensor, kl: int, ku: int) -> LUFactors:
    """Band LU with partial pivoting on the dense path.  Pivoting widens U's
    band to kl + ku (LAPACK gbtrf semantics), so U is projected to that
    band; L's multiplier columns have at most kl nonzeros each, but
    pivoting scatters them to arbitrary rows (Golub & Van Loan band LU), so
    the strictly-lower part is kept dense: projecting it would corrupt the
    factorization."""
    f = getrf_array(band_project(a, kl, ku))
    eye = torch.eye(*f.lu.shape, dtype=f.lu.dtype, device=f.lu.device)
    l_part = tri_project(f.lu, Uplo.Lower, Diag.Unit) - eye
    u_part = band_project(tri_project(f.lu, Uplo.Upper), 0, kl + ku)
    return LUFactors(l_part + u_part, f.perm, f.info)


def gbtrs_array(f, b: torch.Tensor, kl: int, ku: int, op: Op = Op.NoTrans) -> torch.Tensor:
    """Solve from a band factor: the windowed ``BandLU`` (gbsv_array's
    narrow route; op NoTrans only) or the dense ``LUFactors``."""
    from .band import BandLU, gbtrs_band

    if isinstance(f, BandLU):
        if op != Op.NoTrans:
            raise ValueError("windowed band factors support op=NoTrans only")
        return gbtrs_band(f, b)
    return getrs_array(f, b, op)


def gbsv_array(a: torch.Tensor, b: torch.Tensor, kl: int, ku: int):
    """Band solve (src/gbsv.cc).  A narrow band takes the windowed
    O(n kl (kl + ku)) path (``linalg.band``, LAPACK gbtrf pivot semantics:
    its factor carries per-window permutations, not a global one); a wide
    band the dense partial-pivot factorization.  Returns (x, factor)."""
    from .band import band_worthwhile

    if band_worthwhile(a.shape[0], max(kl, 1) + max(ku, 1)):
        from .band import gbsv_band

        x, f, _ = gbsv_band(a, b, kl, ku)
        return x, f
    f = gbtrf_array(a, kl, ku)
    return gbtrs_array(f, b, kl, ku), f
