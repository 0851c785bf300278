"""Windowed band factorizations: O(n band^2) work instead of dense O(n^3).

Counterpart of ``slate_tpu/linalg/band.py`` (the reference's
``src/pbtrf.cc`` / ``src/gbtrf.cc`` and their solves).  The band is packed
into per-block-column SLABS of fixed shape -- ``ns`` slabs of ``(w, nb)``
(Cholesky) or ``(hg, nb)`` (LU) -- so the loop state is O(n band) and each
step assembles its O(band^2) window from a handful of slab slices, updates
it and scatters it back.  ``slate_tpu`` measured a dense (n, n) carry 7x
slower than its dense potrf; here the slabs are one tensor updated in
place.

Bandwidths are rounded up to multiples of the block size internally (a
superset band is still exact), after the operand is projected to its
DECLARED band, so entries between the declared and the rounded band never
change the result.  Band LU pivoting follows LAPACK gbtrf: partial
pivoting within the kl window, the multipliers stay in place, and the solve
replays the per-window permutations; the packed factor is NOT globally
row-permuted like the dense getrf path.

PyTorch runs eagerly, so ``slate_tpu``'s ``fori_loop``s are Python loops
over the same fixed-shape steps.  ``slate_tpu`` pads the operand to a dense
(npad, npad) array with an identity diagonal and gathers the slabs from it;
here the slabs are gathered from the operand itself with the pad's values
(zero, one on the padded diagonal) put in by mask, so no dense padded copy
is made.  A band LU step reads its pivots on the host (one small copy), as
the port's scanned LU does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..blas3.blas3 import solve_tri
from ..ops.matmul import matmul
from .chol import _cholesky, _ht, _info
from .lu import _apply_bounded_perm, _lu_info, _panel_lu_masked, _swaps_to_perm


def band_worthwhile(n: int, band: int) -> bool:
    """Windowed O(n band^2) beats the dense path once the band is a small
    fraction of n (``slate_tpu``'s crossover)."""
    return 4 * max(band, 1) <= n


def _pick_nb(band: int) -> int:
    return max(8, min(64, 1 << max(3, (max(band, 1) - 1).bit_length() - 1)))


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 0) + mult - 1) // mult) * mult


def _slab_index(ns: int, nb: int, height: int, row_off: int, device):
    """Row and column indices of slab element (k, t, s): row k nb - row_off
    + t, column k nb + s, as broadcastable (ns, height, 1) / (ns, 1, nb)."""
    ks = torch.arange(ns, device=device)
    rows = ks[:, None, None] * nb - row_off + torch.arange(height, device=device)[None, :, None]
    cols = ks[:, None, None] * nb + torch.arange(nb, device=device)[None, None, :]
    return rows, cols


def _pack_slabs(a: torch.Tensor, ns: int, nb: int, height: int, row_off: int,
                keep=None) -> torch.Tensor:
    """slabs[k] = ap[k nb - row_off : + height, k nb : + nb] by one gather,
    where ap is ``a`` (n, n) extended by zeros with ones on the padded
    diagonal and rows < 0 read zero (``slate_tpu``'s padded operand).
    ``keep(i - j)`` masks the entries of ``a`` to keep (the declared band)."""
    n = a.shape[0]
    rows, cols = _slab_index(ns, nb, height, row_off, a.device)
    inside = (rows >= 0) & (rows < n) & (cols < n)
    if keep is not None:
        inside = inside & keep(rows - cols)
    vals = a[rows.clamp(0, max(n - 1, 0)), cols.clamp(max=max(n - 1, 0))]
    out = torch.where(inside, vals, torch.zeros((), dtype=a.dtype, device=a.device))
    pad_diag = (rows == cols) & (rows >= n)
    return torch.where(pad_diag, torch.ones((), dtype=a.dtype, device=a.device), out)


def _unpack_slabs(slabs: torch.Tensor, n: int, nb: int, row_off: int) -> torch.Tensor:
    """Scatter the slabs into a zero (n, n) matrix; the entries outside it
    (the padding, rows < 0) are dropped by mask, as ``mode="drop"`` drops
    them in ``slate_tpu`` (a CUDA index out of range would assert)."""
    ns, height, _ = slabs.shape
    rows, cols = _slab_index(ns, nb, height, row_off, slabs.device)
    rows, cols = torch.broadcast_tensors(rows, cols)
    valid = (rows >= 0) & (rows < n) & (cols < n)
    out = torch.zeros((n, n), dtype=slabs.dtype, device=slabs.device)
    out[rows[valid], cols[valid]] = slabs[valid]
    return out


def _rhs_window(yp: torch.Tensor, kk: int, h: int) -> torch.Tensor:
    """yp[kk : kk + h] with ``lax.dynamic_slice``'s clamped start."""
    r0 = min(max(kk, 0), yp.shape[0] - h)
    return yp[r0:r0 + h]


# ---------------------------------------------------------------------------
# SPD band Cholesky (pbtrf / pbtrs)
# ---------------------------------------------------------------------------


class BandChol(NamedTuple):
    """Lower band Cholesky factor in dense storage + bandwidth."""

    l: torch.Tensor
    kd: int
    nb: int
    info: torch.Tensor


def pbtrf_band(a: torch.Tensor, kd: int, nb: int = 0) -> BandChol:
    """Windowed lower band Cholesky (src/pbtrf.cc): per nb-block, factor
    the diagonal block, solve the band-row panel under it, update only the
    (kd, kd) trailing window.  O(n kd^2) flops, O(n kd) loop state.
    ``a`` holds the lower triangle; entries below the declared band ``kd``
    and above the diagonal are ignored."""
    n = a.shape[0]
    nb = nb or _pick_nb(kd)
    kdr = _round_up(max(kd, 1), nb)  # rounded band; superset is exact
    c = kdr // nb
    w = kdr + nb
    nsteps = -(-n // nb)
    ns = nsteps + c  # extra slabs so window assembly never runs off the end
    # slabs hold the LOWER triangle of the declared band only (rows kk..kk+w)
    slabs = _pack_slabs(a, ns, nb, w, 0, keep=lambda d: (d >= 0) & (d <= kd))

    def assemble(k: int) -> torch.Tensor:
        """Full Hermitian (w, w) window, rows/cols kk..kk+w."""
        win = torch.zeros((w, w), dtype=slabs.dtype, device=slabs.device)
        for j in range(c + 1):
            win[j * nb:, j * nb:(j + 1) * nb] = slabs[k + j, :w - j * nb]
        return win + _ht(win.tril(-1))

    def scatter(k: int, win: torch.Tensor) -> None:
        win = win.tril()  # slabs keep the lower-only convention
        for j in range(c + 1):
            slabs[k + j, :w - j * nb] = win[j * nb:, j * nb:(j + 1) * nb]

    for k in range(nsteps):
        win = assemble(k)
        ld = _cholesky(win[:nb, :nb])
        pan = solve_tri(_ht(ld), win[nb:, :nb], upper=True, left=False)
        trail = win[nb:, nb:] - matmul(pan, _ht(pan)).to(win.dtype)
        win[:nb, :nb] = ld
        win[nb:, :nb] = pan
        win[nb:, nb:] = trail
        scatter(k, win)

    l = _unpack_slabs(slabs, n, nb, 0).tril_()
    return BandChol(l, kd, nb, _info(l))


def pbtrs_band(f: BandChol, b: torch.Tensor) -> torch.Tensor:
    """Banded forward + backward substitution, O(n kd nrhs); the right-hand
    side is the only O(n) loop state."""
    squeeze = b.dim() == 1
    bd = b[:, None] if squeeze else b
    n, nrhs = bd.shape
    nb = f.nb
    kdr = _round_up(max(f.kd, 1), nb)
    w = kdr + nb
    nsteps = -(-n // nb)
    ns = nsteps + kdr // nb
    npad = ns * nb + w
    slabs = _pack_slabs(f.l, ns, nb, w, 0)  # (ns, w, nb): diag block + kd rows below
    yp = torch.zeros((npad, nrhs), dtype=f.l.dtype, device=f.l.device)
    yp[:n] = bd.to(f.l.dtype)

    for k in range(nsteps):
        lw = slabs[k]
        yw = _rhs_window(yp, k * nb, w)
        top = solve_tri(lw[:nb], yw[:nb], upper=False)
        yw[nb:] -= matmul(lw[nb:], top).to(yp.dtype)
        yw[:nb] = top

    for k in range(nsteps - 1, -1, -1):
        lw = slabs[k]
        yw = _rhs_window(yp, k * nb, w)
        rhs = yw[:nb] - matmul(_ht(lw[nb:]), yw[nb:]).to(yp.dtype)
        yw[:nb] = solve_tri(_ht(lw[:nb]), rhs, upper=True)

    x = yp[:n]
    return x[:, 0] if squeeze else x


def pbsv_band(a: torch.Tensor, b: torch.Tensor, kd: int):
    f = pbtrf_band(a, kd)
    return pbtrs_band(f, b), f, f.info


# ---------------------------------------------------------------------------
# General band LU with partial pivoting (gbtrf / gbtrs)
# ---------------------------------------------------------------------------


class BandLU(NamedTuple):
    """Windowed band LU: packed factors in dense storage, per-window
    permutations (LAPACK gbtrf pivot semantics), bandwidths."""

    lu: torch.Tensor
    perms: torch.Tensor  # (nsteps, wr) int32: window-local row permutation per block
    kl: int
    ku: int
    nb: int
    info: torch.Tensor


def _gb_geometry(kl: int, ku: int, nb: int):
    klr = _round_up(max(kl, 1), nb)
    kur = _round_up(max(ku, 1), nb)
    wr = nb + klr  # rows a block's elimination touches
    wc = nb + klr + kur  # cols (panel + fill-in reach)
    # pivoting can pull a row from klr below, carrying entries kur right of
    # ITS diagonal: U in column c reaches up to row c - klr - kur
    upoff = klr + kur
    hg = upoff + wr  # slab height: fill-in rows above + reach below
    return klr, kur, wr, wc, upoff, hg


def gbtrf_band(a: torch.Tensor, kl: int, ku: int, nb: int = 0) -> BandLU:
    """Windowed band LU with partial pivoting (src/gbtrf.cc): per nb-block,
    pivoted panel LU of the (nb + kl)-row window (pivots stay within the
    kl reach), trailing update confined to the (nb + kl, kl + ku + nb)
    window; fill-in widens U to kl + ku as in LAPACK.  O(n kl (kl + ku))
    flops, O(n band) loop state."""
    n = a.shape[0]
    nb = nb or _pick_nb(max(kl, 1))
    klr, kur, wr, wc, upoff, hg = _gb_geometry(kl, ku, nb)
    cg = wc // nb  # column blocks a window spans
    nsteps = -(-n // nb)
    ns = nsteps + cg
    # slab k: rows kk - upoff .. kk + wr of column block k (rows < 0 read
    # zero), the operand projected to its declared (kl, ku) band
    slabs = _pack_slabs(a, ns, nb, hg, upoff, keep=lambda d: (d <= kl) & (-d <= ku))
    pieces = []  # (slab local row s0, rows ln, window row lo) per column block j
    for j in range(cg):
        lo = max(0, j * nb - upoff)  # first window row in the slab
        s0 = lo + upoff - j * nb
        pieces.append((s0, min(wr - lo, hg - s0), lo))
    eye = torch.eye(nb, dtype=a.dtype, device=a.device)
    perms = np.zeros((nsteps, wr), np.int32)

    for k in range(nsteps):
        win = torch.zeros((wr, wc), dtype=slabs.dtype, device=slabs.device)
        for j, (s0, ln, lo) in enumerate(pieces):
            win[lo:lo + ln, j * nb:(j + 1) * nb] = slabs[k + j, s0:s0 + ln]
        pan, piv = _panel_lu_masked(win[:, :nb], 0, nb, wr)
        piv = piv.cpu().numpy()
        pv = _swaps_to_perm(piv, 0, wr)
        rest = win[:, nb:]
        _apply_bounded_perm(rest, pv, np.concatenate([np.arange(nb), piv]))
        l11 = pan[:nb].tril(-1) + eye
        u12 = solve_tri(l11, rest[:nb], upper=False, unitriangular=True)
        rest[nb:] -= matmul(pan[nb:], u12).to(win.dtype)
        rest[:nb] = u12
        win[:, :nb] = pan
        for j, (s0, ln, lo) in enumerate(pieces):
            slabs[k + j, s0:s0 + ln] = win[lo:lo + ln, j * nb:(j + 1) * nb]
        perms[k] = pv

    lu = _unpack_slabs(slabs, n, nb, upoff)
    return BandLU(lu, torch.from_numpy(perms).to(a.device), kl, ku, nb, _lu_info(lu))


def gbtrs_band(f: BandLU, b: torch.Tensor) -> torch.Tensor:
    """Solve from windowed band-LU factors: the forward sweep replays each
    window's permutation and elimination, the backward sweep solves the
    banded U.  O(n (kl + ku) nrhs)."""
    squeeze = b.dim() == 1
    bd = b[:, None] if squeeze else b
    n, nrhs = bd.shape
    nsteps, wr = f.perms.shape
    nb = f.nb
    klr, kur, wr2, wc, upoff, hg = _gb_geometry(f.kl, f.ku, nb)
    if wr2 != wr:
        raise ValueError(f"gbtrs_band: perms of width {wr} do not fit kl = {f.kl}, nb = {nb}")
    npad = (nsteps + wc // nb) * nb + hg + upoff
    dtype, dev = f.lu.dtype, f.lu.device
    # the (wr, nb) L blocks and the (nb, wc) U block rows of each step,
    # gathered from the padded factor (ones on its padded diagonal)
    lslabs = _pack_slabs(f.lu, nsteps, nb, wr, 0)
    uslabs = _pack_slabs(f.lu.T, nsteps, nb, wc, 0).transpose(1, 2)
    yp = torch.zeros((npad, nrhs), dtype=dtype, device=dev)
    yp[:n] = bd.to(dtype)
    perms = f.perms.to(dev, torch.int64)
    eye = torch.eye(nb, dtype=dtype, device=dev)

    for k in range(nsteps):
        yw = _rhs_window(yp, k * nb, wr)
        yw.copy_(yw[perms[k]])
        lw = lslabs[k]
        top = solve_tri(lw[:nb].tril(-1) + eye, yw[:nb], upper=False, unitriangular=True)
        yw[nb:] -= matmul(lw[nb:], top).to(dtype)
        yw[:nb] = top

    for k in range(nsteps - 1, -1, -1):
        uw = uslabs[k]
        yw = _rhs_window(yp, k * nb, wc)
        rhs = yw[:nb] - matmul(uw[:, nb:], yw[nb:]).to(dtype)
        yw[:nb] = solve_tri(uw[:, :nb].triu(), rhs, upper=True)

    x = yp[:n]
    return x[:, 0] if squeeze else x


def gbsv_band(a: torch.Tensor, b: torch.Tensor, kl: int, ku: int):
    f = gbtrf_band(a, kl, ku)
    return gbtrs_band(f, b), f, f.info
