"""Checksum-carrying distributed kernels + the verify/locate/repair drivers.

Counterpart of ``slate_tpu/ft/abft.py`` on the virtual (p, q) mesh.  Four
ABFT variants of the mesh kernels, each running the SAME schedule as its
plain sibling — the checksum tiles are ordinary tiles of the block-cyclic
grid, so they ride the existing ``comm.prefetch_bcast`` (SUMMA, trsm) /
``comm.pipelined_factor_loop`` (potrf, LU-nopiv) loops and every panel
broadcast simply carries one more augmented tile row or column:

- :func:`_ft_summa`: stationary-C SUMMA over row-augmented A and
  column-augmented B, so the product arrives with its own row and column
  checksums attached.  Under ``Option.PanelImpl`` pallas/auto each step
  is one :func:`ops.kernels.ft_summa_update` (the hand-written
  ``csrc/ft_summa_update.cu`` on the card; bf16/f16 accumulate in f32),
  which also accumulates the Huang-Abraham weighted row sums, so the
  online discrepancy costs no second sweep; under xla a full-f32
  ``torch.matmul`` and no online check.
- :func:`_ft_potrf`: the right-looking mesh Cholesky k-loop on a matrix
  with two checksum tile rows appended below, unbucketed on the full view
  (the bucketed trailing windows would strand the checksum rows), its
  panel ``dist_chol._chol_panel_factor_solve`` (``chol_panel_tiles``) and
  its narrow/bulk updates full-f32 ``torch.matmul`` products.
- :func:`_ft_lu`: the LU-nopiv k-loop on a doubly-augmented matrix
  (checksum rows verify L, checksum columns verify U), reusing
  ``dist_lu._nopiv_panel/_narrow/_bulk`` and so the three LU kernels.
- :func:`trsm_ft`: the TrsmB left solve with the weighted column sums of
  B appended as extra right-hand sides (the solution-checksum carrier);
- :func:`her2k_ft`: the her2k / syr2k SUMMA of ``parallel.dist_blas3``
  (its ``her2k_acc`` loop, the same two panel broadcasts and gathers a
  step) over row-augmented A and B, computed FULL: [A; WA][B; WB]^H +
  [B; WB][A; WA]^H is C wearing its own row (W C) and column (C W^H)
  checksums, the GEMM structure, so the GEMM verify and repair judge it.

Fault hooks.  ``slate_tpu`` lowers an armed ``inject.FaultPlan`` into a
traced mask; here the loops run eagerly with the step k a Python int, so
a hook is a host-side test of the armed slots that corrupts one tile of
the (p, q, ...) stacks: device (r, c) is the leading ``[r, c]`` slot.  A
broadcast panel is a stride-0 view shared by every receiving device, so
on the step a ``bcast`` fault is armed for (and only then) the panel is
materialized as every device's own copy (``expand(...).clone()``) before
one copy rots: clean runs stay copy-free.  The trailing hook is keyed to
the PAYLOAD's step and split between the narrow and bulk halves, so every
lookahead depth corrupts the tile exactly once.

Verify on the card.  The residuals (carried checksums minus recomputed
tile sums) and the per-tile discrepancy maxima are computed where the
output lies; only the 2 x nt maxima and the nb x nb blocks that
``checksum.ratio_locate`` reads come to the host, and the repair blocks
are added on the device.  The decisions (flagged tiles, located index,
action) are ``slate_tpu``'s: one full recompute for live-data corruption,
``FtError`` when that still verifies dirty.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..obs import REGISTRY
from ..ops.kernels import (
    ft_summa_update,
    panel_engaged,
    panel_impl_scope,
    resolve_panel_impl,
)
from ..parallel.comm import (
    ROW_AXIS,
    all_gather_a,
    bcast_diag_tile,
    bcast_from_col,
    bcast_from_row,
    bcast_impl_scope,
    la_depth,
    local_indices,
    pipelined_factor_loop,
    prefetch_bcast,
    psum_a,
    resolve_bcast_impl,
)
from ..parallel.dist import DistMatrix, from_dense, local_view, padded_tiles, to_dense
from ..parallel.dist_blas3 import acc_tiles, her2k_acc, her2k_dist, tiles_of
from ..parallel.dist_chol import _chol_panel_factor_solve
from ..parallel.dist_lu import _nopiv_bulk, _nopiv_narrow, _nopiv_panel
from ..parallel.dist_trsm import _trsm_b, trsm_dist
from ..parallel.mesh import VirtualMesh, mesh_shape
from ..types import Diag, MethodTrsm, Op, Option, Options, Uplo, get_option
from . import checksum as cks
from . import inject
from .inject import MAX_FAULTS, PH_BCAST, PH_PANEL, PH_TRAIL
from .policy import FtError, FtPolicy, FtReport, count, resolve_policy

CSR = 2  # checksum tile rows/cols appended per protected side


# ---------------------------------------------------------------------------
# host-side fault application (shared by every kernel)
# ---------------------------------------------------------------------------


class _Slot:
    """One armed fault of the spec: ``slate_tpu``'s (active, k, phase, ti,
    tj, r, c, mode) ints and its value."""

    __slots__ = ("k", "phase", "ti", "tj", "r", "c", "mode", "value")

    def __init__(self, ints: np.ndarray, value: float):
        self.k, self.phase, self.ti, self.tj, self.r, self.c, self.mode = (int(x) for x in ints[1:])
        self.value = float(value)


def _slots(ints: np.ndarray, vals: np.ndarray) -> List[_Slot]:
    """The armed slots of a (MAX_FAULTS, 8) spec (disarmed ones are no-ops
    in ``slate_tpu`` and are dropped here)."""
    return [_Slot(ints[s], vals[s]) for s in range(MAX_FAULTS) if int(ints[s, 0]) == 1]


def _corrupt(tile: torch.Tensor, mode: int, value: float) -> None:
    """Perturb one (nb, nb) tile in place: 1 = zero it, 2 = scale it,
    otherwise a bitflip-style add to element (0, 0)."""
    if mode == inject.MODE_ZERO:
        tile.zero_()
    elif mode == inject.MODE_SCALE:
        tile.mul_(value)
    else:
        tile[0, 0] += value


def _hit4(x: torch.Tensor, r: int, c: int, li: int, lj: int, f: _Slot) -> None:
    """Corrupt local tile slot (li, lj) of device (r, c) of a (p, q, I, J,
    nb, nb) stack; a slot outside the stack is a no-op, as ``slate_tpu``'s
    mask."""
    if 0 <= li < x.shape[2] and 0 <= lj < x.shape[3]:
        _corrupt(x[r, c, li, lj], f.mode, f.value)


def _bcast_hits(slots: List[_Slot], k: int) -> List[_Slot]:
    return [f for f in slots if f.phase == PH_BCAST and f.k == k]


def _rot_received(pan: torch.Tensor, hits: List[_Slot], p: int, q: int) -> torch.Tensor:
    """A received panel (P, Q, L, nb, nb) with every device's own copy, and
    each armed bcast fault applied to device (r, c)'s copy of tile row ti
    (only where r owns that row: r == ti % p, as ``slate_tpu``)."""
    pan = pan.expand(p, q, *pan.shape[2:]).clone()
    for f in hits:
        li = f.ti // p
        if f.r == f.ti % p and 0 <= li < pan.shape[2]:
            _corrupt(pan[f.r, f.c, li], f.mode, f.value)
    return pan


def _precise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``slate_tpu``'s PRECISE einsum: a full-f32 product.  A TF32 product
    would raise the clean discrepancies toward the detection threshold, so
    the path refuses to run with TF32 on."""
    if a.is_cuda and a.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("ft.abft: the checksum-carrying products need full f32; "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(a, b)


_LOW = (torch.bfloat16, torch.float16)  # accumulated in f32 by the fused step


# ---------------------------------------------------------------------------
# checksum-carrying SUMMA (stationary-C; summa._summa_c + fault hooks)
# ---------------------------------------------------------------------------


def _ft_summa(at, bt, ct, alpha, beta, p, q, kt, la, mt, slots) -> Tuple[torch.Tensor, float]:
    """Checksum-carrying SUMMA over the cyclic tile stacks ``at`` / ``bt``
    (``ct`` the augmented C or None for a zero C).  ``mt`` is the DATA
    tile-row count of the augmented grid (checksum tile rows sit at
    logical rows mt, mt+1).  Returns (alpha A B + beta C tiles,
    online_disc): the max |recomputed weighted row sums - carried checksum
    rows| at loop end when the fused kernel ran, else the -1 sentinel."""
    a_loc, b_loc = local_view(at, p, q), local_view(bt, p, q)
    mtl, ntl, nb = a_loc.shape[2], b_loc.shape[3], a_loc.shape[4]
    dtype, dev = at.dtype, at.device
    _, _, i_log, _ = local_indices(p, q, mtl, ntl, dev)
    # Option.PanelImpl, as slate_tpu's panel_engaged gate; the kernel takes
    # f32/f64, so a half-precision product accumulates in f32
    fused = panel_engaged(dtype)
    wdt = torch.float32 if fused and dtype in _LOW else dtype
    out = torch.zeros((at.shape[0], bt.shape[1], nb, nb), dtype=wdt, device=dev)
    acc = local_view(out, p, q)  # (p, q, mtl, ntl, nb, nb): C's tiles, in place
    part = torch.zeros((p, q, CSR, ntl, nb, nb), dtype=wdt, device=dev) if fused else None
    data_row = i_log < mt  # unit/ramp weights vanish on checksum and pad rows
    w1 = data_row.to(wdt)
    w2 = ((i_log + 1) * data_row).to(wdt)

    def fetch(k):
        acol = bcast_from_col(a_loc[:, :, :, k // q], k % q, q)  # (p, 1, mtl, nb, nb)
        brow = bcast_from_row(b_loc[:, :, k // p], k % p, p)  # (1, q, ntl, nb, nb)
        hits = _bcast_hits(slots, k)
        if hits:  # one device's RECEIVED copy of A's column panel rots
            acol = _rot_received(acol, hits, p, q)
        return acol, brow

    def consume(k, panels, state):
        acol, brow = panels
        if fused:
            ft_summa_update(acc, acol.to(wdt), brow.to(wdt), w1, w2, part)
        else:
            acc.add_(_precise_matmul(acol.unsqueeze(-3), brow.unsqueeze(-4)))
        # trailing-phase fault: one accumulator tile rots right after step
        # k's update lands (final data for GEMM — correctable)
        for f in slots:
            if f.phase == PH_TRAIL and f.k == k:
                _hit4(acc, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)
        return state

    prefetch_bcast(kt, la, fetch, consume, None)
    disc = -1.0
    if fused:
        # online discrepancy: global weighted data-row sums (one psum up
        # each mesh column) minus the CARRIED checksum-row tiles, judged
        # on the checksum rows' owners
        ws = psum_a(part, ROW_AXIS, p)[0]  # (q, 2, ntl, nb, nb)
        d = torch.zeros((), dtype=torch.float32, device=dev)
        for s in range(CSR):
            carried = acc[(mt + s) % p, :, min((mt + s) // p, mtl - 1)]  # (q, ntl, nb, nb)
            d = torch.maximum(d, (ws[:, s] - carried).abs().max().to(torch.float32))
        disc = float(d)
    out.mul_(alpha)
    if ct is not None:
        out.add_(ct * beta)
    return out.to(dtype), disc


# ---------------------------------------------------------------------------
# checksum-carrying mesh Cholesky (dist_chol phases, unbucketed full view)
# ---------------------------------------------------------------------------


def _ft_potrf(t: torch.Tensor, p: int, q: int, nt: int, la: int, slots) -> None:
    """The pipelined full-view k-loop of ``slate_tpu``'s ``_ft_potrf_jit``,
    in place on the augmented cyclic tile stack ``t`` (nt data tile
    steps)."""
    loc = local_view(t, p, q)  # (p, q, mtl, ntl, nb, nb)
    mtl, ntl = loc.shape[2], loc.shape[3]
    dev = t.device
    cplx = t.is_complex()
    _, _, i_log, j_log = local_indices(p, q, mtl, ntl, dev)
    lower = (i_log[:, :, :, None] >= j_log[:, :, None, :])[..., None, None]  # (p, q, I, J, 1, 1)
    cols = torch.arange(ntl, device=dev)

    def trail_hits(view, kprev, kc, in_refresh):
        """Trailing-phase faults of step ``kprev``, restricted to (or
        excluding) the narrow-refreshed column slot ``kc``."""
        for f in slots:
            if f.phase != PH_TRAIL or f.k != kprev:
                continue
            if kc is not None and ((f.tj // q) == kc) != in_refresh:
                continue
            _hit4(view, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)

    def herk(pan, pan_t):
        return _precise_matmul(pan.unsqueeze(-3),
                               (pan_t.conj() if cplx else pan_t).unsqueeze(-4).transpose(-1, -2))

    def panel(k, view):
        kc, c0 = k // q, k % q
        dtile = bcast_diag_tile(view, k, p, q)[0, 0]
        pcol = view[:, c0:c0 + 1, :, kc]  # the owning column's slots: (p, 1, I, nb, nb)
        # factor + panel solve by Option.PanelImpl; the checksum rows ride
        # the solved stack like any other tile
        lkk, solved = _chol_panel_factor_solve(dtile, pcol, cplx)
        below = (i_log > k)[..., None, None]
        on_diag = (i_log == k)[..., None, None]
        newcol = torch.where(below, solved, torch.where(on_diag, lkk, pcol))
        pcol.copy_(newcol)
        pan = bcast_from_col(torch.where(below, newcol, 0), c0, q)
        # panel-phase fault: the owner's STORED finalized panel tile rots
        # AFTER the broadcast was issued — consumers saw clean data
        for f in slots:
            if f.phase == PH_PANEL and f.k == k:
                _hit4(view, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)
        hits = _bcast_hits(slots, k)
        if hits:  # one device's received panel copy
            pan = _rot_received(pan, hits, p, q)
        allpan = all_gather_a(pan, ROW_AXIS, p)[0]  # (Q', p, I, nb, nb): per mesh column
        cidx = torch.arange(allpan.shape[0], device=dev).view(-1, 1)
        jl = j_log[0]  # (q, J)
        pan_t = allpan[cidx, jl % p, jl // p][None]  # (1, q, J, nb, nb)
        return view, (pan, pan_t, k)

    def narrow(k, view, payload):
        if payload is None:
            return view
        pan, pan_t, kprev = payload
        kc = k // q
        upd = herk(pan, pan_t[:, :, kc:kc + 1])  # (p, q, I, 1, nb, nb)
        view[:, :, :, kc:kc + 1].sub_(upd.masked_fill_(~lower[:, :, :, kc:kc + 1], 0))
        trail_hits(view, kprev, kc, in_refresh=True)
        return view

    def bulk(k, view, payload):
        if payload is None:
            return view
        pan, pan_t, kprev = payload
        mask, kc = lower, None
        if k is not None:
            kc = k // q
            mask = lower & (cols != kc).view(1, 1, 1, -1, 1, 1)
        view.sub_(herk(pan, pan_t).masked_fill_(~mask, 0))
        trail_hits(view, kprev, kc, in_refresh=False)
        return view

    pipelined_factor_loop(0, nt, la, panel, narrow, bulk, loc, None)


# ---------------------------------------------------------------------------
# checksum-carrying mesh LU-nopiv (reuses dist_lu's panel/narrow/bulk)
# ---------------------------------------------------------------------------


def _ft_lu(t: torch.Tensor, p: int, q: int, nt: int, la: int, slots) -> None:
    """The pipelined full-view k-loop of ``slate_tpu``'s ``_ft_lu_jit``, in
    place on the doubly-augmented cyclic tile stack ``t``."""
    loc = local_view(t, p, q)
    mtl, ntl = loc.shape[2], loc.shape[3]
    _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device)

    def trail_hits(view, kprev, kr, kc, in_refresh):
        for f in slots:
            if f.phase != PH_TRAIL or f.k != kprev:
                continue
            if kr is not None:
                in_ref = (f.tj // q) == kc or (f.ti // p) == kr
                if in_ref != in_refresh:
                    continue
            _hit4(view, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)

    def panel(k, view):
        view, upd = _nopiv_panel(view, k, p, q, i_log, j_log)
        for f in slots:
            if f.phase == PH_PANEL and f.k == k:
                _hit4(view, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)
        hits = _bcast_hits(slots, k)
        if hits:
            upd.pan = _rot_received(upd.pan, hits, p, q)
        return view, (upd, k)

    def narrow(k, view, payload):
        if payload is None:
            return view
        upd, kprev = payload
        _nopiv_narrow(view, upd, k, p, q)
        trail_hits(view, kprev, k // p, k // q, in_refresh=True)
        return view

    def bulk(k, view, payload):
        if payload is None:
            return view
        upd, kprev = payload
        if k is None:
            _nopiv_bulk(view, upd)
            trail_hits(view, kprev, None, None, in_refresh=False)
        else:
            _nopiv_bulk(view, upd, k // p, k // q)
            trail_hits(view, kprev, k // p, k // q, in_refresh=False)
        return view

    pipelined_factor_loop(0, nt, la, panel, narrow, bulk, loc, None)


def _diag_info(t: torch.Tensor, p: int, q: int, nb: int, nt: int, lu: bool) -> torch.Tensor:
    """info over the DATA diagonal only (the first nt diagonal tiles of an
    augmented stack; checksum and pad rows never hold pivots): 1 + the
    global index of the first bad pivot — non-finite or non-positive for
    Cholesky, zero or non-finite for LU — else 0."""
    mt_s, nt_s = t.shape[0], t.shape[1]
    g = torch.arange(nt, device=t.device)
    dtiles = t[(g % p) * (mt_s // p) + g // p, (g % q) * (nt_s // q) + g // q]
    dvals = torch.diagonal(dtiles, dim1=-2, dim2=-1)
    if lu:
        bad = ~torch.isfinite(dvals.abs()) | (dvals == 0)
    else:
        dvals = dvals.real
        bad = ~torch.isfinite(dvals) | (dvals <= 0)
    gidx = g[:, None] * nb + torch.arange(nb, device=t.device)[None, :] + 1
    big = nt * nb + 1
    info = torch.where(bad, gidx, big).min()
    return torch.where(info >= big, 0, info).to(torch.int32)


# ---------------------------------------------------------------------------
# checksum-carrying distributed triangular solve: the weighted column sums
# of B ride as extra right-hand-side tile columns, so the solve produces X
# augmented with its own column checksums (op(A) X_ck = B_ck and X_ck = X W
# by linearity) on the unchanged TrsmB schedule.
# ---------------------------------------------------------------------------


def _ft_trsm(at, bt, p, q, nt, uplo, op, diag, la, slots) -> None:
    """``dist_trsm._trsm_b`` in place on ``bt`` with the fault hooks:
    ``bcast`` rots one device's received A-panel copy, ``trailing`` /
    ``panel`` one stored B/X tile right after step k's update lands."""

    def on_pan(k, pan):
        hits = _bcast_hits(slots, k)
        return _rot_received(pan, hits, p, q) if hits else pan

    def on_step(k, b_loc):
        for f in slots:
            if f.phase in (PH_TRAIL, PH_PANEL) and f.k == k:
                _hit4(b_loc, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)

    _trsm_b(at, bt, p, q, nt, uplo, op, diag, la, on_pan=on_pan, on_step=on_step)


def _encode_trsm_rhs(a: torch.Tensor, b: torch.Tensor, nb: int, mesh):
    """Pad B to A's padded row extent, tile-pad its columns, and append
    the CSR weighted column-checksum tile columns (the solution-checksum
    carrier).  Pad rows of the identity-padded A solve to exact zeros."""
    n = a.shape[0]
    mt = padded_tiles(n, nb, mesh)
    N = mt * nb
    ntb = max(1, -(-int(b.shape[1]) // nb))
    Nc = ntb * nb
    bp = cks.pad_dense(b, N, Nc)
    return torch.cat([bp, cks.col_checksums(bp, nb)], dim=1), mt, ntb


def _trsm_residual(out: torch.Tensor, nb: int, N: int, Nc: int):
    """(X, carried column checksums minus recomputed X column sums)."""
    x = out[:N, :Nc]
    dc = out[:N, Nc:Nc + CSR * nb] - cks.col_checksums(x, nb)
    return x, dc


def trsm_ft(
    a, b, mesh: VirtualMesh, nb: int = 256, uplo=None, op=None, diag=None,
    policy: FtPolicy = FtPolicy.Correct, lookahead=None, bcast_impl=None,
    _rerun: bool = False,
):
    """ABFT distributed triangular solve op(A) X = B (left side, TrsmB
    schedule).  Returns (dense X, FtReport); raises FtError per policy.

    Detection: the carried solution checksums X_ck (solved alongside as
    extra RHS columns) are differenced against the recomputed column sums
    of X.  A corrupted ALREADY-SOLVED tile is final data — the unit-weight
    discrepancy restores it exactly (rounding included); a corrupted
    not-yet-solved tile (or a received-panel fault) feeds later
    substitution steps and escalates to one recompute, then ``FtError`` if
    the rerun still verifies dirty."""
    uplo = uplo or Uplo.Lower
    op = op or Op.NoTrans
    diag = diag or Diag.NonUnit
    if op == Op.ConjTrans:
        raise ValueError("trsm_ft covers NoTrans/Trans (real data)")
    a = torch.as_tensor(a, device=mesh.device)
    b = torch.as_tensor(b, device=mesh.device)
    if a.dim() != 2 or a.shape[0] != a.shape[1] or b.shape[0] != a.shape[0]:
        raise ValueError(f"trsm_ft shape mismatch: A {tuple(a.shape)}, B {tuple(b.shape)}")
    if policy == FtPolicy.Off:
        ad = from_dense(a, mesh, nb, diag_pad_one=True)
        bd = from_dense(b, mesh, nb)
        x = trsm_dist(ad, bd, uplo, op, diag, method=MethodTrsm.TrsmB,
                      lookahead=lookahead, bcast_impl=bcast_impl)
        return to_dense(x)[: a.shape[0], : b.shape[1]], FtReport(op="trsm")
    n, ncols = int(a.shape[0]), int(b.shape[1])
    p, q = mesh_shape(mesh)
    b_aug, mt, ntb = _encode_trsm_rhs(a, b, nb, mesh)
    ad = from_dense(a, mesh, nb, diag_pad_one=True)
    bd = from_dense(b_aug, mesh, nb)
    m_aug, n_aug = b_aug.shape
    del b_aug
    ints, vals = inject.spec_arrays("trsm")
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        _ft_trsm(ad.tiles, bd.tiles, p, q, mt, uplo, op, diag, la_depth(lookahead, mt),
                 _slots(ints, vals))
    inject.consume("trsm")
    out = to_dense(DistMatrix(tiles=bd.tiles, m=m_aug, n=n_aug, nb=nb, mesh=mesh))
    del ad, bd
    N, Nc = mt * nb, ntb * nb
    x, dc = _trsm_residual(out, nb, N, Nc)
    fmax = max(1.0, cks.finite_max(x), cks.finite_max(b))
    tol1 = cks.threshold(N, x.dtype, ntb * fmax)
    tol2 = cks.threshold(N, x.dtype, ntb * ntb * fmax)
    verdC = _verdict_rows(dc, nb, ntb, tol1, tol2, "X-tile")
    report = FtReport(op="trsm")
    if verdC.clean:
        return x[:n, :ncols], report
    dets = verdC.detections
    count("ft.detected", "trsm", len(dets))
    if policy == FtPolicy.Detect:
        raise FtError("trsm", "corruption detected (policy=detect)", dets)
    if policy == FtPolicy.Correct and not _rerun:
        # exact repair, valid only for damage in an ALREADY-SOLVED tile:
        # one flagged tile row, one located column — add the unit
        # discrepancy back and let re-verification judge it
        if len(verdC.flagged) == 1 and verdC.located != {-1}:
            (i_star,) = verdC.flagged
            (j_star,) = verdC.located
            fixed = x.clone()
            _add_row_disc(fixed, dc, nb, int(i_star), int(j_star))
            dc2 = out[:N, Nc:Nc + CSR * nb] - cks.col_checksums(fixed, nb)
            if _verdict_rows(dc2, nb, ntb, tol1, tol2, "X-tile").clean:
                count("ft.corrected", "trsm", len(dets))
                report.action, report.detections = "corrected", dets
                return fixed[:n, :ncols], report
    if _rerun:
        count("ft.uncorrectable", "trsm")
        raise FtError("trsm", "recompute still fails verification", dets)
    # live-data corruption (the fault fed later substitution steps):
    # one full recompute — transient faults have disarmed
    count("ft.recomputed", "trsm")
    del out, x, dc
    out2, rep2 = trsm_ft(a, b, mesh, nb, uplo, op, diag, policy, lookahead,
                         bcast_impl, _rerun=True)
    rep2.action = "recomputed"
    rep2.detections = dets + rep2.detections
    return out2, rep2


# ---------------------------------------------------------------------------
# encoders
# ---------------------------------------------------------------------------


def _encode_factor(a: torch.Tensor, nb: int, mesh, with_cols: bool):
    """Square factorization input -> checksum-augmented dense, with the
    grid padding + identity pad diagonal applied BEFORE encoding so the
    checksums cover exactly what the kernel factors."""
    n = a.shape[0]
    mt = padded_tiles(n, nb, mesh)
    N = mt * nb
    ap = cks.pad_dense(a, N, N)
    if N > n:
        d = torch.arange(n, N, device=a.device)
        ap[d, d] = 1
    csr = cks.row_checksums(ap, nb)
    if not with_cols:
        return torch.cat([ap, csr], dim=0), mt, N
    csc = cks.col_checksums(ap, nb)
    cross = cks.col_checksums(csr, nb)
    return torch.cat([torch.cat([ap, csc], dim=1), torch.cat([csr, cross], dim=1)], dim=0), mt, N


def _encode_gemm(a, b, c, nb: int, mesh):
    """A gains checksum rows, B checksum columns, C (the accumulator)
    both — checksums are linear, so alpha A_aug B_aug + beta C_aug is the
    augmentation of alpha A B + beta C.  A zero C (``c`` None) is not
    materialized: C_aug is None."""
    mt = padded_tiles(a.shape[0], nb, mesh)
    kt = padded_tiles(a.shape[1], nb, mesh)
    nt = padded_tiles(b.shape[1], nb, mesh)
    Nm, Kp, Nn = mt * nb, kt * nb, nt * nb
    ap = cks.pad_dense(a, Nm, Kp)
    bp = cks.pad_dense(b, Kp, Nn)
    a_aug = torch.cat([ap, cks.row_checksums(ap, nb)], dim=0)
    del ap
    b_aug = torch.cat([bp, cks.col_checksums(bp, nb)], dim=1)
    del bp
    c_aug = None
    if c is not None:
        cp = cks.pad_dense(c, Nm, Nn)
        crow = cks.row_checksums(cp, nb)
        c_aug = torch.cat([torch.cat([cp, cks.col_checksums(cp, nb)], dim=1),
                           torch.cat([crow, cks.col_checksums(crow, nb)], dim=1)], dim=0)
    return a_aug, b_aug, c_aug, mt, kt, nt


# ---------------------------------------------------------------------------
# verification: carried checksums minus recomputed tile sums, on the device
# ---------------------------------------------------------------------------


def _gemm_residual(out: torch.Tensor, nb: int, mt: int, nt: int):
    Nm, Nn = mt * nb, nt * nb
    cdata = out[:Nm, :Nn]
    dr = out[Nm:Nm + CSR * nb, :Nn] - cks.row_checksums(cdata, nb)
    dc = out[:Nm, Nn:Nn + CSR * nb] - cks.col_checksums(cdata, nb)
    return cdata, dr, dc


def _potrf_residual(out: torch.Tensor, nb: int, mt: int) -> torch.Tensor:
    N = mt * nb
    return out[N:N + CSR * nb, :N] - cks.row_checksums(torch.tril(out[:N, :N]), nb)


def _lu_residual(out: torch.Tensor, nb: int, mt: int):
    N = mt * nb
    lu = out[:N, :N]
    l_eff = torch.tril(lu, -1)
    l_eff.diagonal().fill_(1)
    dr = out[N:N + CSR * nb, :N] - cks.row_checksums(l_eff, nb)
    del l_eff
    dc = out[:N, N:N + CSR * nb] - cks.col_checksums(torch.triu(lu), nb)
    return dr, dc


def _host(x: torch.Tensor) -> np.ndarray:
    """A small device tensor on the host; bf16 (which numpy lacks) widens
    to f32 exactly."""
    x = x.detach()
    return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()


def _tile_disc_cols(dr: torch.Tensor, nb: int):
    """(2nb, N) row-checksum residual -> per-tile-column (d1, d2) maxes,
    reduced on the device, (2, nt) brought to the host."""
    nt = dr.shape[1] // nb
    d = _host(dr.abs().reshape(2, nb, nt, nb).amax(dim=(1, 3)))
    return d[0], d[1]


def _tile_disc_rows(dc: torch.Tensor, nb: int):
    mt = dc.shape[0] // nb
    d = _host(dc.abs().reshape(mt, nb, 2, nb).amax(dim=(1, 3)))
    return d[:, 0], d[:, 1]


def _col_block(dr: torch.Tensor, nb: int, j: int, weighted: bool) -> torch.Tensor:
    base = nb if weighted else 0
    return dr[base:base + nb, j * nb:(j + 1) * nb]


def _row_block(dc: torch.Tensor, nb: int, i: int, weighted: bool) -> torch.Tensor:
    base = nb if weighted else 0
    return dc[i * nb:(i + 1) * nb, base:base + nb]


class _Verdict:
    """One side's verification outcome: flagged tile indices + located
    cross index (the corrupted row for column flags, vice versa)."""

    def __init__(self, flagged, located, detections):
        self.flagged = list(flagged)
        self.located = located
        self.detections = detections

    @property
    def clean(self):
        return not self.flagged


def _verdict_cols(dr: torch.Tensor, nb: int, axis_len: int, tol1, tol2, kind) -> _Verdict:
    d1, d2 = _tile_disc_cols(dr, nb)
    flagged = sorted(set(cks.flag_mismatches(d1, tol1)) | set(cks.flag_mismatches(d2, tol2)))
    located, dets = set(), []
    for j in flagged:
        i_star = cks.ratio_locate(_host(_col_block(dr, nb, j, False)),
                                  _host(_col_block(dr, nb, j, True)), axis_len)
        located.add(i_star)
        dets.append({"kind": kind, "where": (i_star, int(j)), "magnitude": float(d1[j])})
    return _Verdict(flagged, located, dets)


def _verdict_rows(dc: torch.Tensor, nb: int, axis_len: int, tol1, tol2, kind) -> _Verdict:
    d1, d2 = _tile_disc_rows(dc, nb)
    flagged = sorted(set(cks.flag_mismatches(d1, tol1)) | set(cks.flag_mismatches(d2, tol2)))
    located, dets = set(), []
    for i in flagged:
        j_star = cks.ratio_locate(_host(_row_block(dc, nb, i, False)),
                                  _host(_row_block(dc, nb, i, True)), axis_len)
        located.add(j_star)
        dets.append({"kind": kind, "where": (int(i), j_star), "magnitude": float(d1[i])})
    return _Verdict(flagged, located, dets)


def _add_col_disc(data: torch.Tensor, dr: torch.Tensor, nb: int, i: int, j: int, mask=None):
    """Exact repair: the unit-weight discrepancy of column j IS the
    negated error of the (single) corrupted tile (i, j) — add it back."""
    blk = _col_block(dr, nb, j, False)
    if mask is not None:
        blk = blk * mask
    data[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] += blk


def _add_row_disc(data: torch.Tensor, dc: torch.Tensor, nb: int, i: int, j: int, mask=None):
    blk = _row_block(dc, nb, i, False)
    if mask is not None:
        blk = blk * mask
    data[i * nb:(i + 1) * nb, j * nb:(j + 1) * nb] += blk


# ---------------------------------------------------------------------------
# factorization drivers: encode -> augmented kernel -> verify -> repair
# ---------------------------------------------------------------------------


def _factor_verify(op: str, out: torch.Tensor, nb: int, mt: int):
    """Verdicts for a factor run: carried vs recomputed checksums of the
    output factor(s), thresholded at the dtype's accumulated-rounding
    scale.  Returns (row verdict, col verdict | None, dr, dc | None)."""
    N = mt * nb
    fmax = max(1.0, cks.finite_max(out[:N, :N]))
    tol1 = cks.threshold(N, out.dtype, mt * fmax)
    tol2 = cks.threshold(N, out.dtype, mt * mt * fmax)
    if op == "getrf_nopiv":
        dr, dc = _lu_residual(out, nb, mt)
        return (_verdict_cols(dr, nb, mt, tol1, tol2, "L-tile"),
                _verdict_rows(dc, nb, mt, tol1, tol2, "U-tile"), dr, dc)
    dr = _potrf_residual(out, nb, mt)
    return _verdict_cols(dr, nb, mt, tol1, tol2, "L-tile"), None, dr, None


def _factor_try_repair(out, dr, dc, verdR, verdC, nb, mt, is_lu):
    """Exact algebraic repair, valid only for damage in FINALIZED factor
    tiles: a single located tile row on the L side (resp. column on the
    U side), each flagged column's unit-weight discrepancy added back.
    Returns the repaired full tensor, or None when the pattern indicates
    propagated (live-data) corruption — the recompute class."""
    okR = verdR.clean or (verdR.located != {-1} and len(verdR.located) == 1)
    okC = verdC is None or verdC.clean or (verdC.located != {-1} and len(verdC.located) == 1)
    if not (okR and okC):
        return None
    fixed = out.clone()
    N = mt * nb
    data = fixed[:N, :N]
    ones = torch.ones((nb, nb), dtype=out.dtype, device=out.device)
    if not verdR.clean:
        i_star = next(iter(verdR.located))
        for j in verdR.flagged:
            if i_star < j:
                return None  # L damage must sit at/below the diagonal
            mask = None
            if i_star == j:  # diag tile: only the L part of the packed tile
                mask = torch.tril(ones, -1 if is_lu else 0)
            _add_col_disc(data, dr, nb, i_star, int(j), mask)
    if verdC is not None and not verdC.clean:
        j_star = next(iter(verdC.located))
        for i in verdC.flagged:
            if j_star < i:
                return None  # U damage must sit at/above the diagonal
            mask = torch.triu(ones) if int(i) == j_star else None
            _add_row_disc(data, dc, nb, int(i), j_star, mask)
    return fixed


def _factor_result(out: torch.Tensor, n: int, nb: int, mesh) -> DistMatrix:
    """Crop the data region to the logical size and re-distribute with the
    factorization padding contract (the plain mesh drivers' output shape:
    downstream trsm sweeps mask by uplo)."""
    return from_dense(out[:n, :n], mesh, nb, diag_pad_one=True)


def _factor_ft(
    op: str, a, mesh: VirtualMesh, nb: int, policy: FtPolicy, lookahead,
    bcast_impl=None, panel_impl=None, _rerun: bool = False,
):
    is_lu = op == "getrf_nopiv"
    a = torch.as_tensor(a, device=mesh.device)
    if a.dim() != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"{op}_ft needs a square matrix, got {tuple(a.shape)}")
    n = a.shape[0]
    p, q = mesh_shape(mesh)
    aug, mt, _N = _encode_factor(a, nb, mesh, with_cols=is_lu)
    d = from_dense(aug, mesh, nb)
    m_aug, n_aug = aug.shape
    del aug
    ints, vals = inject.spec_arrays(op)
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)):
        (_ft_lu if is_lu else _ft_potrf)(d.tiles, p, q, mt, la_depth(lookahead, mt),
                                         _slots(ints, vals))
    info = _diag_info(d.tiles, p, q, nb, mt, is_lu)
    inject.consume(op)
    out = to_dense(DistMatrix(tiles=d.tiles, m=m_aug, n=n_aug, nb=nb, mesh=mesh))
    del d
    if int(info) != 0:
        # The factorization itself reports breakdown (non-SPD / singular
        # pivot).  The factor is NaN/garbage past the bad pivot, so the
        # checksum verify cannot distinguish legitimate breakdown from a
        # fault that CAUSED the breakdown — one recompute separates them:
        # a transient fault vanishes on the rerun, a genuinely bad matrix
        # fails again and is returned with the plain driver's semantics
        # (caller checks info; never FtError for honest numerics).
        if _rerun:
            return _factor_result(out, n, nb, mesh), info, FtReport(op=op)
        del out
        res2, info2, rep2 = _factor_ft(op, a, mesh, nb, policy, lookahead, bcast_impl,
                                       panel_impl, _rerun=True)
        if int(info2) == 0:  # first breakdown was fault-induced
            count("ft.detected", op)
            if policy == FtPolicy.Detect:
                raise FtError(op, "fault-induced breakdown (policy=detect)")
            count("ft.recomputed", op)
            rep2.action = "recomputed"
        return res2, info2, rep2
    verdR, verdC, dr, dc = _factor_verify(op, out, nb, mt)
    report = FtReport(op=op)
    if verdR.clean and (verdC is None or verdC.clean):
        return _factor_result(out, n, nb, mesh), info, report
    dets = verdR.detections + (verdC.detections if verdC is not None else [])
    count("ft.detected", op, len(dets))
    if policy == FtPolicy.Detect:
        raise FtError(op, "corruption detected (policy=detect)", dets)
    if policy == FtPolicy.Correct and not _rerun:
        fixed = _factor_try_repair(out, dr, dc, verdR, verdC, nb, mt, is_lu)
        if fixed is not None:
            v2R, v2C, _, _ = _factor_verify(op, fixed, nb, mt)
            if v2R.clean and (v2C is None or v2C.clean):
                count("ft.corrected", op, len(dets))
                report.action, report.detections = "corrected", dets
                return _factor_result(fixed, n, nb, mesh), info, report
    if _rerun:
        count("ft.uncorrectable", op)
        raise FtError(op, "recompute still fails verification", dets)
    # live-data corruption (the fault fed later panels): one full
    # recompute — transient faults have disarmed, persistent ones
    # re-detect on the rerun and escalate above
    count("ft.recomputed", op)
    del out, dr, dc
    res, info2, rep2 = _factor_ft(op, a, mesh, nb, policy, lookahead, bcast_impl, panel_impl,
                                  _rerun=True)
    rep2.action = "recomputed"
    rep2.detections = dets + rep2.detections
    return res, info2, rep2


# ---------------------------------------------------------------------------
# GEMM driver (shared verify/repair also serves the dense api path)
# ---------------------------------------------------------------------------


def _gemm_verify(out: torch.Tensor, nb: int, mt: int, nt: int, kt: int):
    cdata, dr, dc = _gemm_residual(out, nb, mt, nt)
    cmax = max(1.0, cks.finite_max(cdata))
    ops = (kt + max(mt, nt)) * nb
    verdR = _verdict_cols(dr, nb, mt, cks.threshold(ops, dr.dtype, mt * cmax),
                          cks.threshold(ops, dr.dtype, mt * mt * cmax), "C-tile")
    verdC = _verdict_rows(dc, nb, nt, cks.threshold(ops, dc.dtype, nt * cmax),
                          cks.threshold(ops, dc.dtype, nt * nt * cmax), "C-tile")
    return verdR, verdC, dr, dc


def _gemm_try_repair(out, dr, dc, verdR, verdC, nb, mt, nt):
    """GEMM output damage is always final data, so every single-row /
    single-column / single-tile pattern repairs exactly; damage confined
    to a checksum tile itself leaves the data verified by the other side
    and is repaired by rewriting the carried checksum."""
    Nm, Nn = mt * nb, nt * nb
    fixed = out.clone()
    data = fixed[:Nm, :Nn]
    if verdR.clean != verdC.clean:
        # one side clean => the data region is intact (a data-tile fault
        # flags BOTH sides); the damage hit a carried checksum tile
        if verdR.clean:
            fixed[:Nm, Nn:Nn + CSR * nb] = cks.col_checksums(data, nb)
        else:
            fixed[Nm:Nm + CSR * nb, :Nn] = cks.row_checksums(data, nb)
        return fixed
    if len(verdC.flagged) == 1:  # single corrupted tile row
        (i_star,) = verdC.flagged
        if verdR.located != {int(i_star)}:
            return None
        for j in verdR.flagged:
            _add_col_disc(data, dr, nb, int(i_star), int(j))
        # a bcast-phase fault corrupts every tile the faulty device wrote
        # at that step — including the CARRIED column-checksum tiles of
        # row i_star when that device owns them; rewrite the repaired
        # row's carried column checksums from the fixed data so
        # re-verification judges the repair, not the stale carried copy
        i0 = int(i_star) * nb
        fixed[i0:i0 + nb, Nn:] = cks.col_checksums(data[i0:i0 + nb], nb)
        return fixed
    if len(verdR.flagged) == 1:  # single corrupted tile column
        (j_star,) = verdR.flagged
        if verdC.located != {int(j_star)}:
            return None
        for i in verdC.flagged:
            _add_row_disc(data, dc, nb, int(i), int(j_star))
        j0 = int(j_star) * nb
        fixed[Nm:, j0:j0 + nb] = cks.row_checksums(data[:, j0:j0 + nb], nb)
        return fixed
    return None


def _gemm_ft(
    alpha, a, b, mesh: VirtualMesh, nb: int, beta, cin, policy: FtPolicy, lookahead,
    bcast_impl=None, panel_impl=None, _rerun: bool = False,
):
    dev = mesh.device
    a, b = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    cin = None if cin is None else torch.as_tensor(cin, device=dev)
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")
    p, q = mesh_shape(mesh)
    a_aug, b_aug, c_aug, mt, kt, nt = _encode_gemm(a, b, cin, nb, mesh)
    m_aug, n_aug = a_aug.shape[0], b_aug.shape[1]
    ad = from_dense(a_aug, mesh, nb)
    del a_aug
    bd = from_dense(b_aug, mesh, nb)
    del b_aug
    ct = None if c_aug is None else from_dense(c_aug, mesh, nb).tiles
    del c_aug
    ints, vals = inject.spec_arrays("gemm")
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)):
        out_t, online_disc = _ft_summa(ad.tiles, bd.tiles, ct, alpha, beta, p, q, kt,
                                       la_depth(lookahead, kt), mt, _slots(ints, vals))
    del ad, bd, ct
    inject.consume("gemm")
    if online_disc >= 0:
        # fused-kernel path: record the in-pass Huang-Abraham discrepancy
        # (the single-pass detector; the host verify below stays the
        # repair authority and catches post-update corruption too)
        REGISTRY.gauge_set("ft.online_disc", online_disc, op="gemm")
    out = to_dense(DistMatrix(tiles=out_t, m=m_aug, n=n_aug, nb=nb, mesh=mesh))
    del out_t
    m_out, n_out = int(a.shape[0]), int(b.shape[1])
    verdR, verdC, dr, dc = _gemm_verify(out, nb, mt, nt, kt)
    report = FtReport(op="gemm")
    if verdR.clean and verdC.clean:
        return out[:m_out, :n_out], report
    dets = verdR.detections + verdC.detections
    count("ft.detected", "gemm", len(dets))
    if policy == FtPolicy.Detect:
        raise FtError("gemm", "corruption detected (policy=detect)", dets)
    if policy == FtPolicy.Correct and not _rerun:
        fixed = _gemm_try_repair(out, dr, dc, verdR, verdC, nb, mt, nt)
        if fixed is not None:
            v2R, v2C, _, _ = _gemm_verify(fixed, nb, mt, nt, kt)
            if v2R.clean and v2C.clean:
                count("ft.corrected", "gemm", len(dets))
                report.action, report.detections = "corrected", dets
                return fixed[:m_out, :n_out], report
    if _rerun:
        count("ft.uncorrectable", "gemm")
        raise FtError("gemm", "recompute still fails verification", dets)
    count("ft.recomputed", "gemm")
    del out, dr, dc
    out2, rep2 = _gemm_ft(alpha, a, b, mesh, nb, beta, cin, policy, lookahead, bcast_impl,
                          panel_impl, _rerun=True)
    rep2.action = "recomputed"
    rep2.detections = dets + rep2.detections
    return out2, rep2


# ---------------------------------------------------------------------------
# checksum-carrying her2k / syr2k
# ---------------------------------------------------------------------------


def _ft_her2k(at, bt, alpha, p, q, kt, k_true, conj, la, nb, slots) -> torch.Tensor:
    """The her2k loop over row-augmented stacks with the fault hooks: a
    ``bcast`` fault rots one device's RECEIVED copy of A's column panel
    before its updates consume it (one tile row of that device's
    accumulator: the single-row repair class), a ``trailing`` (or
    ``panel``) fault one accumulator tile right after step k's update
    lands (final data: the GEMM class).  Returns the per-device
    accumulators."""

    def on_fetch(k, panels):
        hits = _bcast_hits(slots, k)
        if not hits:
            return panels
        (acol, a_t), b_panels = panels
        return (_rot_received(acol, hits, p, q), a_t), b_panels

    def on_step(k, acc):
        tiles = acc_tiles(acc, nb)
        for f in slots:
            if f.phase in (PH_TRAIL, PH_PANEL) and f.k == k:
                _hit4(tiles, f.ti % p, f.tj % q, f.ti // p, f.tj // q, f)

    return her2k_acc(at, bt, alpha, p, q, kt, k_true, conj, la, on_fetch, on_step)


def _encode_her2k(a: torch.Tensor, b: torch.Tensor, c, nb: int, mesh):
    """The rank-2k operands gain checksum tile ROWS; a C gains the full
    GEMM-output augmentation (row and column checksums and the cross), so
    beta C folds into the carried checksums (linearity)."""
    n, kdim = a.shape
    mt = padded_tiles(n, nb, mesh)
    kt = padded_tiles(kdim, nb, mesh)
    Nm, Kp = mt * nb, kt * nb
    ap = cks.pad_dense(a, Nm, Kp)
    bp = cks.pad_dense(b, Nm, Kp)
    a_aug = torch.cat([ap, cks.row_checksums(ap, nb)], dim=0)
    b_aug = torch.cat([bp, cks.row_checksums(bp, nb)], dim=0)
    del ap, bp
    c_aug = None
    if c is not None:
        cp = cks.pad_dense(c, Nm, Nm)
        crow = cks.row_checksums(cp, nb)
        c_aug = torch.cat([torch.cat([cp, cks.col_checksums(cp, nb)], dim=1),
                           torch.cat([crow, cks.col_checksums(crow, nb)], dim=1)], dim=0)
    return a_aug, b_aug, c_aug, mt, kt


def her2k_ft(
    alpha, a, b, mesh: VirtualMesh, nb: int = 256, beta=0.0, c=None, conj: bool = True,
    policy: FtPolicy = FtPolicy.Correct, lookahead=None, bcast_impl=None, _rerun: bool = False,
) -> Tuple[torch.Tensor, FtReport]:
    """ABFT distributed rank-2k update C = alpha A op(B) + op(alpha) B op(A)
    + beta C (conj=True: her2k; conj=False: syr2k).  Returns (dense FULL C,
    n x n, and FtReport); raises FtError per policy.  Accumulator damage is
    final data, so single row / column / tile patterns repair exactly, and
    received-panel corruption escalates to one recompute."""
    dev = mesh.device
    a, b = torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)
    c = None if c is None else torch.as_tensor(c, device=dev)
    if a.shape != b.shape:
        raise ValueError(f"her2k_ft: A and B must be same-shape, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    n = int(a.shape[0])  # the rank-2k output is square: C is n x n
    p, q = mesh_shape(mesh)
    if policy == FtPolicy.Off:
        cd = from_dense(c, mesh, nb) if c is not None else None
        out = her2k_dist(alpha, from_dense(a, mesh, nb), from_dense(b, mesh, nb), beta, cd,
                         conj=conj, full=True, lookahead=lookahead, bcast_impl=bcast_impl)
        return to_dense(out)[:n, :n], FtReport(op="her2k")
    a_aug, b_aug, c_aug, mt, kt = _encode_her2k(a, b, c, nb, mesh)
    m_aug = a_aug.shape[0]
    ad, bd = from_dense(a_aug, mesh, nb), from_dense(b_aug, mesh, nb)
    del a_aug, b_aug
    ints, vals = inject.spec_arrays("her2k")
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        acc = _ft_her2k(ad.tiles, bd.tiles, alpha, p, q, kt, int(a.shape[1]), conj,
                        la_depth(lookahead, kt), nb, _slots(ints, vals))
    del ad, bd
    inject.consume("her2k")
    out_t = tiles_of(acc, nb)
    del acc
    if c_aug is not None:
        out_t.add_(from_dense(c_aug, mesh, nb).tiles * beta)
    out = to_dense(DistMatrix(tiles=out_t, m=m_aug, n=m_aug, nb=nb, mesh=mesh))
    del out_t
    verdR, verdC, dr, dc = _gemm_verify(out, nb, mt, mt, kt)
    report = FtReport(op="her2k")
    if verdR.clean and verdC.clean:
        return out[:n, :n], report
    dets = verdR.detections + verdC.detections
    count("ft.detected", "her2k", len(dets))
    if policy == FtPolicy.Detect:
        raise FtError("her2k", "corruption detected (policy=detect)", dets)
    if policy == FtPolicy.Correct and not _rerun:
        fixed = _gemm_try_repair(out, dr, dc, verdR, verdC, nb, mt, mt)
        if fixed is not None:
            v2R, v2C, _, _ = _gemm_verify(fixed, nb, mt, mt, kt)
            if v2R.clean and v2C.clean:
                count("ft.corrected", "her2k", len(dets))
                report.action, report.detections = "corrected", dets
                return fixed[:n, :n], report
    if _rerun:
        count("ft.uncorrectable", "her2k")
        raise FtError("her2k", "recompute still fails verification", dets)
    count("ft.recomputed", "her2k")
    del out, dr, dc
    out2, rep2 = her2k_ft(alpha, a, b, mesh, nb, beta, c, conj, policy, lookahead, bcast_impl,
                          _rerun=True)
    rep2.action = "recomputed"
    rep2.detections = dets + rep2.detections
    return out2, rep2


# ---------------------------------------------------------------------------
# public drivers
# ---------------------------------------------------------------------------


def gemm_ft(
    alpha, a, b, mesh: VirtualMesh, nb: int = 256, beta=0.0, c=None,
    policy: FtPolicy = FtPolicy.Correct, lookahead=None, bcast_impl=None,
    panel_impl=None,
) -> Tuple[torch.Tensor, FtReport]:
    """ABFT SUMMA: C = alpha A B + beta C with carried checksums.  Returns
    (dense C, FtReport); raises FtError per policy.  The checksum panels
    ride the same broadcast schedule as the plain kernels, so
    ``bcast_impl`` (Option.BcastImpl) applies unchanged; ``panel_impl``
    (Option.PanelImpl) picks the fused kernel or the plain product."""
    if policy == FtPolicy.Off:
        from ..parallel.drivers import gemm_mesh

        return gemm_mesh(alpha, a, b, mesh, nb, beta, c), FtReport(op="gemm")
    return _gemm_ft(alpha, a, b, mesh, nb, beta, c, policy, lookahead, bcast_impl, panel_impl)


def potrf_ft(
    a, mesh: VirtualMesh, nb: int = 256, policy: FtPolicy = FtPolicy.Correct, lookahead=None,
    bcast_impl=None, panel_impl=None,
) -> Tuple[DistMatrix, torch.Tensor, FtReport]:
    """ABFT mesh Cholesky.  Returns (L DistMatrix, info, FtReport)."""
    if policy == FtPolicy.Off:
        from ..parallel.drivers import potrf_mesh

        l, info = potrf_mesh(a, mesh, nb)
        return l, info, FtReport(op="potrf")
    return _factor_ft("potrf", a, mesh, nb, policy, lookahead, bcast_impl, panel_impl)


def getrf_nopiv_ft(
    a, mesh: VirtualMesh, nb: int = 256, policy: FtPolicy = FtPolicy.Correct, lookahead=None,
    bcast_impl=None, panel_impl=None,
) -> Tuple[DistMatrix, torch.Tensor, FtReport]:
    """ABFT mesh LU-nopiv.  Returns (LU DistMatrix, info, FtReport)."""
    if policy == FtPolicy.Off:
        from ..parallel.drivers import getrf_nopiv_mesh

        lu, info = getrf_nopiv_mesh(a, mesh, nb)
        return lu, info, FtReport(op="getrf_nopiv")
    return _factor_ft("getrf_nopiv", a, mesh, nb, policy, lookahead, bcast_impl, panel_impl)


# opts-driven wrappers with the plain mesh-driver signatures, used by
# parallel.drivers when Option.FaultTolerance is not off


def gemm_mesh_ft(alpha, a, b, mesh, nb=256, beta=0.0, c=None,
                 opts: Optional[Options] = None) -> torch.Tensor:
    out, _ = gemm_ft(alpha, a, b, mesh, nb, beta, c, policy=resolve_policy(opts),
                     lookahead=get_option(opts, Option.Lookahead),
                     bcast_impl=get_option(opts, Option.BcastImpl),
                     panel_impl=get_option(opts, Option.PanelImpl))
    return out


def her2k_mesh_ft(alpha, a, b, mesh, nb=256, beta=0.0, c=None, conj: bool = True,
                  opts: Optional[Options] = None) -> torch.Tensor:
    out, _ = her2k_ft(alpha, a, b, mesh, nb, beta, c, conj=conj, policy=resolve_policy(opts),
                      lookahead=get_option(opts, Option.Lookahead),
                      bcast_impl=get_option(opts, Option.BcastImpl))
    return out


def potrf_mesh_ft(a, mesh, nb=256, opts: Optional[Options] = None):
    l, info, _ = potrf_ft(a, mesh, nb, policy=resolve_policy(opts),
                          lookahead=get_option(opts, Option.Lookahead),
                          bcast_impl=get_option(opts, Option.BcastImpl),
                          panel_impl=get_option(opts, Option.PanelImpl))
    return l, info


def getrf_nopiv_mesh_ft(a, mesh, nb=256, opts: Optional[Options] = None):
    lu, info, _ = getrf_nopiv_ft(a, mesh, nb, policy=resolve_policy(opts),
                                 lookahead=get_option(opts, Option.Lookahead),
                                 bcast_impl=get_option(opts, Option.BcastImpl),
                                 panel_impl=get_option(opts, Option.PanelImpl))
    return lu, info


# ---------------------------------------------------------------------------
# dense single-array ABFT (the api.multiply path: no mesh, same checks)
# ---------------------------------------------------------------------------


def gemm_checked(
    alpha, a: torch.Tensor, b: torch.Tensor, beta=0.0, c=None, nb: int = 32,
    policy: FtPolicy = FtPolicy.Detect, _rerun: bool = False,
) -> torch.Tensor:
    """Checksum-verified dense GEMM for the single-array facade: the
    product and its checksums are computed by independent products, so a
    silent corruption in either is caught by the comparison; single
    tile/row/column damage repairs exactly under ``correct``, other
    patterns (and everything under ``recompute``) re-execute once — the
    same policy ladder as the mesh drivers.  Computes on ``a``'s device."""
    dev = a.device
    b = torch.as_tensor(b, device=dev)
    m, n = int(a.shape[0]), int(b.shape[1])
    mt, kt, nt = -(-m // nb), -(-int(a.shape[1]) // nb), -(-n // nb)
    ap = cks.pad_dense(a, mt * nb, kt * nb)
    bp = cks.pad_dense(b, kt * nb, nt * nb)
    cp = (cks.pad_dense(torch.as_tensor(c, device=dev), mt * nb, nt * nb) if c is not None
          else torch.zeros((mt * nb, nt * nb), dtype=ap.dtype, device=dev))
    cdata = (alpha * _precise_matmul(ap, bp) + beta * cp).to(ap.dtype)
    crow = (alpha * _precise_matmul(cks.row_checksums(ap, nb), bp)
            + beta * cks.row_checksums(cp, nb)).to(ap.dtype)
    ccol = (alpha * _precise_matmul(ap, cks.col_checksums(bp, nb))
            + beta * cks.col_checksums(cp, nb)).to(ap.dtype)
    out = torch.zeros((mt * nb + CSR * nb, nt * nb + CSR * nb), dtype=cdata.dtype, device=dev)
    out[:mt * nb, :nt * nb] = cdata
    out[mt * nb:, :nt * nb] = crow
    out[:mt * nb, nt * nb:] = ccol
    verdR, verdC, dr, dc = _gemm_verify(out, nb, mt, nt, kt)
    if verdR.clean and verdC.clean:
        return cdata[:m, :n]
    dets = verdR.detections + verdC.detections
    count("ft.detected", "gemm_dense", len(dets))
    if policy == FtPolicy.Detect:
        raise FtError("gemm_dense", "corruption detected (policy=detect)", dets)
    if policy == FtPolicy.Correct and not _rerun:
        fixed = _gemm_try_repair(out, dr, dc, verdR, verdC, nb, mt, nt)
        if fixed is not None:
            v2R, v2C, _, _ = _gemm_verify(fixed, nb, mt, nt, kt)
            if v2R.clean and v2C.clean:
                count("ft.corrected", "gemm_dense", len(dets))
                return fixed[:m, :n]
    if _rerun:
        count("ft.uncorrectable", "gemm_dense")
        raise FtError("gemm_dense", "recompute still fails verification", dets)
    count("ft.recomputed", "gemm_dense")
    return gemm_checked(alpha, a, b, beta, c, nb, policy, _rerun=True)
