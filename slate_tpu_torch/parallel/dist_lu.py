"""Distributed right-looking LU over the block-cyclic virtual mesh: no
pivoting, tournament pivoting (CALU) and partial pivoting.

Counterpart of ``slate_tpu/parallel/dist_lu.py`` (the reference's
``src/getrf_nopiv.cc``, ``src/getrf_tntpiv.cc`` and ``src/getrf.cc`` with
``internal_swap.cc``'s cross-rank row motion).  Per step k:

- the diagonal tile reaches every device (``comm.bcast_diag_tile``); the
  owning mesh column factors it and solves its panel column
  (``Option.PanelImpl``: ``ops.kernels.lu_panel_tiles`` -- the hand-written
  diagonal-block kernel and the tile-GEMM -- or the recursive tile LU and a
  ``torch.linalg`` triangular solve); the owning mesh row solves its panel
  row (``lu_rowsolve_tiles`` or a unit triangular solve);
- the panel column goes along the mesh columns, the panel row along the
  mesh rows, and every device subtracts their product from its trailing
  tiles (``Option.UpdateImpl``: ``ops.kernels.lu_trailing_update``, one
  tile-GEMM launch over the whole grid, or one batched ``torch.matmul``
  per step, the counterpart of ``slate_tpu``'s einsum).

On one card a panel is computed once, on the owning mesh column or row:
one launch per step, where each of ``slate_tpu``'s p * q devices runs its
own.  The no-pivot LU runs ``slate_tpu``'s bucketed, pipelined loop
(``comm.bucket_plan``, ``comm.pipelined_factor_loop``).  The tournament
and partial-pivot forms prepend the pivot search and the cross-shard row
swaps and keep ``slate_tpu``'s pins: their trailing update is the batched
``torch.matmul`` form under every ``Option.UpdateImpl``, the tournament
(``linalg.lu._tournament_reduce``) and the partial-pivot column factor are
torch ops (``slate_tpu`` has no Pallas kernel there either), and the row
swaps are simulated on the host from the pivot ids (one small transfer per
step) and applied to the tile stack by one gather and one scatter.

Lookahead is bitwise: on the card the narrow refreshes of the no-pivot LU
run through the same tile-GEMM as the bulk update, whose per-element sum
does not depend on which tiles a launch covers; the ``torch.matmul`` form
computes a step's full-grid product once and lets the narrow and bulk
halves each subtract their share of it.

``num_monitor="on"`` (the in-carry growth gauges) and the flight
recorder's step dispatch come with the observability slice;
``gbtrf_band_dist`` with the band slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..linalg.lu import _getrf_nopiv_rec, _tournament_reduce
from ..ops.kernels import (
    lu_panel_tiles,
    lu_rowsolve_tiles,
    lu_trailing_update,
    panel_engaged,
    panel_impl_scope,
    resolve_panel_impl,
    resolve_update_impl,
    update_engaged,
    update_impl_scope,
)
from .comm import (
    ROW_AXIS,
    all_gather_a,
    audit,
    bcast_diag_tile,
    bcast_from_col,
    bcast_from_row,
    bcast_impl_scope,
    bucket_plan,
    la_depth,
    local_indices,
    pipelined_factor_loop,
    psum_a,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view
from .dist_chol import _check_num_monitor
from .mesh import mesh_shape

_LOW = (torch.bfloat16, torch.float16)


# ---------------------------------------------------------------------------
# the phases of one right-looking step (shared by the three forms)
# ---------------------------------------------------------------------------


class _Update:
    """A step's deferred trailing update: ``pan`` (p, 1, I, nb, nb), each
    mesh row's solved panel column (zeros off the rows below the step),
    and ``urow`` (1, q, J, nb, nb), each mesh column's solved panel row.
    ``pan`` may also hold every device's own received copy, (p, q, I, nb,
    nb) (``ft.abft`` materializes it on a step a broadcast fault is armed
    for).  The ``torch.matmul`` form computes their full-grid product once
    (:meth:`product`) and subtracts it in shares."""

    def __init__(self, pan: torch.Tensor, urow: torch.Tensor):
        self.pan, self.urow = pan, urow
        self._prod = None

    def product(self) -> torch.Tensor:
        """pan[r, i] @ urow[c, j] for every tile pair, (p, q, I, J, nb, nb):
        one product of each mesh row's (I nb, nb) panel with each mesh
        column's (nb, J nb) row, batched over the grid."""
        if self._prod is None:
            p, pq, i_n, nb, _ = self.pan.shape
            q, j_n = self.urow.shape[1], self.urow.shape[2]
            a = self.pan.reshape(p, pq, i_n * nb, nb)
            b = self.urow.permute(0, 1, 3, 2, 4).reshape(1, q, nb, j_n * nb)
            prod = torch.matmul(a, b)  # (p, q, I nb, J nb)
            self._prod = prod.view(p, q, i_n, nb, j_n, nb).permute(0, 1, 2, 4, 3, 5)
        return self._prod


def _lu_panel_factor_solve(dtile: torch.Tensor, pcol: torch.Tensor):
    """Diagonal-tile no-pivot LU + panel-column solves ``pcol[...] U^-1``,
    by Option.PanelImpl: the fused panel (kernel on the card; bf16 through
    f32, as ``slate_tpu``'s ``_lu_cast``) or the recursive tile LU and a
    triangular solve."""
    dtype = dtile.dtype
    if panel_engaged(dtype):
        if dtype in _LOW:
            lu32, solved32 = lu_panel_tiles(dtile.float(), pcol.float())
            return lu32.to(dtype), solved32.to(dtype)
        return lu_panel_tiles(dtile, pcol)
    luk = _getrf_nopiv_rec(dtile)  # packed L\U, unit L diagonal implicit
    solved = torch.linalg.solve_triangular(luk.triu(), pcol, upper=True, left=False)
    return luk, solved


def _lu_panel_rowsolve(luk: torch.Tensor, prow: torch.Tensor) -> torch.Tensor:
    """Panel-row solve ``L_kk^-1 prow[...]``, dispatched like the column
    half (the fused unit-L^-1 kernel under pallas/auto)."""
    dtype = luk.dtype
    if panel_engaged(dtype):
        if dtype in _LOW:
            return lu_rowsolve_tiles(luk.float(), prow.float()).to(dtype)
        return lu_rowsolve_tiles(luk, prow)
    return torch.linalg.solve_triangular(luk, prow, upper=False, left=True, unitriangular=True)


def _nopiv_panel_compute(view, k, p, q, i_log, j_log, roff=0, coff=0, panel_done=False):
    """Compute half of the step-k panel phase, in place on ``view`` (a
    trailing window (p, q, I, J, nb, nb) starting at local slot (roff,
    coff); i_log (p, 1, I) and j_log (1, q, J) its logical tile indices):
    diagonal factor + panel column solve on the owning mesh column, panel
    row solve on the owning mesh row, written back.  ``panel_done`` skips
    the factor and the column solve (the partial-pivot panel did them).
    Returns (view, (pan_own, urow_own)): the solved panel column and row,
    zero on the finished tiles."""
    kr, kc = k // p - roff, k // q - coff
    r0, c0 = k % p, k % q
    below = (i_log > k)[..., None, None]  # (p, 1, I, 1, 1)
    pcol = view[:, c0:c0 + 1, :, kc]  # the owning column's slots: (p, 1, I, nb, nb)
    if panel_done:
        # the diagonal tile already holds the packed L\U of the panel factor
        luk = bcast_diag_tile(view, k, p, q, roff, coff)[0, 0]
        newcol = pcol
    else:
        dtile = bcast_diag_tile(view, k, p, q, roff, coff)[0, 0]
        luk, lsolved = _lu_panel_factor_solve(dtile, pcol)
        on_d = (i_log == k)[..., None, None]
        newcol = torch.where(below, lsolved, torch.where(on_d, luk, pcol))
        pcol.copy_(newcol)
    prow = view[r0:r0 + 1, :, kr]  # the owning row's slots: (1, q, J, nb, nb)
    usolved = _lu_panel_rowsolve(luk, prow)
    right = (j_log > k)[..., None, None]  # (1, q, J, 1, 1)
    newrow = torch.where(right, usolved, prow)
    prow.copy_(newrow)
    return view, (torch.where(below, newcol, 0), torch.where(right, newrow, 0))


def _nopiv_panel_bcast(own, k, p, q) -> _Update:
    """Broadcast half: the panel column along the mesh columns, the panel
    row along the mesh rows (listBcast right + down, getrf_nopiv.cc)."""
    pan_own, urow_own = own
    return _Update(bcast_from_col(pan_own, k % q, q), bcast_from_row(urow_own, k % p, p))


def _nopiv_panel(view, k, p, q, i_log, j_log, roff=0, coff=0, panel_done=False):
    """Panel phase of one step (factor, solves, broadcasts); the trailing
    update is returned as an :class:`_Update` for the caller to apply."""
    view, own = _nopiv_panel_compute(view, k, p, q, i_log, j_log, roff, coff, panel_done)
    return view, _nopiv_panel_bcast(own, k, p, q)


def _nopiv_narrow(view, upd: Optional[_Update], k, p, q, roff=0, coff=0, with_row=True):
    """Apply a deferred update to exactly the tile slots the step-k panel
    reads: local column slot k // q (all rows) and, when ``with_row``,
    local row slot k // p (all columns but the one the column covered).
    ``upd`` None is the zero update of a loop's first step."""
    if upd is None:
        return view
    kr, kc = k // p - roff, k // q - coff
    if update_engaged(view.dtype):
        ones = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=view.device)
        lu_trailing_update(view[:, :, :, kc:kc + 1], upd.pan, upd.urow[:, :, kc:kc + 1], ones)
        if with_row:
            keep = (torch.arange(view.shape[3], device=view.device) != kc).view(1, 1, 1, -1)
            lu_trailing_update(view[:, :, kr:kr + 1], upd.pan[:, :, kr:kr + 1], upd.urow, keep)
        return view
    prod = upd.product()
    view[:, :, :, kc].sub_(prod[:, :, :, kc])
    if with_row:
        prod[:, :, kr, kc] = 0  # refreshed by the column piece
        view[:, :, kr].sub_(prod[:, :, kr])
    return view


def _nopiv_bulk(view, upd: Optional[_Update], excl_kr=None, excl_kc=None):
    """Apply a deferred update everywhere ``_nopiv_narrow`` did not (no
    exclusions: the whole strict-schedule update), by Option.UpdateImpl:
    one ``lu_trailing_update`` launch with the exclusions as its keep mask,
    or the rest of the full-grid product."""
    if upd is None:
        return view
    if update_engaged(view.dtype):
        keep = torch.ones(view.shape[2:4], dtype=torch.bool, device=view.device)
        if excl_kc is not None:
            keep[:, excl_kc] = False
        if excl_kr is not None:
            keep[excl_kr, :] = False
        lu_trailing_update(view, upd.pan, upd.urow, keep[None, None])
        return view
    prod = upd.product()
    if excl_kc is not None:
        prod[:, :, :, excl_kc] = 0
    if excl_kr is not None:
        prod[:, :, excl_kr] = 0
    view.sub_(prod)
    return view


def _nopiv_step(view, k, p, q, i_log, j_log, roff=0, coff=0, panel_done=False):
    """One full step in the strict schedule: panel, then the whole
    trailing update (the depth-0 form the pipelined loops reproduce)."""
    view, upd = _nopiv_panel(view, k, p, q, i_log, j_log, roff, coff, panel_done)
    return _nopiv_bulk(view, upd)


def _lu_info_dist(t: torch.Tensor, p: int, q: int, nb: int) -> torch.Tensor:
    """info: 1 + global index of the first zero or non-finite U diagonal
    entry, 0 if none (getrf.cc:102-104)."""
    mt, nt = t.shape[0], t.shape[1]
    g = torch.arange(nt, device=t.device)
    dtiles = t[(g % p) * (mt // p) + g // p, (g % q) * (nt // q) + g // q]  # (nt, nb, nb)
    dvals = torch.diagonal(dtiles, dim1=-2, dim2=-1)
    bad = ~torch.isfinite(dvals.abs()) | (dvals == 0)
    gidx = g[:, None] * nb + torch.arange(nb, device=t.device)[None, :] + 1
    big = nt * nb + 1
    info = torch.where(bad, gidx, big).min()
    return torch.where(info >= big, 0, info).to(torch.int32)


def _check_square(a: DistMatrix, who: str, num_monitor) -> Tuple[int, int]:
    p, q = mesh_shape(a.mesh)
    if a.mt != a.nt:
        raise ValueError(f"{who} needs a square tile grid")
    a.require_diag_pad(who)
    _check_num_monitor(num_monitor, who)
    return p, q


# ---------------------------------------------------------------------------
# no pivoting (src/getrf_nopiv.cc)
# ---------------------------------------------------------------------------


def getrf_nopiv_dist(
    a: DistMatrix, lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None, panel_impl: Optional[str] = None,
    update_impl: Optional[str] = None, num_monitor: Optional[str] = None,
    overwrite_a: bool = False,
) -> Tuple[DistMatrix, torch.Tensor]:
    """Factor A = L U without pivoting (packed L\\U tiles).  Returns (LU,
    info), info an int32 tensor: 0, or 1 + the global index of the first
    zero or non-finite U diagonal.

    ``lookahead`` (Option.Lookahead; None = 1), ``bcast_impl``
    (Option.BcastImpl), ``panel_impl`` (Option.PanelImpl) and
    ``update_impl`` (Option.UpdateImpl) as in ``slate_tpu``; results are
    bitwise the same at every depth and lowering.  ``overwrite_a`` factors
    ``a``'s tile stack in place instead of a copy."""
    p, q = _check_square(a, "getrf_nopiv_dist", num_monitor)
    t = a.tiles if overwrite_a else a.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), \
            update_impl_scope(resolve_update_impl(update_impl)):
        _getrf_nopiv_tiles(t, p, q, a.nt, la_depth(lookahead, a.nt))
    info = _lu_info_dist(t, p, q, a.nb)
    return DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True), info


def _getrf_nopiv_tiles(t: torch.Tensor, p: int, q: int, nt: int, la: int) -> None:
    """The bucketed, pipelined k-loop of ``slate_tpu``'s ``_lu_jit``, in
    place on the cyclic tile stack ``t``: each bucket runs on a statically
    smaller trailing window, and the deferred update drains at the bucket's
    end."""
    loc = local_view(t, p, q)
    mtl, ntl = loc.shape[2], loc.shape[3]
    for k0, k1, s0r, s0c in bucket_plan(nt, p, q):
        view = loc[:, :, s0r:, s0c:]
        _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device, s0r, s0c)

        def panel(k, v, i_log=i_log, j_log=j_log, s0r=s0r, s0c=s0c):
            return _nopiv_panel(v, k, p, q, i_log, j_log, s0r, s0c)

        def narrow(k, v, upd, s0r=s0r, s0c=s0c):
            return _nopiv_narrow(v, upd, k, p, q, s0r, s0c)

        def bulk(k, v, upd, s0r=s0r, s0c=s0c):
            if k is None:
                return _nopiv_bulk(v, upd)
            return _nopiv_bulk(v, upd, k // p - s0r, k // q - s0c)

        pipelined_factor_loop(k0, k1, la, panel, narrow, bulk, view, None)


# ---------------------------------------------------------------------------
# the cross-shard row swaps shared by the pivoted forms (internal_swap.cc)
# ---------------------------------------------------------------------------


def _swap_rows(loc: torch.Tensor, pos: np.ndarray, slot_ok: np.ndarray, pos2row: np.ndarray,
               p: int, nb: int) -> None:
    """Move full rows so that every position in ``pos`` (the <= 2 nb
    positions a panel's swaps touch) holds its final occupant
    ``pos2row[pos]``: one gather of the source rows (``slate_tpu``'s psum
    over the mesh rows, audited with its payload) and one scatter; slots
    not ``slot_ok`` duplicate another and are dropped."""
    mglob = pos2row.shape[0]
    ntl = loc.shape[3]
    audit(f"psum[{ROW_AXIS}]", len(pos) * ntl * nb * loc.element_size())
    src = np.minimum(pos2row[np.minimum(pos, mglob - 1)], mglob - 1)[slot_ok]
    dst = np.minimum(pos, mglob - 1)[slot_ok]
    dev = loc.device
    st, sr = torch.from_numpy(src // nb).to(dev), torch.from_numpy(src % nb).to(dev)
    dt, dr = torch.from_numpy(dst // nb).to(dev), torch.from_numpy(dst % nb).to(dev)
    vals = loc[st % p, :, st // p, :, sr, :]  # (S, q, ntl, nb): the source rows
    loc[dt % p, :, dt // p, :, dr, :] = vals


def _flat_gids(i_log: torch.Tensor, nb: int) -> torch.Tensor:
    """Global row ids of each mesh row's local rows, (p, mtl nb)."""
    gids = i_log[:, 0, :, None] * nb + torch.arange(nb, device=i_log.device)
    return gids.reshape(i_log.shape[0], -1)


# ---------------------------------------------------------------------------
# tournament pivoting (CALU, src/getrf_tntpiv.cc)
# ---------------------------------------------------------------------------


def getrf_tntpiv_dist(
    a: DistMatrix, lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None, panel_impl: Optional[str] = None,
    num_monitor: Optional[str] = None, overwrite_a: bool = False,
) -> Tuple[DistMatrix, torch.Tensor, torch.Tensor]:
    """Factor P A = L U with tournament pivoting across the mesh.

    Returns (LU, perm, info): ``perm`` is the global row permutation over
    the PADDED row space (length mt * nb; rows >= a.m are pad fixed
    points), row i of PA is original row perm[i].  Per step: each mesh
    row's tournament over its slice of the panel column, an all_gather
    of the winners over the mesh rows and one more round, the winners
    swapped in, then the no-pivot step on the pivoted panel
    (``panel_impl`` picks its lowering; the trailing update is pinned to
    the ``torch.matmul`` form, as ``slate_tpu`` pins it to xla).
    ``lookahead`` >= 1 defers each step's update past the next tournament;
    bitwise the same at every depth."""
    p, q = _check_square(a, "getrf_tntpiv_dist", num_monitor)
    t = a.tiles if overwrite_a else a.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), update_impl_scope("xla"):
        perm = _tntpiv_tiles(t, p, q, a.nt, a.m, la_depth(lookahead, a.nt))
    info = _lu_info_dist(t, p, q, a.nb)
    return (DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True),
            torch.from_numpy(perm).to(t.device), info)


def _tntpiv_tiles(t: torch.Tensor, p: int, q: int, nt: int, m_true: int, la: int) -> np.ndarray:
    loc = local_view(t, p, q)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device)
    mglob = nt * nb
    sent = mglob  # tournament sentinel: sorts last, marks dead slots
    gids = _flat_gids(i_log, nb)

    def tournament(k) -> np.ndarray:
        """Local tournaments of the owning column's mesh rows, the merge
        of their winners over the mesh rows, the winner ids broadcast
        along the mesh columns.  Reads only local column slot k // q."""
        base, c0 = k * nb, k % q
        flat = loc[:, c0, :, k // q].reshape(p, mtl * nb, nb)
        valid = (gids >= base) & (gids < m_true)
        cand = torch.where(valid[..., None], flat, 0)
        ids = torch.where(valid, gids, sent)
        vloc, iloc = _tournament_reduce(cand, ids, nb, sent)  # (p, nb, nb), (p, nb)
        ga = all_gather_a(vloc[:, None], ROW_AXIS, p).reshape(1, p * nb, nb)
        gi = all_gather_a(iloc[:, None], ROW_AXIS, p).reshape(1, p * nb)
        _, win = _tournament_reduce(ga, gi, nb, sent)
        return bcast_from_col(win[None], c0, q)[0, 0].cpu().numpy()

    def apply_swaps(k, win: np.ndarray, rowperm: np.ndarray) -> None:
        """The LAPACK-style sequential swaps (swap j brings winner win[j],
        wherever earlier swaps of the panel moved it, to position
        base + j), simulated on the host, then the full-row exchange."""
        base = k * nb
        pos2row = np.arange(mglob)
        row2pos = np.arange(mglob)
        for j in range(nb):
            b = int(win[j])
            if b >= sent:
                continue
            tgt, cur = base + j, int(row2pos[b])
            r1, r2 = int(pos2row[tgt]), int(pos2row[cur])
            pos2row[tgt], pos2row[cur] = r2, r1
            row2pos[r2], row2pos[r1] = tgt, cur
            rowperm[tgt], rowperm[cur] = rowperm[cur], rowperm[tgt]
        # every position a swap can touch is in base..base+nb or a winner's
        # original position; winners inside block k (or sentinels) duplicate
        # a first-half slot
        pos = np.concatenate([base + np.arange(nb), win])
        slot_ok = np.concatenate([np.ones(nb, bool), (win >= base + nb) & (win < sent)])
        _swap_rows(loc, pos, slot_ok, pos2row, p, nb)

    rowperm = np.arange(mglob)
    if la <= 0:
        for k in range(nt):
            apply_swaps(k, tournament(k), rowperm)
            _nopiv_step(loc, k, p, q, i_log, j_log)
        return rowperm
    # lookahead: refresh the panel column, run the tournament, land the rest
    # of the deferred update (the swaps move full rows), swap and factor,
    # deferring this step's own update
    upd = None
    for k in range(nt):
        _nopiv_narrow(loc, upd, k, p, q, with_row=False)
        win = tournament(k)
        _nopiv_bulk(loc, upd, excl_kc=k // q)
        apply_swaps(k, win, rowperm)
        _, upd = _nopiv_panel(loc, k, p, q, i_log, j_log)
    _nopiv_bulk(loc, upd)
    return rowperm


# ---------------------------------------------------------------------------
# partial pivoting (the reference's default, src/getrf.cc:23-200)
# ---------------------------------------------------------------------------


def getrf_pp_dist(
    a: DistMatrix, lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None, panel_impl: Optional[str] = None,
    num_monitor: Optional[str] = None, overwrite_a: bool = False,
) -> Tuple[DistMatrix, torch.Tensor, torch.Tensor]:
    """Factor P A = L U with classic partial (per-column argmax) pivoting.

    Per panel column j: each mesh row's largest |v| at or below the
    diagonal, an all_gather of (|v|, row id) over the mesh rows, the
    winner (ties: the smallest global row; no candidate: the diagonal row
    itself), the in-panel swap and the rank-1 elimination; then the nb
    transpositions move full rows across the shards, and the step ends
    with the panel-row solve (``panel_impl``) and the trailing update
    (pinned to the ``torch.matmul`` form).  Returns (LU, perm over the
    padded row space, info), as :func:`getrf_tntpiv_dist`; bitwise the same
    at every lookahead depth."""
    p, q = _check_square(a, "getrf_pp_dist", num_monitor)
    t = a.tiles if overwrite_a else a.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), update_impl_scope("xla"):
        perm = _pp_tiles(t, p, q, a.nt, a.m, la_depth(lookahead, a.nt))
    info = _lu_info_dist(t, p, q, a.nb)
    return (DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True),
            torch.from_numpy(perm).to(t.device), info)


def _pp_panel_factor(loc, k, p, q, nt, m_true, gids):
    """The partial-pivot panel factor on a broadcast copy of panel column
    k (the internal_getrf.cc half): ``slate_tpu``'s per-column argmax over
    each mesh row's window, the cross-row choice, the in-panel swap (a
    masked psum) and the elimination, batched over the mesh rows.  Reads
    only local column slot k // q.  Returns (flat (p, mtl nb, nb), the
    pivot position chosen per column as a device tensor)."""
    mtl, nb = loc.shape[2], loc.shape[4]
    dev = loc.device
    mglob = nt * nb
    base, c0 = k * nb, k % q
    m_loc = mtl * nb
    pan = bcast_from_col(loc[:, c0:c0 + 1, :, k // q], c0, q)  # (p, 1, mtl, nb, nb)
    flat = pan[:, 0].reshape(p, m_loc, nb).clone()
    rows_r = torch.arange(p, device=dev)
    col_ids = torch.arange(nb, device=dev)
    piv_pos = torch.zeros(nb, dtype=torch.int64, device=dev)
    neg_one = torch.tensor(-1.0, dtype=flat.real.dtype, device=dev)  # |a|'s real dtype
    for j in range(nb):
        gcol = base + j
        colv = flat[:, :, j]
        active = (gids >= gcol) & (gids < m_true)
        absv = torch.where(active, colv.abs(), neg_one)
        li = torch.argmax(absv, dim=-1, keepdim=True)  # (p, 1): each row's first maximum
        lv = absv.gather(1, li)
        lgid = gids.gather(1, li)
        all_gather_a(lv, ROW_AXIS, p)  # the candidates, as slate_tpu gathers them
        all_gather_a(lgid, ROW_AXIS, p)
        maxv = lv.max()
        # ties -> the smallest global row; no active candidate -> gcol itself
        piv = torch.where(lv == maxv, lgid, mglob).min()
        piv = torch.where(maxv < 0, gcol, torch.clamp(piv, max=mglob - 1))
        piv_pos[j] = piv

        # in-panel swap of rows piv <-> gcol (slate_tpu: a masked psum)
        tile_p = piv // nb
        slot_p = tile_p // p
        own_p = (tile_p % p == rows_r) & (slot_p < mtl)
        idx_p = (slot_p.clamp(max=mtl - 1) * nb + piv % nb).view(1)
        tile_g, slot_g = gcol // nb, (gcol // nb) // p
        own_g = (rows_r == tile_g % p) & (slot_g < mtl)
        idx_g = min(slot_g, mtl - 1) * nb + gcol % nb
        vp = torch.where(own_p[:, None], flat.index_select(1, idx_p)[:, 0], 0)
        vg = torch.where(own_g[:, None], flat[:, idx_g], 0)
        rows2 = psum_a(torch.stack([vp, vg], dim=1)[:, None], ROW_AXIS, p)[0, 0]  # (2, nb)
        row_piv, row_gcol = rows2[0], rows2[1]
        cur = flat.index_select(1, idx_p)[:, 0]
        flat.index_copy_(1, idx_p, torch.where(own_p[:, None], row_gcol, cur)[:, None])
        flat[:, idx_g] = torch.where(own_g[:, None], row_piv, flat[:, idx_g])

        # eliminate below gcol: multipliers + rank-1 update
        pivval = row_piv[j]
        safe = torch.where(pivval == 0, torch.ones_like(pivval), pivval)
        belowr = gids > gcol
        colj = flat[:, :, j]
        mult = torch.where(belowr, colj / safe, 0)
        flat[:, :, j] = torch.where(belowr, mult, colj)
        urow = torch.where(col_ids > j, row_piv, 0)
        flat = flat - mult[..., None] * urow
    return flat, piv_pos


def _pp_apply_swaps(loc, rowperm, flat, piv_pos, k, p, q, nt):
    """Apply the panel's nb transpositions to the stored rows (simulated on
    the host, then one full-row exchange) and write the factored panel
    into the owning column.  Reads full rows: any deferred update must be
    applied first."""
    nb = loc.shape[4]
    mglob = nt * nb
    base = k * nb
    piv = piv_pos.cpu().numpy()
    pos2row = np.arange(mglob)
    for j in range(nb):
        tgt, cur = base + j, int(piv[j])
        r1, r2 = int(pos2row[tgt]), int(pos2row[cur])
        pos2row[tgt], pos2row[cur] = r2, r1
        rowperm[tgt], rowperm[cur] = rowperm[cur], rowperm[tgt]
    pos = np.concatenate([base + np.arange(nb), piv])
    slot_ok = np.concatenate([np.ones(nb, bool), piv >= base + nb])
    _swap_rows(loc, pos, slot_ok, pos2row, p, nb)
    loc[:, k % q, :, k // q] = flat.view(flat.shape[0], -1, nb, nb)


def _pp_tiles(t: torch.Tensor, p: int, q: int, nt: int, m_true: int, la: int) -> np.ndarray:
    loc = local_view(t, p, q)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device)
    gids = _flat_gids(i_log, nb)
    rowperm = np.arange(nt * nb)
    if la <= 0:
        for k in range(nt):
            flat, piv_pos = _pp_panel_factor(loc, k, p, q, nt, m_true, gids)
            _pp_apply_swaps(loc, rowperm, flat, piv_pos, k, p, q, nt)
            _nopiv_step(loc, k, p, q, i_log, j_log, panel_done=True)
        return rowperm
    # lookahead (getrf.cc's panel/update overlap): refresh the panel column,
    # factor it with pivoting, land the rest of the deferred update, then
    # swap full rows, solve the panel row and defer this step's update
    upd = None
    for k in range(nt):
        _nopiv_narrow(loc, upd, k, p, q, with_row=False)
        flat, piv_pos = _pp_panel_factor(loc, k, p, q, nt, m_true, gids)
        _nopiv_bulk(loc, upd, excl_kc=k // q)
        _pp_apply_swaps(loc, rowperm, flat, piv_pos, k, p, q, nt)
        _, upd = _nopiv_panel(loc, k, p, q, i_log, j_log, panel_done=True)
    _nopiv_bulk(loc, upd)
    return rowperm


# ---------------------------------------------------------------------------
# pivot application (getrs's row motion)
# ---------------------------------------------------------------------------


def permute_rows_dist(b: DistMatrix, perm) -> DistMatrix:
    """B <- P B for a global row permutation over the padded row space:
    row g of the result is row perm[g] of B.  ``slate_tpu`` all_gathers B
    over the mesh rows (audited here with its payload); on one card each
    device's rows are one gather.  Returns a new tile stack."""
    p, q = mesh_shape(b.mesh)
    mglob = b.mt * b.nb
    perm = torch.as_tensor(perm, device=b.tiles.device)
    if tuple(perm.shape) != (mglob,):
        raise ValueError(
            f"permute_rows_dist: perm must cover the padded row space "
            f"({mglob},), got {tuple(perm.shape)}"
        )
    loc = local_view(b.tiles, p, q)  # (p, q, mtl, ntl, nb, nb)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], b.nb
    all_gather_a(loc, ROW_AXIS, p)
    _, _, i_log, _ = local_indices(p, q, mtl, ntl, b.tiles.device)
    g = i_log[:, 0, :, None] * nb + torch.arange(nb, device=b.tiles.device)  # my dest rows
    src = perm.to(torch.int64)[g]  # (p, mtl, nb)
    st, sr = src // nb, src % nb
    new = loc[st % p, :, st // p, :, sr, :]  # (p, mtl, nb, q, ntl, nb)
    out = torch.empty_like(b.tiles)
    local_view(out, p, q).copy_(new.permute(0, 3, 1, 4, 2, 5))
    return DistMatrix(tiles=out, m=b.m, n=b.n, nb=b.nb, mesh=b.mesh, diag_pad=b.diag_pad)
