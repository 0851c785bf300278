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

``gbtrf_band_dist`` is the band form (src/gbtrf.cc): the partial-pivot
panel and swaps on windows that slide with k (``_pp_panel_factor`` /
``_pp_apply_swaps`` take the windows; the dense factors pass the whole
height and width), then the windowed row solve and trailing update, in
the strict schedule at every lookahead depth.

``num_monitor="on"`` (Option.NumMonitor, ``obs.numerics``) carries the
element-growth gauge through each form: max|A| of the input's true
extent, then the running max of the working array's |a| at each panel's
entry (on the bucket's window for the no-pivot loop, over the stack for
the pivoted ones, at ``slate_tpu``'s sampling points) and over the
finished factor, read back once as ``num.lu_growth``.  Its reductions are
local and no transfer is audited; the factor and the launches are the
unmonitored run's, and the no-pivot gauge is the same at every lookahead
depth (every value the strict schedule reaches is sampled at some step).
Under the flight recorder (``obs.flight``) the no-pivot loop records one
row per phase: the panel, its broadcasts (tagged ``bcast``) and the
deferred updates; a flown run records no gauge.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.span import instrument
from ..blas3.blas3 import solve_tri
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
    la_depth,
    local_indices,
    phase_scope,
    pipelined_factor_loop,
    psum_a,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view
from .dist_chol import (
    _BandWindows,
    _tile_products,
    _window_index,
    bucket_spans,
    monitored,
    num_gauge_dtype,
)
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
    with phase_scope("bcast", k):
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


def _check_square(a: DistMatrix, who: str, num_monitor) -> Tuple[int, int, bool]:
    """(p, q, monitored) of a square, identity-padded operand."""
    p, q = mesh_shape(a.mesh)
    if a.mt != a.nt:
        raise ValueError(f"{who} needs a square tile grid")
    a.require_diag_pad(who)
    return p, q, monitored(num_monitor)


class _Growth:
    """The element-growth probe over a local view (p, q, I, J, nb, nb)
    whose logical tiles are ``i_log`` (p, 1, I) / ``j_log`` (1, q, J): the
    max |a| over the true extent ``m_true`` (``slate_tpu``'s
    ``_wabs_max``), one reduction; the pad rows and columns are masked only
    when the stack has any (``nt nb > m_true``: every window reaches the
    stack's last tile)."""

    def __init__(self, i_log: torch.Tensor, j_log: torch.Tensor, nb: int, m_true: int, nt: int):
        self.mask = None
        if nt * nb > m_true:
            ar = torch.arange(nb, device=i_log.device)
            rows = (i_log[..., None] * nb + ar) < m_true  # (p, 1, I, nb)
            cols = (j_log[..., None] * nb + ar) < m_true  # (1, q, J, nb)
            self.mask = rows[:, :, :, None, :, None] & cols[:, :, None, :, None, :]

    def __call__(self, view: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.mask is None:
            return torch.linalg.vector_norm(view, float("inf")).to(dtype)
        return torch.where(self.mask, view.abs(), 0).amax().to(dtype)


def _growth_of(t: torch.Tensor, p: int, q: int, m_true: int) -> Tuple["_Growth", torch.Tensor]:
    """(the growth probe of the whole local view, that view)."""
    loc = local_view(t, p, q)
    _, _, i_log, j_log = local_indices(p, q, loc.shape[2], loc.shape[3], t.device)
    return _Growth(i_log, j_log, loc.shape[4], m_true, t.shape[1]), loc


def growth_init(t: torch.Tensor, p: int, q: int, m_true: int) -> torch.Tensor:
    """max|A| over the true extent of the input stack (the gauge pair's
    first half, and the running max's start)."""
    probe, loc = _growth_of(t, p, q, m_true)
    return probe(loc, num_gauge_dtype(t.dtype))


def growth_exit(t: torch.Tensor, p: int, q: int, m_true: int, amax0: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """(max|A|, the running max with the finished factor folded in),
    stacked for one host read (``slate_tpu``'s ``_lu_growth_out``)."""
    probe, loc = _growth_of(t, p, q, m_true)
    return torch.stack([amax0, torch.maximum(g, probe(loc, g.dtype))])


def _record_growth(op: str, t: torch.Tensor, p: int, q: int, m_true: int, amax0, g) -> None:
    from ..obs import numerics as _num

    _num.record_lu_growth(op, *growth_exit(t, p, q, m_true, amax0, g))


# ---------------------------------------------------------------------------
# no pivoting (src/getrf_nopiv.cc)
# ---------------------------------------------------------------------------


@instrument("getrf_nopiv_dist")
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
    bitwise the same at every depth and lowering.  ``num_monitor``
    (Option.NumMonitor) ``on`` records the growth gauge (module doc).
    ``overwrite_a`` factors ``a``'s tile stack in place instead of a copy."""
    p, q, nm = _check_square(a, "getrf_nopiv_dist", num_monitor)
    from ..obs import flight as _flight

    t = a.tiles if overwrite_a else a.tiles.clone()
    la, bi = la_depth(lookahead, a.nt), resolve_bcast_impl(bcast_impl)
    amax0 = growth_init(t, p, q, a.m) if nm else None
    with bcast_impl_scope(bi), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), \
            update_impl_scope(resolve_update_impl(update_impl)), \
            _flight.fly("getrf_nopiv", (p, q), nt=a.nt, depth=min(la, 1), impl=bi):
        g = _getrf_nopiv_tiles(t, p, q, a.nt, la, growth=amax0, m_true=a.m)
    info = _lu_info_dist(t, p, q, a.nb)
    if nm:
        _record_growth("getrf_nopiv", t, p, q, a.m, amax0, g)
    return DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True), info


def nopiv_flops(nt: int, nb: int):
    """Closed-form flops of the no-pivot tile LU's phases, for the flight
    recorder: ``flops(kind, j)`` of step j's panel (the nb x nb factor,
    2 nb^3 / 3, and the m = nt - 1 - j column and m row tile solves, nb^3
    each) and of its update (``full``: m^2 tile products at 2 nb^3;
    ``narrow``: row and column j + 1 of it; ``excl``: the rest).  The steps
    sum to 2 (nt nb)^3 / 3."""
    c = 2.0 * float(nb) ** 3

    def flops(kind: str, j: int) -> float:
        m = nt - 1 - j
        if kind == "panel":
            return c / 3 + m * c
        if kind == "narrow":
            return (2 * m - 1) * c if m > 0 else 0.0
        if kind == "excl":
            return (m - 1) ** 2 * c if m > 0 else 0.0
        return m * m * c

    return flops


def _getrf_nopiv_tiles(t: torch.Tensor, p: int, q: int, nt: int, la: int, k0: int = 0,
                       k1: Optional[int] = None, growth: Optional[torch.Tensor] = None,
                       m_true: int = 0) -> Optional[torch.Tensor]:
    """The bucketed, pipelined k-loop of ``slate_tpu``'s ``_lu_jit``, in
    place on the cyclic tile stack ``t``: each bucket runs on a statically
    smaller trailing window, and the deferred update drains at the bucket's
    end.  Steps [k0, k1) of it for the checkpointed chain (``ft.ckpt``).
    With a ``growth`` gauge (monitored), each panel first folds in the
    max |a| of its bucket's window over the true extent ``m_true``; returns
    the gauge."""
    loc = local_view(t, p, q)
    mtl, ntl = loc.shape[2], loc.shape[3]
    gauge = [growth]
    for ka, kb, s0r, s0c in bucket_spans(nt, p, q, k0, k1):
        view = loc[:, :, s0r:, s0c:]
        _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device, s0r, s0c)
        probe = _Growth(i_log, j_log, loc.shape[4], m_true, nt) if growth is not None else None

        def panel(k, v, i_log=i_log, j_log=j_log, s0r=s0r, s0c=s0c, probe=probe):
            if probe is not None:
                gauge[0] = torch.maximum(gauge[0], probe(v, gauge[0].dtype))
            return _nopiv_panel(v, k, p, q, i_log, j_log, s0r, s0c)

        def narrow(k, v, upd, s0r=s0r, s0c=s0c):
            return _nopiv_narrow(v, upd, k, p, q, s0r, s0c)

        def bulk(k, v, upd, s0r=s0r, s0c=s0c):
            if k is None:
                return _nopiv_bulk(v, upd)
            return _nopiv_bulk(v, upd, k // p - s0r, k // q - s0c)

        pipelined_factor_loop(ka, kb, la, panel, narrow, bulk, view, None,
                              nopiv_flops(nt, loc.shape[4]))
    return gauge[0]


# ---------------------------------------------------------------------------
# the cross-shard row swaps shared by the pivoted forms (internal_swap.cc)
# ---------------------------------------------------------------------------


def _all_slots(n_mesh: int, n_loc: int, dev) -> torch.Tensor:
    """(n_mesh, n_loc): every local slot of each mesh row or column, the
    whole-height or whole-width window of the dense factors."""
    return torch.arange(n_loc, device=dev).expand(n_mesh, n_loc)


def _tile_slots(sr: np.ndarray, nt: int, p: int, wl: int) -> np.ndarray:
    """(..., nt): each tile row's slot in its owning mesh row's window of wl
    local slots starting at ``sr`` (..., p); wl where the window misses it."""
    tiles = np.arange(nt)
    rel = tiles // p - sr[..., tiles % p]
    return np.where((rel >= 0) & (rel < wl), rel, wl)


def _swap_rows(loc: torch.Tensor, pos: np.ndarray, slot_ok: np.ndarray, pos2row: np.ndarray,
               p: int, nb: int, cols: torch.Tensor) -> None:
    """Move rows so that every position in ``pos`` (the <= 2 nb positions
    a panel's swaps touch) holds its final occupant ``pos2row[pos]``, over
    the local column slots ``cols`` (q, W) of each mesh column's swap
    window (every slot for the dense factors): one gather of the source
    rows (``slate_tpu``'s psum over the mesh rows, audited with its
    payload) and one scatter; slots not ``slot_ok`` duplicate another and
    are dropped."""
    mglob = pos2row.shape[0]
    audit(f"psum[{ROW_AXIS}]", len(pos) * cols.shape[1] * nb * loc.element_size())
    src = np.minimum(pos2row[np.minimum(pos, mglob - 1)], mglob - 1)[slot_ok]
    dst = np.minimum(pos, mglob - 1)[slot_ok]
    dev = loc.device
    st, sr = torch.from_numpy(src // nb).to(dev), torch.from_numpy(src % nb).to(dev)
    dt, dr = torch.from_numpy(dst // nb).to(dev), torch.from_numpy(dst % nb).to(dev)
    qi = torch.arange(cols.shape[0], device=dev)[None, :, None]
    # (S, q, W, nb): the source rows
    vals = loc[(st % p)[:, None, None], qi, (st // p)[:, None, None], cols[None], sr[:, None, None]]
    loc[(dt % p)[:, None, None], qi, (dt // p)[:, None, None], cols[None], dr[:, None, None]] = vals


def _flat_gids(i_log: torch.Tensor, nb: int) -> torch.Tensor:
    """Global row ids of each mesh row's local rows, (p, mtl nb)."""
    gids = i_log[:, 0, :, None] * nb + torch.arange(nb, device=i_log.device)
    return gids.reshape(i_log.shape[0], -1)


# ---------------------------------------------------------------------------
# tournament pivoting (CALU, src/getrf_tntpiv.cc)
# ---------------------------------------------------------------------------


@instrument("getrf_tntpiv_dist")
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
    p, q, nm = _check_square(a, "getrf_tntpiv_dist", num_monitor)
    t = a.tiles if overwrite_a else a.tiles.clone()
    amax0 = growth_init(t, p, q, a.m) if nm else None
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), update_impl_scope("xla"):
        perm, g = _tntpiv_tiles(t, p, q, a.nt, a.m, la_depth(lookahead, a.nt), amax0)
    info = _lu_info_dist(t, p, q, a.nb)
    if nm:
        _record_growth("getrf_tntpiv", t, p, q, a.m, amax0, g)
    return (DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True),
            torch.from_numpy(perm).to(t.device), info)


def _tntpiv_tiles(t: torch.Tensor, p: int, q: int, nt: int, m_true: int, la: int,
                  growth: Optional[torch.Tensor] = None):
    """The tournament loop in place on ``t``; returns (the row permutation,
    the growth gauge: with ``growth`` given, the running max of |a| over
    the stack at each step's entry, ``slate_tpu``'s sampling point)."""
    loc = local_view(t, p, q)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device)
    gauge = [growth]
    wabs = _Growth(i_log, j_log, nb, m_true, nt) if growth is not None else None

    def probe():
        if wabs is not None:
            gauge[0] = torch.maximum(gauge[0], wabs(loc, gauge[0].dtype))
    mglob = nt * nb
    sent = mglob  # tournament sentinel: sorts last, marks dead slots
    gids = _flat_gids(i_log, nb)
    cols = _all_slots(q, ntl, t.device)

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
        _swap_rows(loc, pos, slot_ok, pos2row, p, nb, cols)

    rowperm = np.arange(mglob)
    if la <= 0:
        for k in range(nt):
            probe()
            apply_swaps(k, tournament(k), rowperm)
            _nopiv_step(loc, k, p, q, i_log, j_log)
        return rowperm, gauge[0]
    # lookahead: refresh the panel column, run the tournament, land the rest
    # of the deferred update (the swaps move full rows), swap and factor,
    # deferring this step's own update
    upd = None
    for k in range(nt):
        probe()
        _nopiv_narrow(loc, upd, k, p, q, with_row=False)
        win = tournament(k)
        _nopiv_bulk(loc, upd, excl_kc=k // q)
        apply_swaps(k, win, rowperm)
        _, upd = _nopiv_panel(loc, k, p, q, i_log, j_log)
    _nopiv_bulk(loc, upd)
    return rowperm, gauge[0]


# ---------------------------------------------------------------------------
# partial pivoting (the reference's default, src/getrf.cc:23-200)
# ---------------------------------------------------------------------------


@instrument("getrf_pp_dist")
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
    p, q, nm = _check_square(a, "getrf_pp_dist", num_monitor)
    t = a.tiles if overwrite_a else a.tiles.clone()
    amax0 = growth_init(t, p, q, a.m) if nm else None
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), update_impl_scope("xla"):
        perm, g = _pp_tiles(t, p, q, a.nt, a.m, la_depth(lookahead, a.nt), amax0)
    info = _lu_info_dist(t, p, q, a.nb)
    if nm:
        _record_growth("getrf_pp", t, p, q, a.m, amax0, g)
    return (DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True),
            torch.from_numpy(perm).to(t.device), info)


def _pp_panel_factor(loc, k, p, q, nt, m_true, gids, win):
    """The partial-pivot panel factor on a broadcast copy of panel column
    k (the internal_getrf.cc half): ``slate_tpu``'s per-column argmax over
    each mesh row's window, the cross-row choice, the in-panel swap (a
    masked psum) and the elimination, batched over the mesh rows.  Reads
    only local column slot k // q.  ``win`` = (slots (p, wl), each tile
    row's slot in them (nt,) on the device and on the host, ``_tile_slots``)
    is each mesh row's candidate window, and ``gids`` (p, wl nb) their
    global rows: every local row slot for the dense factor, the band
    factor's sliding window.  Returns (flat (p, wl nb, nb), the pivot
    position chosen per column as a device tensor)."""
    nb = loc.shape[4]
    dev = loc.device
    mglob = nt * nb
    base, c0 = k * nb, k % q
    slots, tslot, tslot_host = win
    wl = slots.shape[1]
    slot_g = int(tslot_host[k])  # gcol's slot in mesh row k % p's window
    m_loc = wl * nb
    pcol = loc[torch.arange(p, device=dev)[:, None], c0, slots, k // q][:, None]
    pan = bcast_from_col(pcol, c0, q)  # (p, 1, wl, nb, nb)
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
        slot_p = torch.take(tslot, tile_p)  # in the owning row's window (no host read)
        own_p = (tile_p % p == rows_r) & (slot_p < wl)
        idx_p = (slot_p.clamp(max=wl - 1) * nb + piv % nb).view(1)
        # gcol lies in tile k, on mesh row k % p
        own_g = (rows_r == k % p) & (slot_g < wl)
        idx_g = min(slot_g, wl - 1) * nb + gcol % nb
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


def _pp_apply_swaps(loc, rowperm, flat, piv, k, p, q, nt, slots, cols):
    """Apply the panel's nb transpositions ``piv`` (host positions) to the
    stored rows (simulated on the host, then one row exchange over the
    swap column slots ``cols`` (q, W)) and write the factored panel into
    its row slots ``slots`` (p, wl) of the owning column: every slot for
    the dense factor, the band factor's windows.  Reads the rows as
    stored: any deferred update of those columns must be applied first."""
    nb = loc.shape[4]
    mglob = nt * nb
    base = k * nb
    pos2row = np.arange(mglob)
    for j in range(nb):
        tgt, cur = base + j, int(piv[j])
        r1, r2 = int(pos2row[tgt]), int(pos2row[cur])
        pos2row[tgt], pos2row[cur] = r2, r1
        rowperm[tgt], rowperm[cur] = rowperm[cur], rowperm[tgt]
    pos = np.concatenate([base + np.arange(nb), piv])
    slot_ok = np.concatenate([np.ones(nb, bool), piv >= base + nb])
    _swap_rows(loc, pos, slot_ok, pos2row, p, nb, cols)
    pi = torch.arange(p, device=loc.device)[:, None]
    loc[pi, k % q, slots, k // q] = flat.view(p, -1, nb, nb)


class _PPGeometry:
    """The dense partial-pivot loop's fixed indices on the local view: the
    logical tile indices, the global row ids, and the whole height and
    width as the band factor's windows (unwindowed)."""

    def __init__(self, loc: torch.Tensor, p: int, q: int, nt: int):
        mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
        dev = loc.device
        _, _, self.i_log, self.j_log = local_indices(p, q, mtl, ntl, dev)
        self.gids = _flat_gids(self.i_log, nb)
        self.rows, self.cols = _all_slots(p, mtl, dev), _all_slots(q, ntl, dev)
        tslot = _tile_slots(np.zeros(p, np.int64), nt, p, mtl)
        self.win = (self.rows, torch.from_numpy(tslot).to(dev), tslot)


def _pp_strict_steps(t: torch.Tensor, rowperm: np.ndarray, p: int, q: int, nt: int, m_true: int,
                     k0: int, k1: int, growth: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
    """Steps [k0, k1) of the partial-pivot loop in the strict schedule, in
    place on the cyclic tile stack and the host ``rowperm``: the lookahead-0
    form of :func:`_pp_tiles` and the checkpointed chain's segments
    (``ft.ckpt``).  With a ``growth`` gauge, each step's entry folds in the
    stack's max |a| over the true extent; returns the gauge."""
    loc = local_view(t, p, q)
    g = _PPGeometry(loc, p, q, nt)
    wabs = _Growth(g.i_log, g.j_log, loc.shape[4], m_true, nt) if growth is not None else None
    for k in range(k0, k1):
        if wabs is not None:
            growth = torch.maximum(growth, wabs(loc, growth.dtype))
        flat, piv_pos = _pp_panel_factor(loc, k, p, q, nt, m_true, g.gids, g.win)
        _pp_apply_swaps(loc, rowperm, flat, piv_pos.cpu().numpy(), k, p, q, nt, g.rows, g.cols)
        _nopiv_step(loc, k, p, q, g.i_log, g.j_log, panel_done=True)
    return growth


def _pp_tiles(t: torch.Tensor, p: int, q: int, nt: int, m_true: int, la: int,
              growth: Optional[torch.Tensor] = None):
    """The partial-pivot loop in place on ``t``; returns (the row
    permutation, the growth gauge as :func:`_pp_strict_steps`)."""
    nb = t.shape[-1]
    rowperm = np.arange(nt * nb)
    if la <= 0:
        growth = _pp_strict_steps(t, rowperm, p, q, nt, m_true, 0, nt, growth)
        return rowperm, growth
    loc = local_view(t, p, q)
    g = _PPGeometry(loc, p, q, nt)
    wabs = _Growth(g.i_log, g.j_log, nb, m_true, nt) if growth is not None else None
    # lookahead (getrf.cc's panel/update overlap): refresh the panel column,
    # factor it with pivoting, land the rest of the deferred update, then
    # swap full rows, solve the panel row and defer this step's update
    upd = None
    for k in range(nt):
        if wabs is not None:
            growth = torch.maximum(growth, wabs(loc, growth.dtype))
        _nopiv_narrow(loc, upd, k, p, q, with_row=False)
        flat, piv_pos = _pp_panel_factor(loc, k, p, q, nt, m_true, g.gids, g.win)
        _nopiv_bulk(loc, upd, excl_kc=k // q)
        _pp_apply_swaps(loc, rowperm, flat, piv_pos.cpu().numpy(), k, p, q, nt, g.rows, g.cols)
        _, upd = _nopiv_panel(loc, k, p, q, g.i_log, g.j_log, panel_done=True)
    _nopiv_bulk(loc, upd)
    return rowperm, growth


# ---------------------------------------------------------------------------
# band LU with partial pivoting (src/gbtrf.cc)
# ---------------------------------------------------------------------------


@instrument("gbtrf_band_dist")
def gbtrf_band_dist(
    a: DistMatrix, kl: int, ku: int, lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None, overwrite_a: bool = False,
) -> Tuple[DistMatrix, torch.Tensor, torch.Tensor]:
    """Band partial-pivot LU on the mesh at band cost (src/gbtrf.cc): the
    partial-pivot panel and swaps of :func:`getrf_pp_dist` with every phase
    windowed -- the panel's candidate rows to the wd_l = (nb - 1 + kl) //
    nb + 1 tile rows that can be nonzero (``wlr`` local slots a mesh row),
    the row swaps to the columns holding the moved rows' L history and U
    fill (up to column g + kl + ku of a row g), and the row solve and
    trailing update to the wd_l x wd_u tile window.  The factor is P A =
    L U with P over the padded row space, as :func:`getrf_pp_dist`'s, so a
    swap moves the rows' earlier multipliers too; ``slate_tpu`` starts
    every swap window at k - (wd_l - 1) and leaves behind those of a row
    moved down from above tile k (wrong once the windows are narrower than
    the grid), while here the window reaches back to the oldest of them.
    Pivots, info and U are ``slate_tpu``'s.  Total work is O(n (kl + nb)
    (kl + ku + nb)).  Returns (LU, perm over the padded row space, info).

    ``lookahead`` is accepted for API symmetry but the strict schedule runs
    at every depth, as in ``slate_tpu``: there is no read-only operand to
    prefetch (every panel reads column k as step k - 1 left it), and the
    deferred-update form is illegal, because the swap column window slides
    with k and its exclusion set would depend on the pivots chosen at run
    time.  The solves and the trailing product are inline torch ops: the
    band factor calls no hand kernel (``slate_tpu`` pins it to its XLA
    forms)."""
    p, q = mesh_shape(a.mesh)
    if a.mt != a.nt:
        raise ValueError("gbtrf_band_dist needs a square tile grid")
    a.require_diag_pad("gbtrf_band_dist")
    del lookahead  # the strict schedule at every depth (docstring)
    nb = a.nb
    wd_l = min(((nb - 1) + kl) // nb + 1, a.nt)  # rows touched per panel
    wd_u = min(((nb - 1) + kl + ku) // nb + 1, a.nt)  # U fill-in width
    # a candidate row's U fill reaches right to tile k + wd_usw - 1
    wd_usw = min(((nb - 1) + 2 * kl + ku) // nb + 1, a.nt)
    t = a.tiles if overwrite_a else a.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        perm = _gb_pp_tiles(t, p, q, a.nt, a.m, wd_l, wd_u, wd_usw)
    info = _lu_info_dist(t, p, q, nb)
    return (DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True),
            torch.from_numpy(perm).to(t.device), info)


def _gb_pp_tiles(t: torch.Tensor, p: int, q: int, nt: int, m_true: int, wd_l: int, wd_u: int,
                 wd_usw: int) -> np.ndarray:
    """``slate_tpu``'s ``_gb_pp_jit`` kernel, in place on the cyclic tile
    stack, every device of the grid at once."""
    loc = local_view(t, p, q)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    wlr = min(-(-wd_l // p) + 1, mtl)
    wlc = min(-(-wd_u // q) + 1, ntl)
    wlsw = min(-(-((wd_l - 1) + wd_usw) // q) + 1, ntl)
    dtype, dev = t.dtype, t.device
    w = _BandWindows(nt, p, q, mtl, ntl, wlr, wlc, dev)
    sw = _BandWindows(nt, p, q, mtl, ntl, wlr, wlsw, dev,
                     col_base=lambda ks: np.maximum(ks - (wd_l - 1), 0))
    gids = (w.i_win[..., None] * nb + torch.arange(nb, device=dev)).reshape(nt, p, wlr * nb)
    tslot = _tile_slots(w.sr, nt, p, wlr)  # (nt steps, nt tile rows)
    tslot_dev = torch.from_numpy(tslot).to(dev)
    eye = torch.eye(nb, dtype=dtype, device=dev)
    pi, qi = w.pi, w.qi
    c_h = np.arange(q)
    rowperm = np.arange(nt * nb)
    for k in range(nt):
        r0, c0, kr, kc = k % p, k % q, k // p, k // q
        # the shared pivot panel and swaps, windowed to the band: candidate
        # rows in tiles [k, k + wd_l), a swapped row's nonzeros in tiles
        # [k_lo, k + wd_usw)
        flat, piv_pos = _pp_panel_factor(loc, k, p, q, nt, m_true, gids[k],
                                         (w.rows[k], tslot_dev[k], tslot[k]))
        piv = piv_pos.cpu().numpy()
        # A row's L history starts at the first step it was a candidate,
        # tile(original row) - (wd_l - 1).  slate_tpu starts every swap
        # window at k - (wd_l - 1), which misses the history of a row an
        # earlier step moved down from above tile k, leaving stale
        # multipliers (P A != L U once the windows are narrower than the
        # grid); the window here reaches the oldest history of the rows moved.
        moved = rowperm[np.concatenate([k * nb + np.arange(nb), piv])]
        k_lo = max(0, min(k, int(moved.min()) // nb) - (wd_l - 1))
        if k_lo == max(k - (wd_l - 1), 0):
            cols = sw.cols[k]  # slate_tpu's window
        else:
            width = min(-(-((k - k_lo) + wd_usw) // q) + 1, ntl)
            start = np.clip((k_lo - c_h + q - 1) // q, 0, ntl - width)
            cols = torch.from_numpy(start[:, None] + np.arange(width)).to(dev)
        _pp_apply_swaps(loc, rowperm, flat, piv, k, p, q, nt, w.rows[k], cols)
        # the windowed tail: the row solve on the owning mesh row, then the
        # trailing update of the (wlr, wlc) window
        luk = bcast_diag_tile(loc, k, p, q)[0, 0]
        ridx = (r0, qi[:, None], kr, w.cols[k])  # the owning row's window: (q, wlc)
        roww = loc[ridx]
        usolved = solve_tri((luk.tril(-1) + eye).expand_as(roww), roww, upper=False, left=True,
                            unitriangular=True)
        right = (w.j_win[k] > k)[..., None, None]
        newrow = torch.where(right, usolved, roww)
        loc[ridx] = newrow
        colw = loc[pi[:, None], c0, w.rows[k], kc]  # the owning column's window: (p, wlr)
        below = (w.i_win[k] > k)[..., None, None]
        pan = bcast_from_col(torch.where(below, colw, 0)[:, None], c0, q)
        urow = bcast_from_row(torch.where(right, newrow, 0)[None], r0, p)
        idx = _window_index(w, k)
        loc[idx] = loc[idx] - _tile_products(pan, urow)
    return rowperm


# ---------------------------------------------------------------------------
# pivot application (getrs's row motion)
# ---------------------------------------------------------------------------


@instrument("permute_rows_dist")
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
