"""Distributed right-looking Cholesky over the block-cyclic virtual mesh.

Counterpart of ``potrf_dist`` in ``slate_tpu/parallel/dist_chol.py`` (the
reference's ``src/potrf.cc``).  Per step k: the diagonal tile reaches every
device (``comm.bcast_diag_tile``), the owning mesh column factors it and
solves its panel column (``Option.PanelImpl``: the hand-written
``ops.kernels.chol_panel_tiles`` or the ``torch.linalg`` pair), the panel is
broadcast along the mesh columns and gathered transposed over the mesh
rows, and every device applies the masked herk to its trailing tiles
(``Option.UpdateImpl``: ``ops.kernels.chol_trailing_update``, one tile-GEMM
launch over the whole grid, or its batched-matmul twin).

The k-range runs in ``comm.BUCKETS`` buckets on statically shrinking
trailing windows of the local stacks, and ``Option.Lookahead`` defers each
step's update into the next step (``comm.pipelined_factor_loop``): the
column slot the next panel reads is refreshed first (``_chol_narrow``), the
rest after the panel (``_chol_bulk``).  On the card both halves go through
the same tile-GEMM, whose per-element arithmetic does not depend on which
tiles a launch covers, so results are bitwise the same at every depth.

``pbtrf_band_dist`` is the band form (``slate_tpu``'s ``_pbtrf_band_jit``,
src/pbtrf.cc): the same right-looking step, with every phase confined to a
window of ``wlr`` local row slots and ``wlc`` local column slots that
slides with k, so the tiles outside the band envelope (beyond slot
rounding) are never read or written.  Its windowed solves and products are
torch ops, as ``slate_tpu`` computes them outside Pallas.

The port factors the tile stack in place (``overwrite_a=True``) or in a
copy (the default: ``slate_tpu``'s functional semantics, one more copy of
the matrix).  ``num_monitor="on"`` (Option.NumMonitor, ``obs.numerics``)
carries the near-breakdown margin through the loop: the smallest
Schur-complement diagonal entry of the true extent, each pivot tile's
diagonal read at its own panel's entry (a strict-schedule value at every
lookahead depth, so the gauge is depth-invariant), and at exit the final
factor's diagonal min / max, read back once as ``num.chol_*``.  It reads
one tile's diagonal per step and makes no audited transfer; the factor
and the launches are the unmonitored run's.  Under the flight recorder
(``obs.flight``) the same loop records one row per phase: the panel
(diagonal broadcast, factor and solves), its broadcast (the column
broadcast and the transposed gather, tagged ``bcast``) and the deferred
updates; a flown run records no gauge, as in ``slate_tpu``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..obs.span import instrument
from ..blas3.blas3 import solve_tri
from ..linalg.chol import _cholesky, _ht
from ..ops.kernels import (
    chol_panel_tiles,
    chol_trailing_update,
    chol_trailing_update_plain,
    panel_engaged,
    panel_impl_scope,
    resolve_panel_impl,
    resolve_update_impl,
    update_engaged,
    update_impl_scope,
)
from ..ops.matmul import _tf32_scope
from ..types import Precision
from .comm import (
    ROW_AXIS,
    all_gather_a,
    bcast_diag_tile,
    bcast_from_col,
    bcast_impl_scope,
    bucket_plan,
    la_depth,
    local_indices,
    phase_scope,
    pipelined_factor_loop,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view
from .mesh import mesh_shape


def monitored(num_monitor: Optional[str]) -> bool:
    """Whether a driver runs monitored: Option.NumMonitor resolved by
    ``obs.numerics.resolve_num_monitor`` (a ValueError for an unknown
    mode), and off under the flight recorder's step dispatch, whose rows
    carry no gauge (``slate_tpu``'s per-phase programs carry none)."""
    from ..obs import flight as _flight
    from ..obs.numerics import resolve_num_monitor

    return resolve_num_monitor(num_monitor) == "on" and not _flight.step_dispatch_active()


def num_gauge_dtype(dtype: torch.dtype) -> torch.dtype:
    """The gauges' dtype: real, and at least f32 so bf16 / f16 runs do not
    saturate the running extrema (``slate_tpu``'s ``num_gauge_dtype``)."""
    rdt = torch.empty((), dtype=dtype).real.dtype
    return torch.float32 if rdt in (torch.bfloat16, torch.float16) else rdt


def margin_init(dtype: torch.dtype, device) -> torch.Tensor:
    """The margin gauge before any step: +inf."""
    return torch.full((), float("inf"), dtype=num_gauge_dtype(dtype), device=device)


def chol_exit_gauges(t: torch.Tensor, p: int, q: int, nb: int, n_true: int,
                     margin: torch.Tensor) -> torch.Tensor:
    """(margin, min, max of the final factor's diagonal over the true
    extent), stacked on the device for one host read."""
    mt, nt = t.shape[0], t.shape[1]
    g = torch.arange(nt, device=t.device)
    dtiles = t[(g % p) * (mt // p) + g // p, (g % q) * (nt // q) + g // q]
    dvals = torch.diagonal(dtiles, dim1=-2, dim2=-1).real.to(margin.dtype)
    ok = (g[:, None] * nb + torch.arange(nb, device=t.device)[None, :]) < n_true
    lmin = torch.where(ok, dvals, float("inf")).min()
    lmax = torch.where(ok, dvals, float("-inf")).max()
    return torch.stack([margin, lmin, lmax])


@instrument("potrf_dist")
def potrf_dist(
    a: DistMatrix, lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None, panel_impl: Optional[str] = None,
    num_monitor: Optional[str] = None, update_impl: Optional[str] = None,
    overwrite_a: bool = False,
) -> Tuple[DistMatrix, torch.Tensor]:
    """Factor A = L L^H (lower).  ``a`` holds the lower triangle (upper tile
    content ignored).  Returns (L as DistMatrix, info), info an int32
    tensor: 0, or 1 + the global index of the first bad pivot.

    ``lookahead`` (Option.Lookahead; None = 1), ``bcast_impl``
    (Option.BcastImpl), ``panel_impl`` (Option.PanelImpl) and
    ``update_impl`` (Option.UpdateImpl) as in ``slate_tpu``.
    ``num_monitor`` (Option.NumMonitor): ``on`` records the margin and
    diagonal gauges (module doc); the factor is the same bits.
    ``overwrite_a`` factors ``a``'s tile stack in place instead of a copy."""
    p, q = mesh_shape(a.mesh)
    if a.mt != a.nt:
        raise ValueError("potrf_dist needs a square tile grid")
    a.require_diag_pad("potrf_dist")
    nm = monitored(num_monitor)
    from ..obs import flight as _flight

    t = a.tiles if overwrite_a else a.tiles.clone()
    la, bi = la_depth(lookahead, a.nt), resolve_bcast_impl(bcast_impl)
    margin = margin_init(t.dtype, t.device) if nm else None
    with bcast_impl_scope(bi), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), \
            update_impl_scope(resolve_update_impl(update_impl)), \
            _flight.fly("potrf", (p, q), nt=a.nt, depth=min(la, 1), impl=bi):
        margin = _potrf_tiles(t, p, q, a.nt, la, margin=margin, n_true=a.n)
    info = _chol_info_dist(t, p, q, a.nb)
    if nm:
        from ..obs import numerics as _num

        _num.record_chol_gauges("potrf", *chol_exit_gauges(t, p, q, a.nb, a.n, margin))
    return DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True), info


def _chol_panel_factor_solve(dtile: torch.Tensor, pcol: torch.Tensor, cplx: bool):
    """Diagonal-tile factor + panel tile solves ``pcol[...] L_kk^-H``, by
    Option.PanelImpl: the fused panel (kernel on the card; bf16 through
    f32, as ``slate_tpu``) or the torch.linalg cholesky + triangular
    solve."""
    dtype = dtile.dtype
    low = dtype in (torch.bfloat16, torch.float16)
    if panel_engaged(dtype):
        if low:
            lkk32, solved32 = chol_panel_tiles(dtile.float(), pcol.float())
            return lkk32.to(dtype), solved32.to(dtype)
        return chol_panel_tiles(dtile, pcol)
    lkk = _cholesky(dtile.float()).to(dtype) if low else _cholesky(dtile)
    lkk_h = lkk.conj().T if cplx else lkk.T
    solved = torch.linalg.solve_triangular(lkk_h, pcol, upper=True, left=False)
    return lkk, solved


def _chol_info_dist(t: torch.Tensor, p: int, q: int, nb: int) -> torch.Tensor:
    """info: 1 + global index of the first non-finite or non-positive
    diagonal entry over the diagonal tiles, 0 if none (``slate_tpu``'s
    per-device min + pmin, as one min over the grid)."""
    mt, nt = t.shape[0], t.shape[1]
    g = torch.arange(nt, device=t.device)
    dtiles = t[(g % p) * (mt // p) + g // p, (g % q) * (nt // q) + g // q]  # (nt, nb, nb)
    dvals = torch.diagonal(dtiles, dim1=-2, dim2=-1).real
    bad = ~torch.isfinite(dvals) | (dvals <= 0)
    gidx = g[:, None] * nb + torch.arange(nb, device=t.device)[None, :] + 1
    big = nt * nb + 1
    info = torch.where(bad, gidx, big).min()
    return torch.where(info >= big, 0, info).to(torch.int32)


def _trailing(view, pan, pan_t, mask, cplx: bool):
    """``view -= mask ? pan @ pan_t^H : 0`` by Option.UpdateImpl: the
    tile-GEMM wrapper (kernel on the card, twin on the host) or the plain
    batched-matmul form; complex keeps the plain form with the conjugate
    (``slate_tpu``'s einsum)."""
    if not cplx and update_engaged(view.dtype):
        return chol_trailing_update(view, pan, pan_t, mask)
    return chol_trailing_update_plain(view, pan, pan_t.conj() if cplx else pan_t, mask)


def _phases(p, q, i_log, j_log, roff, coff, cplx):
    """Panel / narrow / bulk phases of one right-looking step on a trailing
    window whose local slot (0, 0) is local slot (roff, coff) of the
    stacks; i_log (p, 1, I) and j_log (1, q, J) are its logical tile
    indices.  The update payload is (pan (p, 1, I, nb, nb) per mesh row,
    pan_t (1, q, J, nb, nb) per mesh column)."""
    lower = i_log[:, :, :, None] >= j_log[:, :, None, :]  # (p, q, I, J)

    def panel(k, view):
        kc = k // q - coff
        c0 = k % q
        dtile = bcast_diag_tile(view, k, p, q, roff, coff)[0, 0]
        pcol = view[:, c0:c0 + 1, :, kc]  # the owning column's slots: (p, 1, I, nb, nb)
        lkk, solved = _chol_panel_factor_solve(dtile, pcol, cplx)
        below = (i_log > k)[..., None, None]
        on_diag = (i_log == k)[..., None, None]
        newcol = torch.where(below, solved, torch.where(on_diag, lkk, pcol))
        pcol.copy_(newcol)
        with phase_scope("bcast", k):
            pan = bcast_from_col(torch.where(below, newcol, 0), c0, q)
            allpan = all_gather_a(pan, ROW_AXIS, p)[0, 0]  # (p, I, nb, nb): every row's panel
            # logical row j sits at slot j // p - roff of mesh row j % p;
            # columns below the window's row cut are finished (j <= k): zeros
            slot = j_log // p - roff
            pan_t = allpan[j_log % p, slot.clamp(min=0)]  # (1, q, J, nb, nb)
            pan_t = torch.where((slot >= 0)[..., None, None], pan_t, 0)
        return view, (pan, pan_t)

    def narrow(k, view, payload):
        """The deferred step-(k-1) herk on the one column slot panel(k)
        reads: the same per-tile products as the bulk, on a J = 1 slice."""
        pan, pan_t = payload
        kc = k // q - coff
        _trailing(view[:, :, :, kc:kc + 1], pan, pan_t[:, :, kc:kc + 1],
                  lower[:, :, :, kc:kc + 1], cplx)
        return view

    def bulk(k, view, payload):
        pan, pan_t = payload
        mask = lower
        if k is not None:  # the column slot narrow(k) refreshed is done
            keep = torch.arange(lower.shape[3], device=lower.device) != k // q - coff
            mask = lower & keep
        _trailing(view, pan, pan_t, mask, cplx)
        return view

    return panel, narrow, bulk


def bucket_spans(nt: int, p: int, q: int, k0: int = 0, k1: Optional[int] = None):
    """The steps [k0, k1) cut by ``comm.bucket_plan``: (ka, kb, s0r, s0c) for
    every bucket they meet, each span on its bucket's trailing window."""
    k1 = nt if k1 is None else k1
    for b0, b1, s0r, s0c in bucket_plan(nt, p, q):
        ka, kb = max(b0, k0), min(b1, k1)
        if ka < kb:
            yield ka, kb, s0r, s0c


def potrf_flops(nt: int, nb: int):
    """Closed-form flops of the tile Cholesky's phases, for the flight
    recorder: ``flops(kind, j)`` of step j's panel (the nb x nb factor,
    nb^3 / 3, and the m = nt - 1 - j tile solves, nb^3 each) and of its
    update (``full``: m diagonal tiles at nb^3 and m (m - 1) / 2 others at
    2 nb^3; ``narrow``: column j + 1 of it; ``excl``: the rest).  The steps
    sum to (nt nb)^3 / 3."""
    c = float(nb) ** 3

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


def _potrf_tiles(t: torch.Tensor, p: int, q: int, nt: int, la: int, k0: int = 0,
                 k1: Optional[int] = None, margin: Optional[torch.Tensor] = None,
                 n_true: int = 0) -> Optional[torch.Tensor]:
    """The bucketed, pipelined k-loop of ``slate_tpu``'s ``_potrf_jit``, in
    place on the cyclic tile stack ``t``; steps [k0, k1) of it (the
    checkpointed chain's segments, ``ft.ckpt``), each on the window of the
    bucket that holds it.  With a ``margin`` gauge (monitored), each step's
    panel first folds in its pivot tile's diagonal over the true extent
    ``n_true``; returns the gauge.

    The pivot tile's own diagonal is the whole of ``slate_tpu``'s probe
    (the minimum over every not-yet-factored diagonal): a Schur-complement
    diagonal only decreases from step to step (each update subtracts a sum
    of squares), so every tile's smallest value is the one its own panel
    reads."""
    loc = local_view(t, p, q)  # (p, q, mtl, ntl, nb, nb)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    cplx = t.is_complex()
    gauge = [margin]
    for ka, kb, s0r, s0c in bucket_spans(nt, p, q, k0, k1):
        view = loc[:, :, s0r:, s0c:]
        _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device, s0r, s0c)
        panel, narrow, bulk = _phases(p, q, i_log, j_log, s0r, s0c, cplx)
        if margin is not None:
            panel = _margin_probe(panel, gauge, p, q, nb, s0r, s0c, n_true)
        zero_pl = (torch.zeros((1, 1, mtl - s0r, nb, nb), dtype=t.dtype, device=t.device),
                   torch.zeros((1, 1, ntl - s0c, nb, nb), dtype=t.dtype, device=t.device))
        pipelined_factor_loop(ka, kb, la, panel, narrow, bulk, view, zero_pl,
                              potrf_flops(nt, nb))
    return gauge[0]


def _margin_probe(panel, gauge: list, p: int, q: int, nb: int, s0r: int, s0c: int, n_true: int):
    """``panel`` with the margin gauge ``gauge[0]`` folded in at its entry:
    the true-extent diagonal of pivot tile (k, k), a local reduction."""

    def probed(k, view):
        cnt = min(nb, n_true - k * nb)
        if cnt > 0:
            d = torch.diagonal(view[k % p, k % q, k // p - s0r, k // q - s0c])[:cnt]
            gauge[0] = torch.minimum(gauge[0], d.real.to(gauge[0].dtype).min())
        return panel(k, view)

    return probed


# ---------------------------------------------------------------------------
# band Cholesky (src/pbtrf.cc): the k-loop on a sliding tile window
# ---------------------------------------------------------------------------


def _tile_products(pan: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``pan[r, c, i] @ rhs[r, c, j]`` for every tile pair, (p, q, I, J, nb,
    nb): one batched product of each mesh row's (I nb, nb) panel with each
    mesh column's (nb, J nb) row, ``pan`` (p, 1, I, nb, nb) and ``rhs``
    (1, q, J, nb, nb); TF32 off for f32 on the card (``slate_tpu``'s
    einsums run at HIGHEST)."""
    p, _, i_n, nb, _ = pan.shape
    q, j_n = rhs.shape[1], rhs.shape[2]
    a = pan.reshape(p, 1, i_n * nb, nb)
    b = rhs.permute(0, 1, 3, 2, 4).reshape(1, q, nb, j_n * nb)
    with _tf32_scope(a, Precision.Highest):
        prod = torch.matmul(a, b)
    return prod.view(p, q, i_n, nb, j_n, nb).permute(0, 1, 2, 4, 3, 5)


class _BandWindows:
    """The sliding windows of a band k-loop, as ``slate_tpu`` computes them
    per device: local row slots ``s_r(k) + [0, wlr)`` on mesh row r, column
    slots ``s_c(k) + [0, wlc)`` on mesh column c, each start clamped like
    ``lax.dynamic_slice``'s (s_r = clip(ceil((k - r) / p), 0, mtl - wlr)).
    All nt steps' slot and logical indices are made on the host and moved
    to the device once."""

    def __init__(self, nt, p, q, mtl, ntl, wlr, wlc, device, col_base=None):
        ks = np.arange(nt)[:, None]
        r, c = np.arange(p)[None, :], np.arange(q)[None, :]
        kc0 = ks if col_base is None else col_base(ks)
        self.sr = np.clip((ks - r + p - 1) // p, 0, mtl - wlr)  # (nt, p)
        self.sc = np.clip((kc0 - c + q - 1) // q, 0, ntl - wlc)  # (nt, q)
        rows = self.sr[:, :, None] + np.arange(wlr)
        cols = self.sc[:, :, None] + np.arange(wlc)
        as_dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
        self.rows, self.cols = as_dev(rows), as_dev(cols)  # local slots (nt, p, wlr) / (nt, q, wlc)
        self.i_win = as_dev(r[:, :, None] + rows * p)  # logical tile rows (nt, p, wlr)
        self.j_win = as_dev(c[:, :, None] + cols * q)  # logical tile columns (nt, q, wlc)
        self.sr_dev, self.sc_dev = as_dev(self.sr), as_dev(self.sc)
        self.pi = torch.arange(p, device=device)
        self.qi = torch.arange(q, device=device)


def _window_index(w: "_BandWindows", k: int, kc: Optional[int] = None):
    """Index tuple of step k's window on the local view (p, q, mtl, ntl, nb,
    nb): every device's (wlr, wlc) tiles, or, with ``kc``, its (wlr,) tiles
    of column slot kc."""
    pi, qi = w.pi, w.qi
    if kc is not None:
        return (pi[:, None, None], qi[None, :, None], w.rows[k][:, None, :], kc)
    return (pi[:, None, None, None], qi[None, :, None, None], w.rows[k][:, None, :, None],
            w.cols[k][None, :, None, :])


class _BandUpdate:
    """Step k's deferred windowed update: its panel column ``pan`` (p, 1,
    wlr, nb, nb), the transposed panel ``panT`` (1, q, wlc, nb, nb) and its
    own window offsets (step k's); the product of every tile pair is formed
    once and the narrow and bulk halves subtract their shares of it."""

    def __init__(self, k: int, pan: torch.Tensor, pan_t: torch.Tensor, cplx: bool):
        self.k, self.pan, self.pan_t, self.cplx = k, pan, pan_t, cplx
        self._prod = None

    def product(self) -> torch.Tensor:
        if self._prod is None:
            rhs = self.pan_t.conj() if self.cplx else self.pan_t
            self._prod = _tile_products(self.pan, rhs.transpose(-1, -2))
        return self._prod


@instrument("pbtrf_band_dist")
def pbtrf_band_dist(
    a: DistMatrix, kd: int, lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None, overwrite_a: bool = False,
) -> Tuple[DistMatrix, torch.Tensor]:
    """Band Cholesky on the mesh at band cost (src/pbtrf.cc): the k-loop
    touches only the tile window inside the bandwidth (the wd = (nb - 1 +
    kd) // nb + 1 tile rows a panel column reaches, in ``wlr`` = min(
    ceil(wd / p) + 1, mtl) local row and ``wlc`` = min(ceil(wd / q) + 1,
    ntl) local column slots), so total work is O(n (kd + nb)^2) and the
    per-step broadcasts O(wd nb^2).  ``a`` holds the lower triangle with
    bandwidth kd (Cholesky preserves the band).  Returns (L, info), info 0
    or 1 + the global index of the first bad pivot.

    ``lookahead`` (Option.Lookahead; None = 1) defers each step's windowed
    update into the next step (``comm.pipelined_factor_loop``); each
    deferred update carries its own window offsets, so the narrow and bulk
    halves land at step k - 1's window, not k's.  Results are bitwise the
    same at every depth and ``bcast_impl`` lowering.  Its solves and
    products are torch ops (no hand kernel, as in ``slate_tpu``); bf16
    factors its diagonal tiles in f32."""
    p, q = mesh_shape(a.mesh)
    if a.mt != a.nt:
        raise ValueError("pbtrf_band_dist needs a square tile grid")
    a.require_diag_pad("pbtrf_band_dist")
    nb = a.nb
    wd = min(((nb - 1) + kd) // nb + 1, a.nt)
    t = a.tiles if overwrite_a else a.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        _pbtrf_band_tiles(t, p, q, a.nt, wd, la_depth(lookahead, a.nt))
    info = _chol_info_dist(t, p, q, nb)
    return DistMatrix(tiles=t, m=a.m, n=a.n, nb=a.nb, mesh=a.mesh, diag_pad=True), info


def _pbtrf_band_tiles(t: torch.Tensor, p: int, q: int, nt: int, wd: int, la: int) -> None:
    """``slate_tpu``'s ``_pbtrf_band_jit`` kernel, in place on the cyclic
    tile stack, every device of the grid at once."""
    loc = local_view(t, p, q)  # (p, q, mtl, ntl, nb, nb)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    wlr, wlc = min(-(-wd // p) + 1, mtl), min(-(-wd // q) + 1, ntl)
    dtype, dev = t.dtype, t.device
    cplx = t.is_complex()
    low = dtype in (torch.bfloat16, torch.float16)
    w = _BandWindows(nt, p, q, mtl, ntl, wlr, wlc, dev)

    def panel(k, loc):
        """Diagonal factor, the windowed column solve on the owning mesh
        column, the panel along the mesh columns and gathered over the
        mesh rows, transposed into every column window."""
        kc, c0 = k // q, k % q
        dtile = bcast_diag_tile(loc, k, p, q)[0, 0]
        lkk = _cholesky(dtile.float()).to(dtype) if low else _cholesky(dtile)
        idx = (w.pi[:, None], c0, w.rows[k], kc)  # the owning column's window: (p, wlr)
        colwin = loc[idx]
        solved = solve_tri(_ht(lkk), colwin, upper=True, left=False)
        i_win = w.i_win[k][..., None, None]
        below = i_win > k
        newcol = torch.where(below, solved, torch.where(i_win == k, lkk, colwin))
        loc[idx] = newcol
        pan = bcast_from_col(torch.where(below, newcol, 0)[:, None], c0, q)  # (p, 1, wlr, nb, nb)
        allpan = all_gather_a(pan, ROW_AXIS, p)[0, 0]  # (p, wlr, nb, nb)
        j_win = w.j_win[k]  # (q, wlc)
        slot = j_win // p - w.sr_dev[k][j_win % p]
        valid = (slot >= 0) & (slot < wlr) & (j_win > k)
        pan_t = allpan[j_win % p, slot.clamp(0, wlr - 1)]
        pan_t = torch.where(valid[..., None, None], pan_t, 0)[None]  # (1, q, wlc, nb, nb)
        return loc, _BandUpdate(k, pan, pan_t, cplx)

    def narrow(k, loc, upd):
        """The deferred step-(k-1) update on local column slot k // q (what
        panel(k) reads), at the update's own window rows."""
        if upd is None:
            return loc
        kc, kp = k // q, upd.k
        oc = kc - w.sc_dev[kp]  # the column's offset inside the pending window, per mesh column
        in_win = (oc >= 0) & (oc < wlc)
        jcol = w.qi + q * kc  # the logical column of each mesh column's slot kc
        prod = upd.product()[:, w.qi, :, oc.clamp(0, wlc - 1)].movedim(0, 1)  # (p, q, wlr, nb, nb)
        mask = in_win[None, :, None] & (w.i_win[kp][:, None, :] >= jcol[None, :, None])
        idx = _window_index(w, kp, kc=kc)
        loc[idx] = loc[idx] - torch.where(mask[..., None, None], prod, 0)
        return loc

    def bulk(k, loc, upd):
        """The deferred windowed update at its own offsets; k = None
        everywhere, else all but the column slot narrow(k) refreshed."""
        if upd is None:
            return loc
        kp = upd.k
        mask = w.i_win[kp][:, None, :, None] >= w.j_win[kp][None, :, None, :]
        if k is not None:
            mask = mask & (w.cols[kp] != k // q)[None, :, None, :]
        idx = _window_index(w, kp)
        loc[idx] = loc[idx] - torch.where(mask[..., None, None], upd.product(), 0)
        return loc

    pipelined_factor_loop(0, nt, la, panel, narrow, bulk, loc, None)
