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

The port factors the tile stack in place (``overwrite_a=True``) or in a
copy (the default: ``slate_tpu``'s functional semantics, one more copy of
the matrix).  ``num_monitor="on"`` (the in-carry numerics gauges) and the
flight recorder's step dispatch belong to the observability slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..linalg.chol import _cholesky
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
from .comm import (
    ROW_AXIS,
    all_gather_a,
    bcast_diag_tile,
    bcast_from_col,
    bcast_impl_scope,
    bucket_plan,
    la_depth,
    local_indices,
    pipelined_factor_loop,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view
from .mesh import mesh_shape


def _check_num_monitor(num_monitor: Optional[str], who: str = "potrf_dist") -> None:
    if num_monitor in (None, "off", "auto"):  # auto is off while obs is not ported
        return
    if num_monitor == "on":
        raise NotImplementedError(
            f"{who}: num_monitor='on' (the in-carry numerics gauges) is not "
            "ported yet; it comes with the observability slice")
    raise ValueError(f"unknown num_monitor {num_monitor!r}")


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
    ``overwrite_a`` factors ``a``'s tile stack in place instead of a copy."""
    p, q = mesh_shape(a.mesh)
    if a.mt != a.nt:
        raise ValueError("potrf_dist needs a square tile grid")
    a.require_diag_pad("potrf_dist")
    _check_num_monitor(num_monitor)
    t = a.tiles if overwrite_a else a.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
            panel_impl_scope(resolve_panel_impl(panel_impl)), \
            update_impl_scope(resolve_update_impl(update_impl)):
        _potrf_tiles(t, p, q, a.nt, la_depth(lookahead, a.nt))
    info = _chol_info_dist(t, p, q, a.nb)
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
        pan = bcast_from_col(torch.where(below, newcol, 0), c0, q)
        allpan = all_gather_a(pan, ROW_AXIS, p)[0, 0]  # (p, I, nb, nb): every row's panel
        # logical row j sits at slot j // p - roff of mesh row j % p; columns
        # below the window's row cut are finished (j <= k) and get zeros
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


def _potrf_tiles(t: torch.Tensor, p: int, q: int, nt: int, la: int) -> None:
    """The bucketed, pipelined k-loop of ``slate_tpu``'s ``_potrf_jit``, in
    place on the cyclic tile stack ``t``."""
    loc = local_view(t, p, q)  # (p, q, mtl, ntl, nb, nb)
    mtl, ntl, nb = loc.shape[2], loc.shape[3], loc.shape[4]
    cplx = t.is_complex()
    for k0, k1, s0r, s0c in bucket_plan(nt, p, q):
        view = loc[:, :, s0r:, s0c:]
        _, _, i_log, j_log = local_indices(p, q, mtl, ntl, t.device, s0r, s0c)
        panel, narrow, bulk = _phases(p, q, i_log, j_log, s0r, s0c, cplx)
        zero_pl = (torch.zeros((1, 1, mtl - s0r, nb, nb), dtype=t.dtype, device=t.device),
                   torch.zeros((1, 1, ntl - s0c, nb, nb), dtype=t.dtype, device=t.device))
        pipelined_factor_loop(k0, k1, la, panel, narrow, bulk, view, zero_pl)
