"""Distributed triangular solve over the block-cyclic virtual mesh.

Counterpart of ``trsm_dist`` and ``trsm_dist_right`` in
``slate_tpu/parallel/dist_trsm.py`` (the reference's ``src/trsm.cc`` /
``trsmA.cc``), both sides, every (uplo, op).  Left, per tile row k: the
diagonal tile reaches every device, the owning mesh row solves its row of B
and broadcasts the solution down the mesh columns, and every device
subtracts the panel update.  TrsmB broadcasts A's panel to B's owners;
TrsmA keeps A's tiles where they are, replicates the solved row and routes
the partial updates back to B's owners (psum-scatters).  Right
(X op(A) = B), per tile column k: the owning mesh column solves its column
of B and broadcasts it along the rows, with row k of op(A) as the
prefetched panel.  There is no Pallas kernel on this path in
``slate_tpu``: the solves and products are
``torch.linalg.solve_triangular`` (in f32 for a half-precision B) and
batched ``matmul`` over the grid, as ``slate_tpu`` left them to XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..obs.span import instrument
from ..blas3.blas3 import solve_tri
from ..types import Diag, MethodTrsm, Op, Side, Uplo, select_trsm_method
from .comm import (
    COL_AXIS,
    ROW_AXIS,
    all_gather_a,
    bcast_diag_tile,
    bcast_from_col,
    bcast_from_row,
    bcast_impl_scope,
    flight_row,
    flying,
    la_depth,
    local_indices,
    note_flops,
    prefetch_bcast,
    psum_scatter_a,
    resolve_bcast_impl,
    route_to_block_cyclic_rows,
)
from .dist import DistMatrix, local_view
from .dist_blas3 import tile_outer
from .mesh import mesh_shape


@instrument("trsm_dist")
def trsm_dist(
    a: DistMatrix,
    b: DistMatrix,
    uplo: Uplo = Uplo.Lower,
    op: Op = Op.NoTrans,
    diag: Diag = Diag.NonUnit,
    method: Optional[MethodTrsm] = None,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
) -> DistMatrix:
    """Solve op(A) X = B; A triangular-distributed, B distributed; X comes
    back in B's layout (a new tile stack; ``b`` is not modified).
    ``method`` picks TrsmA or TrsmB (None: ``select_trsm_method``, as
    ``slate_tpu``); ``lookahead`` prefetches A's read-only per-step panels;
    ``bcast_impl`` is the audited broadcast lowering.  Bitwise the same at
    every depth and lowering."""
    p, q = mesh_shape(a.mesh)
    if b.grid != a.grid or b.nb != a.nb or b.mt != a.nt or b.m != a.n:
        raise ValueError(
            f"trsm_dist operands mismatch: A {a.m}x{a.n} nb={a.nb} grid={a.grid}, "
            f"B {b.m}x{b.n} nb={b.nb} grid={b.grid}"
        )
    a.require_diag_pad("trsm_dist")
    if method is None:
        method = select_trsm_method(Side.Left, b.mt, b.nt)
    from ..obs import flight as _flight

    xt = b.tiles.clone()
    la, bi = la_depth(lookahead, a.nt), resolve_bcast_impl(bcast_impl)
    with bcast_impl_scope(bi):
        if method == MethodTrsm.TrsmA:
            # stationary A's delivery has no per-step broadcast phase: the
            # flight covers TrsmB only, as slate_tpu's does
            _trsm_a(a.tiles, xt, p, q, a.nt, uplo, op, diag, la)
        else:
            with _flight.fly("trsm", (p, q), nt=a.nt, depth=la, impl=bi,
                             forward=_flags(uplo, op, diag)[3]):
                _trsm_b(a.tiles, xt, p, q, a.nt, uplo, op, diag, la)
    return DistMatrix(tiles=xt, m=b.m, n=b.n, nb=b.nb, mesh=b.mesh)


def _flags(uplo: Uplo, op: Op, diag: Diag):
    trans = op != Op.NoTrans
    conj = op == Op.ConjTrans
    eff_lower = (uplo == Uplo.Lower) != trans  # the triangle of op(A)
    return trans, conj, eff_lower, eff_lower, diag == Diag.Unit  # forward iff op(A) lower


def _solve_row(b_loc, dtile, k, p, eff_lower, unit):
    """Solve X[k, :] on the owning mesh row (in place) and return it
    broadcast down the mesh columns: (1, q, ntl_b, nb, nb)."""
    r0, kr = k % p, k // p
    brow = b_loc[r0:r0 + 1, :, kr]
    brow.copy_(solve_tri(dtile[0, 0], brow, upper=not eff_lower, left=True,
                         unitriangular=unit))
    return bcast_from_row(brow, r0, p)


def _trsm_b(at, bt, p, q, nt, uplo, op, diag, la, on_pan=None, on_step=None):
    """TrsmB (``slate_tpu``'s ``_trsm_jit``), in place on B's tile copy.
    ``on_pan(k, pan) -> pan`` and ``on_step(k, b_loc)`` are the fault hooks
    of ``ft.abft.trsm_ft``: after step k's panel is received, and after
    step k's update lands (None: the plain solve)."""
    trans, conj, eff_lower, forward, unit = _flags(uplo, op, diag)
    a_loc, b_loc = local_view(at, p, q), local_view(bt, p, q)
    mtl, ntl = a_loc.shape[2], a_loc.shape[3]
    _, _, i_log, _ = local_indices(p, q, mtl, ntl, at.device)

    def opt(t):
        t = t.transpose(-1, -2)
        return t.conj() if conj else t

    def fetch(s):
        k = s if forward else nt - 1 - s
        dtile = bcast_diag_tile(a_loc, k, p, q)
        if trans:
            dtile = opt(dtile)
        remaining = ((i_log > k) if forward else (i_log < k))[..., None, None]  # (p, 1, mtl)
        if not trans:
            acol = a_loc[:, k % q:k % q + 1, :, k // q]  # the owning column's panel
            pan = bcast_from_col(torch.where(remaining, acol, 0), k % q, q)
        else:
            # op(A)[i, k] = op(A[k, i]): transpose-gather of A's row k
            arow = bcast_from_row(a_loc[k % p:k % p + 1, :, k // p], k % p, p)
            allrow = all_gather_a(arow, COL_AXIS, q)[0, 0]  # (q, ntl, nb, nb)
            pan = torch.where(remaining, opt(allrow[i_log % q, i_log // q]), 0)
        if on_pan is not None:
            pan = on_pan(k, pan)
        return dtile, pan

    nb, ncols = at.shape[2], bt.shape[1] * bt.shape[2]

    def consume(s, panels, b_loc):
        # under the flight recorder: the solve and its row broadcast are the
        # step's ``panel`` row, the update its ``bulk`` row (slate_tpu's
        # flight phases; its schedule tags them both ``bulk``)
        k = s if forward else nt - 1 - s
        dtile, pan = panels
        with flight_row("panel", s, root_k=k):
            if flying():
                note_flops(float(nb) * nb * ncols)
            xrow = _solve_row(b_loc, dtile, k, p, eff_lower, unit)
        with flight_row("bulk", s):
            if flying():
                note_flops(2.0 * nb * nb * ncols * (nt - 1 - s))
            b_loc -= torch.matmul(pan.unsqueeze(-3), xrow.unsqueeze(-4))
            if on_step is not None:
                on_step(k, b_loc)
        return b_loc

    prefetch_bcast(nt, la, fetch, consume, b_loc, root_of=lambda s: s if forward else nt - 1 - s)


def _trsm_a(at, bt, p, q, nt, uplo, op, diag, la):
    """TrsmA (``slate_tpu``'s ``_trsm_a_jit``), in place on B's tile copy:
    the solved row is replicated, A's owners form the partial updates where
    A's tiles live, and psum-scatters deliver them to B's owners."""
    trans, conj, eff_lower, forward, unit = _flags(uplo, op, diag)
    a_loc, b_loc = local_view(at, p, q), local_view(bt, p, q)
    mtl, ntl = a_loc.shape[2], a_loc.shape[3]
    mtl_b = b_loc.shape[2]
    r, c, i_log, j_log = local_indices(p, q, mtl, ntl, at.device)

    def opt(t):
        t = t.transpose(-1, -2)
        return t.conj() if conj else t

    def fetch(s):
        k = s if forward else nt - 1 - s
        dtile = bcast_diag_tile(a_loc, k, p, q)
        return opt(dtile) if trans else dtile

    def consume(s, dtile, b_loc):
        k = s if forward else nt - 1 - s
        xrow = _solve_row(b_loc, dtile, k, p, eff_lower, unit)
        xfull = all_gather_a(xrow, COL_AXIS, q)  # (1, 1, q, ntl_b, nb, nb)
        if not trans:
            # owner computes: only mesh column k % q holds A[:, k]
            remaining = (i_log > k) if forward else (i_log < k)
            keep = (remaining & (c == k % q)[:, :, None])[..., None, None]  # (p, q, mtl)
            acol = torch.where(keep, a_loc[:, :, :, k // q], 0)
            part = torch.matmul(acol[:, :, :, None, None], xfull[:, :, None])  # (p,q,mtl,q,ntl_b,..)
            # reduce over the columns, slice J to mesh column J
            b_loc -= psum_scatter_a(part, COL_AXIS, q, scatter_dimension=1)
            return b_loc
        # op(A)[i, k] = op(A[k, i]): the stationary tiles are A's row k on
        # mesh row k % p; partials for output row i go to mesh row i % p
        remaining = (j_log > k) if forward else (j_log < k)
        keep = (remaining & (r == k % p)[:, :, None])[..., None, None]  # (p, q, ntl)
        pan = torch.where(keep, opt(a_loc[:, :, k // p]), 0)
        part = torch.matmul(pan[:, :, :, None, None], xfull[:, :, None])  # (p,q,ntl,q,ntl_b,..)
        b_loc -= route_to_block_cyclic_rows(part, j_log, p, mtl_b)
        return b_loc

    prefetch_bcast(nt, la, fetch, consume, b_loc)


@instrument("trsm_dist_right")
def trsm_dist_right(
    a: DistMatrix,
    b: DistMatrix,
    uplo: Uplo = Uplo.Lower,
    op: Op = Op.NoTrans,
    diag: Diag = Diag.NonUnit,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
) -> DistMatrix:
    """Solve X op(A) = B; A triangular-distributed (n, n), B (m, n); X
    comes back in B's layout (a new tile stack).  ``lookahead`` prefetches
    A's read-only per-step panels, ``bcast_impl`` is the audited lowering;
    bitwise the same at every depth and lowering."""
    p, q = mesh_shape(a.mesh)
    if b.grid != a.grid or b.nb != a.nb or b.nt != a.nt or b.n != a.m:
        raise ValueError(
            f"trsm_dist_right operands mismatch: A {a.m}x{a.n} nb={a.nb}, "
            f"B {b.m}x{b.n} nb={b.nb}"
        )
    a.require_diag_pad("trsm_dist_right")
    xt = b.tiles.clone()
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        _trsm_right(a.tiles, xt, p, q, a.nt, uplo, op, diag, la_depth(lookahead, a.nt))
    return DistMatrix(tiles=xt, m=b.m, n=b.n, nb=b.nb, mesh=b.mesh)


def _trsm_right(at, bt, p, q, nt, uplo, op, diag, la):
    """``slate_tpu``'s ``_trsm_right_jit``, in place on B's tile copy."""
    trans, conj = op != Op.NoTrans, op == Op.ConjTrans
    eff_lower = (uplo == Uplo.Lower) != trans
    forward = not eff_lower  # X op(A) = B with op(A) upper: leading columns first
    unit = diag == Diag.Unit
    a_loc, b_loc = local_view(at, p, q), local_view(bt, p, q)
    _, _, _, j_log = local_indices(p, q, a_loc.shape[2], a_loc.shape[3], at.device)

    def opt(t):
        t = t.transpose(-1, -2)
        return t.conj() if conj else t

    def fetch(s):
        k = s if forward else nt - 1 - s
        dtile = bcast_diag_tile(a_loc, k, p, q)
        if trans:
            dtile = opt(dtile)
        remaining = ((j_log > k) if forward else (j_log < k))[..., None, None]  # (1, q, ntl)
        if not trans:
            arow = bcast_from_row(a_loc[k % p:k % p + 1, :, k // p], k % p, p)
        else:
            # op(A)[k, j] = op(A[j, k]): transpose-gather of A's column k
            acol = bcast_from_col(a_loc[:, k % q:k % q + 1, :, k // q], k % q, q)
            allcol = all_gather_a(acol, ROW_AXIS, p)[0, 0]  # (p, mtl, nb, nb)
            arow = opt(allcol[j_log % p, j_log // p])
        return dtile, torch.where(remaining, arow, 0)

    def consume(s, panels, b_loc):
        k = s if forward else nt - 1 - s
        dtile, arow = panels
        c0, kc = k % q, k // q
        # solve X[:, k] on the owning mesh column, in place, and broadcast it
        bcol = b_loc[:, c0:c0 + 1, :, kc]
        bcol.copy_(solve_tri(dtile[0, 0], bcol, upper=not eff_lower, left=False,
                             unitriangular=unit))
        xcol = bcast_from_col(bcol, c0, q)  # (p, 1, mtl_b, nb, nb)
        b_loc -= tile_outer(xcol, arow)
        return b_loc

    prefetch_bcast(nt, la, fetch, consume, b_loc)
