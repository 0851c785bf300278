"""Distributed BLAS-3 beyond gemm / herk / trsm on the virtual mesh:
hemm / symm, trmm, her2k / syr2k, and the tile-grid transpose they use.

Counterpart of ``slate_tpu/parallel/dist_blas3.py`` (the reference's
``src/hemm.cc``, ``hemmA.cc``, ``symm.cc``, ``trmm.cc``, ``her2k.cc`` and
``syr2k.cc``), with the same names, options, tile layouts and audited comm
bytes.  Lower storage, A Hermitian: A = D + L + L^H with L strictly lower,
so SUMMA step k reads the stored column panel (D + L)[:, k] and the mirror
L^H[:, k], whose tile (i, k) is conj(A[k, i])^T from the stored ROW panel k
(one all_gather along the mesh columns and a per-tile conjugate
transpose).  The diagonal tile is rebuilt from its stored triangle alone.

There is no Pallas kernel on this path in ``slate_tpu``: its products are
XLA einsums at HIGHEST.  Here every device's step product is one GEMM of
its (mtl nb x nb) panel against the (nb x ntl nb) row, batched over the
grid (``torch.baddbmm`` into per-device accumulators, cuBLAS on the card),
with TF32 off for f32 on the card (``ops.matmul._tf32_scope`` at Highest).  Lookahead (``comm.prefetch_bcast``)
and the broadcast lowering change when and how bytes would move, never a
value: results are bitwise the same at every depth and lowering.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..blas3.blas3 import conj_scalar
from ..ops.matmul import _tf32_scope
from ..types import Diag, MethodHemm, Op, Precision, Side, Uplo, select_hemm_method
from .comm import (
    COL_AXIS,
    ROW_AXIS,
    all_gather_a,
    bcast_from_col,
    bcast_from_row,
    bcast_impl_scope,
    la_depth,
    local_indices,
    prefetch_bcast,
    resolve_bcast_impl,
    route_to_block_cyclic_rows,
)
from .dist import DistMatrix, local_view
from .mesh import mesh_shape
from .summa import _finish

# ---------------------------------------------------------------------------
# per-device products over the grid
# ---------------------------------------------------------------------------


def _num(x):
    """A Python scalar for the BLAS alpha of ``torch.baddbmm``."""
    return x.item() if isinstance(x, torch.Tensor) else x


def dense_acc(p: int, q: int, mtl: int, ntl: int, nb: int, dtype, device) -> torch.Tensor:
    """Zero per-device accumulators (p, q, mtl nb, ntl nb): device (r, c)'s
    local tiles as one dense block, the layout the step GEMMs write."""
    return torch.zeros((p, q, mtl * nb, ntl * nb), dtype=dtype, device=device)


def _grid_operands(left: torch.Tensor, right: torch.Tensor, p: int, q: int):
    """(p q, mtl nb, kb) and (p q, kb, ntl nb) GEMM operands of every
    device: the column of left's tiles (P, Q, mtl, nb, kb) stacked and the
    row of right's tiles (P, Q, ntl, kb, nb) side by side (size-1 grid
    dims broadcast: only these thin panels are copied)."""
    mtl, nb, kb = left.shape[2:]
    ntl, _, nb2 = right.shape[2:]
    lhs = left.reshape(left.shape[0], left.shape[1], mtl * nb, kb).expand(p, q, mtl * nb, kb)
    rhs = (right.permute(0, 1, 3, 2, 4).reshape(right.shape[0], right.shape[1], kb, ntl * nb2)
           .expand(p, q, kb, ntl * nb2))
    return lhs.reshape(p * q, mtl * nb, kb), rhs.reshape(p * q, kb, ntl * nb2)


def acc_outer(acc: torch.Tensor, left: torch.Tensor, right: torch.Tensor, alpha=1) -> None:
    """acc[r, c] += alpha L R on every device (see ``_grid_operands``): one
    batched GEMM with beta = 1, so no product temporary."""
    p, q, m_, n_ = acc.shape
    lhs, rhs = _grid_operands(left, right, p, q)
    with _tf32_scope(lhs, Precision.Highest):
        acc.view(p * q, m_, n_).baddbmm_(lhs, rhs, alpha=_num(alpha))


def tile_outer(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """Every device's (mtl, ntl) grid of tile products left[i] @ right[j],
    as the (p, q, mtl, ntl, nb, nb) tile view of one batched GEMM."""
    p, q = max(left.shape[0], right.shape[0]), max(left.shape[1], right.shape[1])
    lhs, rhs = _grid_operands(left, right, p, q)
    with _tf32_scope(lhs, Precision.Highest):
        out = torch.bmm(lhs, rhs)
    return acc_tiles(out.view(p, q, lhs.shape[1], rhs.shape[2]), left.shape[3])


def acc_tiles(acc: torch.Tensor, nb: int) -> torch.Tensor:
    """The (p, q, mtl, ntl, nb, nb) tile view of per-device accumulators."""
    p, q, m_, n_ = acc.shape
    return acc.view(p, q, m_ // nb, nb, n_ // nb, nb).transpose(3, 4)


def _store(loc: torch.Tensor) -> torch.Tensor:
    """A (p, q, mtl, ntl, nb, nb) per-device delivery -> the cyclic stack."""
    p, q, mtl, ntl, nb, nb2 = loc.shape
    out = torch.empty((p * mtl, q * ntl, nb, nb2), dtype=loc.dtype, device=loc.device)
    local_view(out, p, q).copy_(loc)
    return out


def tiles_of(acc: torch.Tensor, nb: int) -> torch.Tensor:
    """Per-device accumulators -> the cyclic tile stack (mt, nt, nb, nb)."""
    return _store(acc_tiles(acc, nb))


def _tri(x: torch.Tensor, lower: bool, strict: bool = False) -> torch.Tensor:
    if lower:
        return x.tril(-1 if strict else 0)
    return x.triu(1 if strict else 0)


def _ht(x: torch.Tensor, conj: bool) -> torch.Tensor:
    """Per-tile transpose, conjugated when ``conj``."""
    x = x.transpose(-1, -2)
    return x.conj() if conj else x


def _set_diag(t: torch.Tensor, dvals: torch.Tensor) -> torch.Tensor:
    """``t`` with its tiles' diagonals replaced by ``dvals`` (a copy)."""
    t = t.clone()
    t.diagonal(dim1=-2, dim2=-1).copy_(dvals)
    return t


def _herm_diag(t: torch.Tensor, lower: bool, conj: bool) -> torch.Tensor:
    """Full diagonal tiles rebuilt from their stored triangle alone: the
    stored triangle plus its mirrored strict part (conjugated, with the
    diagonal's imaginary parts dropped, for a Hermitian matrix)."""
    dstored = _tri(t, lower)
    dmir = _ht(_tri(t, lower, strict=True), conj)
    if conj:
        dstored = _set_diag(dstored, dstored.diagonal(dim1=-2, dim2=-1).real.to(t.dtype))
    return dstored + dmir


# ---------------------------------------------------------------------------
# the tile-grid transpose
# ---------------------------------------------------------------------------


def transpose_dist(a: DistMatrix, conj: bool = False) -> DistMatrix:
    """op(A) on the same mesh: out tile (i, j) = op(in tile (j, i)).
    ``slate_tpu`` gathers the full tile stack on every device (two
    all_gathers) and picks its mirrored tiles; the audit records those two
    gathers, and one indexed copy picks every device's tiles at once."""
    p, q = mesh_shape(a.mesh)
    a_loc = local_view(a.tiles, p, q)
    mtl, ntl = a_loc.shape[2], a_loc.shape[3]
    allr = all_gather_a(a_loc, ROW_AXIS, p)  # (1, q, p, mtl, ntl, nb, nb)
    allrc = all_gather_a(allr, COL_AXIS, q)[0, 0]  # (q, p, mtl, ntl, nb, nb)
    # the grids are padded to lcm(p, q) multiples, so both re-tile evenly
    out_mtl, out_ntl = (ntl * q) // p, (mtl * p) // q
    _, _, i_out, j_out = local_indices(p, q, out_mtl, out_ntl, a.tiles.device)
    ii, jj = i_out[..., :, None], j_out[..., None, :]
    # out tile (I, J) = in tile (J, I)^T, which lives at allrc[I % q, J % p, J // p, I // q]
    picked = allrc[ii % q, jj % p, jj // p, ii // q]  # (p, q, out_mtl, out_ntl, nb, nb)
    out = _store(_ht(picked, conj))
    return DistMatrix(tiles=out, m=a.n, n=a.m, nb=a.nb, mesh=a.mesh)


# ---------------------------------------------------------------------------
# hemm / symm
# ---------------------------------------------------------------------------


def _mirror_col_panel(a_loc, k: int, p: int, q: int, i_log, uplo: Uplo, conj: bool
                      ) -> torch.Tensor:
    """Column panel k of the IMPLICIT full matrix by every device's row
    tiles, (p, 1, mtl, nb, nb), rebuilt from ``uplo``-triangle storage: the
    stored tiles (i, k) (i >= k for Lower) from the owning mesh column, the
    mirror (A^H)[i, k] = conj(A[k, i])^T of the other triangle from the
    stored row panel k (a broadcast down the rows and an all_gather along
    the columns), and the diagonal tile from its stored triangle alone."""
    lower = uplo == Uplo.Lower
    acol = bcast_from_col(a_loc[:, :, :, k // q], k % q, q)  # (p, 1, mtl, nb, nb)
    keep_stored = ((i_log > k) if lower else (i_log < k))[..., None, None]
    arow = bcast_from_row(a_loc[:, :, k // p], k % p, p)  # (1, q, ntl, nb, nb)
    allrow = all_gather_a(arow, COL_AXIS, q)[0, 0]  # (q, ntl, nb, nb): the full row k
    mirror = _ht(allrow[i_log % q, i_log // q], conj)  # tile (k, i), mirrored
    keep_mirror = ((i_log < k) if lower else (i_log > k))[..., None, None]
    pan = torch.where(keep_stored, acol, 0) + torch.where(keep_mirror, mirror, 0)
    return torch.where((i_log == k)[..., None, None], _herm_diag(acol, lower, conj), pan)


def hemm_summa(
    side,
    alpha,
    a: DistMatrix,
    b: DistMatrix,
    beta=0.0,
    c: Optional[DistMatrix] = None,
    uplo: Uplo = Uplo.Lower,
    conj: bool = True,
    method: Optional[MethodHemm] = None,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
) -> DistMatrix:
    """C := alpha A B + beta C, A Hermitian (conj=True, src/hemm.cc) or
    symmetric (conj=False, src/symm.cc), read through its ``uplo`` triangle
    only.  Side.Right runs the Left schedule on transposed operands
    (C^H = conj(alpha) A B^H + conj(beta) C^H for a Hermitian A).

    ``method`` (Option.MethodHemm; None: ``select_hemm_method`` on the tile
    grids): HemmC is the k-loop broadcast pipeline, prefetched
    ``lookahead`` deep; HemmA keeps A's stored triangle in place, replicates
    the thin B and routes the partial C to its owners (no k-loop: the depth
    is accepted and ignored).  ``bcast_impl`` is the audited lowering."""
    p, q = mesh_shape(a.mesh)
    if side == Side.Right:
        bt_ = transpose_dist(b, conj=conj)
        ct_ = transpose_dist(c, conj=conj) if c is not None else None
        al = conj_scalar(alpha) if conj else alpha
        be = conj_scalar(beta) if conj else beta
        prod_t = hemm_summa(Side.Left, al, a, bt_, be, ct_, uplo=uplo, conj=conj, method=method,
                            lookahead=lookahead, bcast_impl=bcast_impl)
        return transpose_dist(prod_t, conj=conj)
    if b.grid != (p, q) or b.nb != a.nb or a.n != b.m:
        raise ValueError("hemm_summa operands must share mesh/nb and dims")
    if method is None:
        method = select_hemm_method(a.mt, b.nt)
    if method == MethodHemm.HemmA:
        prod = _hemm_a(a, b, p, q, uplo, conj)
    else:
        with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
            prod = _hemm_c(a, b, p, q, uplo, conj, la_depth(lookahead, a.nt))
    return DistMatrix(tiles=_finish(prod, alpha, beta, c), m=a.m, n=b.n, nb=a.nb, mesh=a.mesh)


def _hemm_c(a: DistMatrix, b: DistMatrix, p: int, q: int, uplo: Uplo, conj: bool,
            la: int) -> torch.Tensor:
    """HemmC (``slate_tpu``'s ``_hemm_jit``): step k broadcasts the rebuilt
    column panel k and B's row k; every device adds their product."""
    a_loc, b_loc = local_view(a.tiles, p, q), local_view(b.tiles, p, q)
    mtl, ntl, nb = a_loc.shape[2], b_loc.shape[3], a.nb
    _, _, i_log, _ = local_indices(p, q, mtl, a_loc.shape[3], a.tiles.device)

    def fetch(k):
        # both panels are pure functions of the stored stacks (prefetchable)
        pan = _mirror_col_panel(a_loc, k, p, q, i_log, uplo, conj)
        brow = bcast_from_row(b_loc[:, :, k // p], k % p, p)
        return pan, brow

    def consume(k, panels, acc):
        acc_outer(acc, *panels)
        return acc

    acc = dense_acc(p, q, mtl, ntl, nb, a.dtype, a.tiles.device)
    return tiles_of(prefetch_bcast(a.nt, la, fetch, consume, acc), nb)


def _hemm_a(a: DistMatrix, b: DistMatrix, p: int, q: int, uplo: Uplo, conj: bool) -> torch.Tensor:
    """HemmA (``slate_tpu``'s ``_hemm_a_jit``, src/hemmA.cc): A's stored
    triangle never moves.  B is replicated by two all_gathers; each device
    multiplies its OWN stored tiles -- tile (i, j) gives A[i, j] B[j] to
    C[i] and, strictly off the diagonal, op(A[i, j]) B[i] to C[j] -- and
    the partials go to C's owners through ``comm.route_to_block_cyclic_rows``.
    Each device's sums over its tiles are two GEMMs of its dense block."""
    a_loc, b_loc = local_view(a.tiles, p, q), local_view(b.tiles, p, q)
    mtl, ntl, nb = a_loc.shape[2], a_loc.shape[3], a.nb
    ntl_b = b_loc.shape[3]
    dev = a.tiles.device
    lower = uplo == Uplo.Lower
    _, _, i_log, j_log = local_indices(p, q, mtl, ntl, dev)
    # bfull[r', kappa, c', nu] = B(r' + p kappa, c' + q nu), on every device
    bfull = all_gather_a(b_loc, COL_AXIS, q)  # (p, 1, q, ktl_b, ntl_b, nb, nb)
    bfull = all_gather_a(bfull, ROW_AXIS, p)[0, 0].movedim(2, 1)  # (p, ktl_b, q, ntl_b, nb, nb)
    wide = q * ntl_b * nb

    def brows(idx):
        """B's tile rows ``idx`` (P, Q, t) as one (P, Q, t nb, q ntl_b nb) block."""
        blk = bfull[idx % p, idx // p]  # (P, Q, t, q, ntl_b, nb, nb)
        return blk.permute(0, 1, 2, 5, 3, 4, 6).reshape(*idx.shape, nb, wide).flatten(2, 3)

    stored = (i_log[..., :, None] > j_log[..., None, :]) if lower \
        else (i_log[..., :, None] < j_log[..., None, :])  # (p, q, mtl, ntl)
    # my strict stored tiles as one dense block per device (p, q, mtl nb, ntl nb)
    blk = torch.where(stored[:, :, :, None, :, None], a_loc.transpose(3, 4), 0)
    with _tf32_scope(blk, Precision.Highest):
        # mirror contributions to C[j_log]: op(A[i, j]) B[i], summed over my i
        part_mir = torch.matmul(_ht(blk.flatten(4, 5).flatten(2, 3), conj), brows(i_log))
        # the diagonal tiles, rebuilt from the stored triangle, join the own part
        g = torch.arange(a.mt, device=dev)
        blk[g % p, g % q, g // p, :, g // q] = _herm_diag(a_loc[g % p, g % q, g // p, g // q],
                                                           lower, conj)
        part_own = torch.matmul(blk.flatten(4, 5).flatten(2, 3), brows(j_log))
    part_mir = part_mir.view(p, q, ntl, nb, q, ntl_b, nb).permute(0, 1, 2, 4, 5, 3, 6)
    part_own = part_own.view(p, q, mtl, nb, q, ntl_b, nb).permute(0, 1, 2, 4, 5, 3, 6)
    return _store(route_to_block_cyclic_rows(part_mir, j_log, p, mtl, extra=part_own))


# ---------------------------------------------------------------------------
# trmm
# ---------------------------------------------------------------------------


def trmm_dist(
    side,
    uplo: Uplo,
    op: Op,
    diag: Diag,
    alpha,
    a: DistMatrix,
    b: DistMatrix,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
) -> DistMatrix:
    """B := alpha op(A) B (Left) / alpha B op(A) (Right), A triangular
    (src/trmm.cc).  Left runs the SUMMA k-loop with the triangle mask (and,
    for op != NoTrans, the mirrored row-panel build); Right reduces to Left
    by transposition.  ``lookahead`` prefetches the read-only panels."""
    p, q = mesh_shape(a.mesh)
    if side == Side.Right:
        if op == Op.ConjTrans:
            # B A^H = (A B^H)^H
            out_t = trmm_dist(Side.Left, uplo, Op.NoTrans, diag, conj_scalar(alpha), a,
                              transpose_dist(b, conj=True), lookahead=lookahead,
                              bcast_impl=bcast_impl)
            return transpose_dist(out_t, conj=True)
        opt = Op.Trans if op == Op.NoTrans else Op.NoTrans
        out_t = trmm_dist(Side.Left, uplo, opt, diag, alpha, a, transpose_dist(b),
                          lookahead=lookahead, bcast_impl=bcast_impl)
        return transpose_dist(out_t)
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        prod = _trmm_left(a, b, p, q, uplo, op, diag, la_depth(lookahead, a.nt))
    return DistMatrix(tiles=_finish(prod, alpha, 0.0, None), m=a.m, n=b.n, nb=a.nb, mesh=a.mesh)


def _trmm_left(a: DistMatrix, b: DistMatrix, p: int, q: int, uplo: Uplo, op: Op, diag: Diag,
               la: int) -> torch.Tensor:
    """``slate_tpu``'s ``_trmm_jit``: step k's panel is op(A)[:, k] masked
    to the triangle, its diagonal tile projected (unit or not)."""
    a_loc, b_loc = local_view(a.tiles, p, q), local_view(b.tiles, p, q)
    mtl, ntl, nb = a_loc.shape[2], b_loc.shape[3], a.nb
    _, _, i_log, _ = local_indices(p, q, mtl, a_loc.shape[3], a.tiles.device)
    lower = uplo == Uplo.Lower
    unit = diag == Diag.Unit
    eye = torch.eye(nb, dtype=a.dtype, device=a.tiles.device)

    def fetch(k):
        if op == Op.NoTrans:
            pan = bcast_from_col(a_loc[:, :, :, k // q], k % q, q)
            keep = (i_log > k) if lower else (i_log < k)
            dlower = lower
        else:
            # op(A)[:, k] = op(A[k, :]): the stored row panel k, mirrored
            arow = bcast_from_row(a_loc[:, :, k // p], k % p, p)
            allrow = all_gather_a(arow, COL_AXIS, q)[0, 0]
            pan = _ht(allrow[i_log % q, i_log // q], op == Op.ConjTrans)
            keep = (i_log > k) if not lower else (i_log < k)  # A[k, i] stored
            dlower = not lower  # the triangle of the transposed tile
        dtile = _tri(pan, dlower, strict=True) + eye if unit else _tri(pan, dlower)
        pan = torch.where(keep[..., None, None], pan, 0)
        pan = torch.where((i_log == k)[..., None, None], dtile, pan)
        brow = bcast_from_row(b_loc[:, :, k // p], k % p, p)
        return pan, brow

    def consume(k, panels, acc):
        acc_outer(acc, *panels)
        return acc

    acc = dense_acc(p, q, mtl, ntl, nb, a.dtype, a.tiles.device)
    return tiles_of(prefetch_bcast(a.nt, la, fetch, consume, acc), nb)


# ---------------------------------------------------------------------------
# her2k / syr2k
# ---------------------------------------------------------------------------


def her2k_dist(
    alpha,
    a: DistMatrix,
    b: DistMatrix,
    beta=0.0,
    c: Optional[DistMatrix] = None,
    uplo: Uplo = Uplo.Lower,
    conj: bool = True,
    full: bool = False,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
) -> DistMatrix:
    """C := alpha A B^H + conj(alpha) B A^H + beta C (conj=True,
    src/her2k.cc) or the ^T, plain-alpha form (conj=False, syr2k): herk's
    SUMMA schedule with a transposed panel, accumulated twice a step.
    ``full`` keeps both triangles, else only ``uplo``'s (with the
    diagonal).  C carries ``diag_pad`` when its tile grid has no pad."""
    p, q = mesh_shape(a.mesh)
    if b.grid != (p, q) or b.nb != a.nb or (a.m, a.n) != (b.m, b.n):
        raise ValueError("her2k_dist: A and B must be same-shape, same mesh")
    if c is not None and (c.m != a.m or c.n != a.m or c.grid != (p, q) or c.nb != a.nb):
        raise ValueError("her2k_dist: C layout must match A B^H")
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        acc = her2k_acc(a.tiles, b.tiles, alpha, p, q, a.nt, a.n, conj,
                        la_depth(lookahead, a.nt))
    if not full:
        keep_triangle(acc, p, q, a.nb, uplo)
    prod = tiles_of(acc, a.nb)
    if c is not None:
        prod.add_(c.tiles * beta)
    return DistMatrix(tiles=prod, m=a.m, n=a.m, nb=a.nb, mesh=a.mesh,
                      diag_pad=a.mt * a.nb == a.m)


def syr2k_dist(alpha, a, b, beta=0.0, c=None, uplo: Uplo = Uplo.Lower, full: bool = False,
               lookahead: Optional[int] = None, bcast_impl: Optional[str] = None) -> DistMatrix:
    return her2k_dist(alpha, a, b, beta, c, uplo, conj=False, full=full, lookahead=lookahead,
                      bcast_impl=bcast_impl)


def _her2k_panels(x_loc, k: int, p: int, q: int, k_true: int, conj: bool):
    """Step-k operand panels of the her2k / syr2k schedule: the stored
    column panel (p, 1, mtl, nb, nb) (a rooted broadcast along the
    columns, masked to the true k extent) and its transposed gather
    (1, q, ntl_c, nb, nb) by every device's C columns.  Shared with
    ``dist_aux.herk_dist`` and ``ft.abft``'s checksum-carrying her2k,
    whose checksum tiles are more tiles of the same grid."""
    mtl, nb = x_loc.shape[2], x_loc.shape[4]
    xcol = bcast_from_col(x_loc[:, :, :, k // q], k % q, q)
    # a multiply, as slate_tpu's (a NaN past the true k stays NaN)
    kmask = (k * nb + torch.arange(nb, device=x_loc.device)) < k_true
    xcol = xcol * kmask.to(xcol.dtype)
    allpan = all_gather_a(xcol, ROW_AXIS, p)[0, 0]  # (p, mtl, nb, nb)
    ntl_c = -(-(mtl * p) // q)
    jc = torch.arange(q, device=x_loc.device).view(1, q, 1) \
        + torch.arange(ntl_c, device=x_loc.device) * q
    pan_t = allpan[jc % p, jc // p]
    return xcol, (pan_t.conj() if conj else pan_t)


def her2k_acc(at: torch.Tensor, bt: torch.Tensor, alpha, p: int, q: int, kt: int, k_true: int,
              conj: bool, la: int, on_fetch=None, on_step=None) -> torch.Tensor:
    """The her2k / syr2k k-loop over cyclic stacks ``at`` / ``bt``: the FULL
    alpha A op(B) + op(alpha) B op(A) as per-device accumulators
    (p, q, mtl nb, ntl_c nb).  ``on_fetch(k, panels) -> panels`` and
    ``on_step(k, acc)`` are the fault hooks of ``ft.abft.her2k_ft``."""
    a_loc, b_loc = local_view(at, p, q), local_view(bt, p, q)
    mtl, nb = a_loc.shape[2], a_loc.shape[4]
    al2 = conj_scalar(alpha) if conj else alpha

    def fetch(k):
        panels = (_her2k_panels(a_loc, k, p, q, k_true, conj),
                  _her2k_panels(b_loc, k, p, q, k_true, conj))
        return panels if on_fetch is None else on_fetch(k, panels)

    def consume(k, panels, acc):
        (acol, a_t), (bcol, b_t) = panels
        acc_outer(acc, acol, b_t.transpose(-1, -2), alpha)
        acc_outer(acc, bcol, a_t.transpose(-1, -2), al2)
        if on_step is not None:
            on_step(k, acc)
        return acc

    ntl_c = -(-at.shape[0] // q)  # C is square (mt x mt tiles)
    acc = dense_acc(p, q, mtl, ntl_c, nb, at.dtype, at.device)
    return prefetch_bcast(kt, la, fetch, consume, acc)


def keep_triangle(acc: torch.Tensor, p: int, q: int, nb: int, uplo: Uplo) -> None:
    """Zero, in place, the per-device accumulators of a square C outside
    its ``uplo`` triangle (by global element index; a select)."""
    _, _, m_, n_ = acc.shape
    _, _, i_log, j_log = local_indices(p, q, m_ // nb, n_ // nb, acc.device)
    ar = torch.arange(nb, device=acc.device)
    ii = (i_log[..., :, None] * nb + ar).flatten(2)[..., :, None]  # (p, 1, M, 1)
    jj = (j_log[..., :, None] * nb + ar).flatten(2)[..., None, :]  # (1, q, 1, N)
    acc.masked_fill_((ii < jj) if uplo == Uplo.Lower else (ii > jj), 0)
