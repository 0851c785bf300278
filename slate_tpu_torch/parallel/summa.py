"""Distributed GEMM on the virtual mesh: stationary-C SUMMA and stationary-A.

Counterpart of ``gemm_summa`` in ``slate_tpu/parallel/summa.py`` (the
reference's ``slate::gemmC`` / ``gemmA``).  GemmC runs the k-loop: step k
broadcasts A's tile column k along the mesh rows and B's tile row k along
the mesh columns, and every device adds the product of the two panels to
its local C tiles -- on one card, one :func:`ops.kernels.summa_update`
launch over the whole grid per step (the hand-written tile-GEMM under
``Option.UpdateImpl`` pallas/auto, the batched-matmul form under xla).
Steps are prefetched ``Option.Lookahead`` deep through
``comm.prefetch_bcast``.  GemmA keeps A's tiles in place, replicates the
thin B and reduces the partial C over the k mesh axis: no k-loop, no
kernel.  The Ozaki variants come with the mixed-precision slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.kernels import (
    resolve_update_impl,
    summa_update,
    summa_update_plain,
    update_engaged,
    update_impl_scope,
)
from ..types import MethodGemm, select_gemm_method
from .comm import (
    COL_AXIS,
    ROW_AXIS,
    all_gather_a,
    bcast_from_col,
    bcast_from_row,
    bcast_impl_scope,
    la_depth,
    prefetch_bcast,
    psum_a,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view
from .mesh import mesh_shape


def _finish(prod: torch.Tensor, alpha, beta, c: Optional[DistMatrix]) -> torch.Tensor:
    """alpha * prod + beta * C, in prod's storage (``slate_tpu`` forms the
    same two products and one sum)."""
    prod.mul_(alpha)
    if c is not None:
        prod.add_(c.tiles * beta)
    return prod


def gemm_summa(
    alpha,
    a: DistMatrix,
    b: DistMatrix,
    beta=0.0,
    c: Optional[DistMatrix] = None,
    method: Optional[MethodGemm] = None,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
    update_impl: Optional[str] = None,
) -> DistMatrix:
    """C := alpha A B + beta C on block-cyclic tile stacks of one mesh.

    ``method`` picks the stationary operand (None: ``select_gemm_method``
    on the tile grids, as ``slate_tpu``); ``lookahead`` (Option.Lookahead,
    None = 1) is GemmC's panel-prefetch depth; ``bcast_impl``
    (Option.BcastImpl) the audited broadcast lowering; ``update_impl``
    (Option.UpdateImpl) GemmC's consume lowering.  Results are bitwise the
    same at every depth and lowering.  GemmA ignores the three options."""
    p, q = mesh_shape(a.mesh)
    if b.grid != (p, q) or b.nb != a.nb:
        raise ValueError("gemm_summa operands must share mesh and nb")
    if a.n != b.m:
        raise ValueError(f"inner dims mismatch: A is {a.m}x{a.n}, B {b.m}x{b.n}")
    if c is not None and (c.m != a.m or c.n != b.n or c.nb != a.nb or c.grid != (p, q)):
        raise ValueError("C dims/layout must match alpha*A@B")
    kt = a.nt
    if b.mt != kt:
        raise ValueError(f"inner tile grids mismatch: {a.nt} vs {b.mt}")
    if method is None:
        method = select_gemm_method(a.mt, b.nt, a.nt)
    if method == MethodGemm.GemmA:
        prod = _summa_a(a, b, p, q)
    else:
        with bcast_impl_scope(resolve_bcast_impl(bcast_impl)), \
                update_impl_scope(resolve_update_impl(update_impl)):
            prod = _summa_c(a, b, p, q, kt, la_depth(lookahead, kt))
    return DistMatrix(tiles=_finish(prod, alpha, beta, c), m=a.m, n=b.n, nb=a.nb, mesh=a.mesh)


def _summa_c(a: DistMatrix, b: DistMatrix, p: int, q: int, kt: int, la: int) -> torch.Tensor:
    """Stationary-C SUMMA: the k-loop of ``slate_tpu``'s ``_summa_jit`` over
    the whole grid at once.  Returns the product's cyclic tile stack."""
    a_loc = local_view(a.tiles, p, q)  # (p, q, mtl, ktl, nb, nb)
    b_loc = local_view(b.tiles, p, q)  # (p, q, ktl2, ntl, nb, nb)
    fused = update_engaged(a.dtype)
    out = torch.zeros((a.mt, b.nt, a.nb, a.nb), dtype=a.dtype, device=a.tiles.device)
    acc = local_view(out, p, q)  # (p, q, mtl, ntl, nb, nb): C's tiles, in place

    def fetch(k):
        # panels are pure functions of the stationary stacks (prefetchable)
        acol = bcast_from_col(a_loc[:, :, :, k // q], k % q, q)  # (p, 1, mtl, nb, nb)
        brow = bcast_from_row(b_loc[:, :, k // p], k % p, p)  # (1, q, ntl, nb, nb)
        return acol, brow

    def consume(k, panels, acc):
        acol, brow = panels
        if fused:  # Option.UpdateImpl: one tile-GEMM launch over the grid
            return summa_update(acc, acol, brow)
        return summa_update_plain(acc, acol, brow)

    prefetch_bcast(kt, la, fetch, consume, acc)
    return out


def _summa_a(a: DistMatrix, b: DistMatrix, p: int, q: int) -> torch.Tensor:
    """Stationary-A SUMMA (``slate_tpu``'s ``_summa_a_jit``): B is
    replicated by two all_gathers, every device multiplies it against its
    own k-slabs of A, and one psum over the column axis reduces the
    partial C; each device keeps its block-cyclic column slice.  Each
    device's product is one einsum (the port computes device by device,
    which bounds the temporaries to one device's share)."""
    a_loc = local_view(a.tiles, p, q)  # (p, q, mtl, ktl, nb, nb)
    b_loc = local_view(b.tiles, p, q)  # (p, q, ktl_b, ntl_b, nb, nb)
    mtl, ktl, nb = a_loc.shape[2], a_loc.shape[3], a.nb
    ntl_b = b_loc.shape[3]
    # bfull[r', c', kappa, nu] = B(r' + p kappa, c' + q nu), on every device
    bfull = all_gather_a(b_loc, COL_AXIS, q)  # (p, 1, q, ktl_b, ntl_b, ...)
    bfull = all_gather_a(bfull, ROW_AXIS, p)  # (1, 1, p, q, ktl_b, ntl_b, ...)
    bfull = bfull[0, 0].movedim(2, 1)  # (p, ktl_b, q, ntl_b, nb, nb)
    part = torch.empty((p, q, mtl, q, ntl_b, nb, nb), dtype=a.dtype, device=a.tiles.device)
    for cc in range(q):
        k_idx = cc + q * torch.arange(ktl, device=a.tiles.device)  # my k-slabs
        bsel = bfull[k_idx % p, k_idx // p]  # (ktl, q, ntl_b, nb, nb)
        for r in range(p):
            part[r, cc] = torch.einsum("ikab,kJjbc->iJjac", a_loc[r, cc], bsel)
    full = psum_a(part, COL_AXIS, q)  # (p, 1, mtl, q, ntl_b, nb, nb)
    out = torch.empty((a.mt, b.nt, nb, nb), dtype=a.dtype, device=a.tiles.device)
    # device (r, c) keeps column slice J == c of the reduced rows
    local_view(out, p, q).copy_(full[:, 0].movedim(2, 1))
    return out
