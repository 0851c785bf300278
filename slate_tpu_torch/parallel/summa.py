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
kernel.

:func:`gemm_summa_ozaki` (``Option.ResidualImpl=ozaki``, the mixed
ladder's residual) runs the same GemmC k-loop with the int8 digit planes of
``ops/ozaki.py`` as the broadcast payload: ``n_slices`` bytes per element,
``n_slices``/8 of the f64 volume, in the audit too.  :func:`ozaki_presplit`
and :func:`ozaki_presplit_cached` split a stationary A once.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# The Ozaki SUMMA: the GemmC k-loop with int8 digit planes as the payload
# ---------------------------------------------------------------------------


class OzakiSplit(NamedTuple):
    """A's digit planes and exponent grid in the global cyclic storage of
    ``slate_tpu``'s ``OzakiSplit``: ``qa`` (S, mt, kt, nb, nb) int8, ``ea``
    (mt, nb) f32, the per-row grid the planes were sliced on (replicated
    along the mesh columns).  Results are bitwise the same with or without
    presplitting."""

    qa: torch.Tensor
    ea: torch.Tensor


def ozaki_presplit(a: DistMatrix, n_slices: int = 9) -> OzakiSplit:
    """A's f64 tiles as the int8 digit planes and exponent grid the Ozaki
    SUMMA consumes.  Every device's local row maxima reduced by pmax over
    the mesh columns is the global row max, taken here on the cyclic stack
    at once (the max is exact, so the grid is every device's and the planes
    are mesh-shape invariant)."""
    from ..ops import ozaki

    if a.dtype != torch.float64:
        raise TypeError(f"ozaki_presplit requires f64 tiles, got {a.dtype}")
    amax = a.tiles.abs().amax(dim=(1, 3)).to(torch.float32)  # (mt, nb)
    ea = ozaki.row_exp_from_absmax(amax)
    qa = ozaki.split_tiles(a.tiles, ea[:, None, :, None], n_slices)
    return OzakiSplit(qa=qa, ea=ea)


# Stationary-A digit-plane cache.  slate_tpu keys it on id(a.tiles), safe
# there because jax arrays are immutable; the port updates tensors in place
# (matmul_sub_, overwrite_a), so the key is the storage, layout AND version
# counter: a write in place bumps tensor._version and misses.  A write made
# past the counter (through ``.data``, a numpy or DLPack alias, a raw
# pointer) keeps the key, so the entry also holds a copy of the tiles, and
# a hit holds only while the tiles are bitwise that copy (one compare
# against the split's several passes); otherwise the entry is dropped and A
# split anew.  Residency: 8 entries, each its split (9 B an element) and
# the copy (8 B), and operands above SLATE_TPU_OZAKI_SPLIT_CACHE_MAX_BYTES
# (default 256 MiB) bypass it.
_OZAKI_SPLIT_CACHE: "OrderedDict" = OrderedDict()
_OZAKI_SPLIT_CAP = 8
_OZAKI_SPLIT_MAX_BYTES_ENV = "SLATE_TPU_OZAKI_SPLIT_CACHE_MAX_BYTES"


def _ozaki_split_max_bytes() -> int:
    try:
        return int(float(os.environ.get(_OZAKI_SPLIT_MAX_BYTES_ENV, "") or (1 << 28)))
    except ValueError:
        return 1 << 28


def tensor_key(t: torch.Tensor) -> tuple:
    """Identity of a tensor's current contents for the host caches: storage
    pointer, shape, strides, dtype, device and version counter."""
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype, str(t.device),
            t._version)


def same_bits(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Bitwise equality of two f64 tensors (NaN payloads and signed zeros
    included): the host caches' check of a key hit."""
    return x.shape == y.shape and torch.equal(x.view(torch.int64), y.view(torch.int64))


def ozaki_presplit_cached(a: DistMatrix, n_slices: int = 9) -> OzakiSplit:
    """:func:`ozaki_presplit` memoized on A's tiles (see the cache note):
    repeated residuals against one stationary A split it once.  Counts
    ``ozaki_presplits`` and ``ozaki_presplit_hits``."""
    from ..obs.metrics import serve_count

    if a.tiles.numel() * a.tiles.element_size() > _ozaki_split_max_bytes():
        return ozaki_presplit(a, n_slices)
    key = (tensor_key(a.tiles), n_slices)
    hit = _OZAKI_SPLIT_CACHE.get(key)
    if hit is not None:
        if same_bits(a.tiles, hit[0]):
            _OZAKI_SPLIT_CACHE.move_to_end(key)
            serve_count("ozaki_presplit_hits")
            return hit[1]
        del _OZAKI_SPLIT_CACHE[key]  # written past the version counter
    split = ozaki_presplit(a, n_slices)
    _OZAKI_SPLIT_CACHE[key] = (a.tiles.clone(), split)
    while len(_OZAKI_SPLIT_CACHE) > _OZAKI_SPLIT_CAP:
        _OZAKI_SPLIT_CACHE.popitem(last=False)
    serve_count("ozaki_presplits")
    return split


def clear_ozaki_split_cache() -> None:
    _OZAKI_SPLIT_CACHE.clear()


def _plane_view(planes: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Digit planes (S, mt, nt, nb, nb) of a cyclic stack as the virtual
    mesh's local planes, a (p, q, S, mtl, ntl, nb, nb) view."""
    s_, mt, nt, nb, nb2 = planes.shape
    return planes.view(s_, p, mt // p, q, nt // q, nb, nb2).permute(1, 3, 0, 2, 4, 5, 6)


def gemm_summa_ozaki(
    alpha,
    a: DistMatrix,
    b: DistMatrix,
    beta=0.0,
    c: Optional[DistMatrix] = None,
    lookahead: Optional[int] = None,
    bcast_impl: Optional[str] = None,
    n_slices: int = 9,
    a_split: Optional[OzakiSplit] = None,
) -> DistMatrix:
    """C := alpha A B + beta C with the product by the Ozaki scheme on the
    block-cyclic stacks: ``gemm_summa``'s GemmC k-loop (Option.Lookahead,
    Option.BcastImpl), each step broadcasting the panels' int8 digit planes
    and folding their exact int32 products into an f64 accumulator
    (``ops.ozaki.accumulate_diag_planes``).  The digit grids come from
    global row (A) and column (B) maxima and the fold follows the logical k
    order, so the result is bitwise the same on every mesh shape and
    bitwise ``slate_tpu``'s.  f64 only; ``n_slices`` 9 is full f64
    accuracy, 6 the ~2^-33 tier.  ``a_split`` is A's precomputed split
    (:func:`ozaki_presplit_cached`)."""
    from ..ops import ozaki

    p, q = mesh_shape(a.mesh)
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"gemm_summa_ozaki requires f64 operands, got {a.dtype}, {b.dtype}")
    if b.grid != (p, q) or b.nb != a.nb:
        raise ValueError("gemm_summa_ozaki operands must share mesh and nb")
    if a.n != b.m or a.nt != b.mt:
        raise ValueError(f"inner dims mismatch: A is {a.m}x{a.n}, B {b.m}x{b.n}")
    if c is not None and (c.m != a.m or c.n != b.n or c.nb != a.nb or c.grid != (p, q)):
        raise ValueError("C dims/layout must match alpha*A@B")
    if a_split is None:
        a_split = ozaki_presplit(a, n_slices)
    elif a_split.qa.shape[0] != n_slices:
        raise ValueError(f"a_split carries {a_split.qa.shape[0]} planes, kernel wants {n_slices}")
    kt, nb = a.nt, a.nb
    # B's per-column grid: the local column maxima pmax'd over the mesh rows
    bmax = b.tiles.abs().amax(dim=(0, 2)).to(torch.float32)  # (nt, nb)
    eb = ozaki.row_exp_from_absmax(bmax)
    qb = ozaki.split_tiles(b.tiles, eb[None, :, None, :], n_slices)  # (S, kt, nt, nb, nb)
    qa_loc = _plane_view(a_split.qa, p, q)  # (p, q, S, mtl, ktl, nb, nb)
    qb_loc = _plane_view(qb, p, q)  # (p, q, S, ktl, ntl, nb, nb)
    acc = torch.zeros((a.mt, b.nt, nb, nb), dtype=torch.float64, device=a.tiles.device)

    def fetch(k):
        # the gemm_summa panel broadcasts, payload = the int8 digit planes
        acol = bcast_from_col(qa_loc[:, :, :, :, k // q], k % q, q)
        brow = bcast_from_row(qb_loc[:, :, :, k // p], k % p, p)
        return acol, brow  # (p, 1, S, mtl, nb, nb), (1, q, S, ntl, nb, nb)

    def consume(k, panels, acc):
        acol, brow = panels
        # device (r, c) folds acol[r] x brow[c] into its tiles: over the grid,
        # the planes of global tile column k against global tile row k
        s_ = acol.shape[2]
        qa_k = acol[:, 0].movedim(1, 0).reshape(s_, a.mt, nb, nb)
        qb_k = brow[0].movedim(1, 0).reshape(s_, b.nt, nb, nb)
        return ozaki.accumulate_diag_planes(acc, qa_k, qb_k, n_slices)

    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        acc = prefetch_bcast(kt, la_depth(lookahead, kt), fetch, consume, acc)
    sa = ozaki.exp2_scale_f64(a_split.ea)[:, None, :, None]  # (mt, 1, nb, 1)
    sb = ozaki.exp2_scale_f64(eb)[None, :, None, :]  # (1, nt, 1, nb)
    prod = ozaki.scale_rows_cols_f64(acc, sa, sb)
    return DistMatrix(tiles=_finish(prod, alpha, beta, c), m=a.m, n=b.n, nb=nb, mesh=a.mesh)
