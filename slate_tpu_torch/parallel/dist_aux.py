"""Distributed norms, Hermitian rank-k updates and condition estimates on
the virtual mesh.

Counterpart of ``slate_tpu/parallel/dist_aux.py`` (the reference's
``src/norm.cc``, ``src/herk.cc``, ``src/gecondest.cc`` and
``pocondest.cc`` at mesh scale):

- :func:`norm_dist`: every device reduces its local tiles, masked to the
  true (m, n) extent so pad tiles and the identity-padded diagonal never
  count, then the partial sums travel through the audited ``psum_a`` and
  the maxima through ``pmax``, in ``slate_tpu``'s order;
- :func:`herk_dist`: C := alpha A A^H + beta C by the SUMMA k-loop with the
  transposed panel gathered by column index (the contraction masked to
  A's true column extent);
- :func:`gecondest_dist` / :func:`pocondest_dist`: the Hager-Higham 1-norm
  power iteration over already-factored tiles, every probe a pair of mesh
  ``trsm_dist`` sweeps on an (n, 1) right-hand side.  ``slate_tpu`` runs
  the probe loop as one ``lax.fori_loop`` of 2 iters + 1 trips (``lax.cond``
  between the two solves), audited once at that multiplicity; the port
  runs it on the host and records as the reference traces: the first trip
  of each solve at the loop's multiplicity, later trips at 0.  The
  estimate is memoized on the factor (see the memo note).  The
  ``num.condest`` gauge comes with the observability slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..obs.span import instrument
from ..types import Diag, Norm, Op, Uplo
from .comm import (
    COL_AXIS,
    ROW_AXIS,
    audit_scope,
    bcast_impl_scope,
    local_indices,
    pmax,
    psum_a,
    resolve_bcast_impl,
)
from .dist import DistMatrix, local_view, padded_tiles
from .dist_blas3 import _her2k_panels, acc_outer, dense_acc, keep_triangle, tiles_of
from .mesh import mesh_shape


def masked_abs(t_loc: torch.Tensor, p: int, q: int, m_true: int, n_true: int) -> torch.Tensor:
    """|t| of a local view (p, q, ..., mtl, ntl, nb, nb), zero outside the
    true (m, n) extent (any dims between the grid and the tile grid are
    batch dims)."""
    mtl, ntl, nb = t_loc.shape[-4], t_loc.shape[-3], t_loc.shape[-1]
    _r, _c, i_log, j_log = local_indices(p, q, mtl, ntl, device=t_loc.device)
    ar = torch.arange(nb, device=t_loc.device)
    gr = (i_log * nb)[..., :, None, None, None] + ar[:, None]  # (p, 1, mtl, 1, nb, 1)
    gc = (j_log * nb)[..., None, :, None, None] + ar  # (1, q, 1, ntl, 1, nb)
    mask = (gr < m_true) & (gc < n_true)
    batch = t_loc.dim() - 6
    mask = mask.view(mask.shape[:2] + (1,) * batch + mask.shape[2:])
    return torch.where(mask, t_loc.abs(), torch.zeros((), dtype=t_loc.real.dtype,
                                                      device=t_loc.device))


@instrument("norm_dist")
def norm_dist(norm: Norm, d: DistMatrix) -> torch.Tensor:
    """One / Inf / Max / Fro norm of a DistMatrix, computed distributed: a
    0-d tensor of the real dtype."""
    p, q = mesh_shape(d.mesh)
    absa = masked_abs(local_view(d.tiles, p, q), p, q, d.m, d.n)  # (p, q, mtl, ntl, nb, nb)

    def allred_max(x):
        return pmax(pmax(x, ROW_AXIS, p), COL_AXIS, q)

    if norm == Norm.Max:
        out = allred_max(absa.amax(dim=(2, 3, 4, 5)))
    elif norm == Norm.Fro:
        # lassq-style: divide by the global max before squaring
        amax = allred_max(absa.amax(dim=(2, 3, 4, 5)))  # (1, 1)
        scale = torch.where(amax > 0, amax, torch.ones_like(amax))
        ssq = ((absa / scale[..., None, None, None, None]) ** 2).sum(dim=(2, 3, 4, 5))
        ssq = psum_a(psum_a(ssq, ROW_AXIS, p), COL_AXIS, q)
        out = scale * torch.sqrt(ssq)
    elif norm == Norm.One:
        colsums = psum_a(absa.sum(dim=(2, 4)), ROW_AXIS, p)  # (1, q, ntl, nb)
        out = pmax(pmax(colsums.amax(dim=(2, 3)), COL_AXIS, q), ROW_AXIS, p)
    elif norm == Norm.Inf:
        rowsums = psum_a(absa.sum(dim=(3, 5)), COL_AXIS, q)  # (p, 1, mtl, nb)
        out = allred_max(rowsums.amax(dim=(2, 3)))
    else:
        raise ValueError(norm)
    return out[0, 0]


@instrument("herk_dist")
def herk_dist(
    alpha,
    a: DistMatrix,
    beta=0.0,
    c: Optional[DistMatrix] = None,
    uplo: Uplo = Uplo.Lower,
    full: bool = False,
    bcast_impl=None,
) -> DistMatrix:
    """C := alpha A A^H + beta C, C Hermitian (m, m) distributed.  ``full``
    fills both triangles, else only the ``uplo`` triangle (and the
    diagonal) is written (slate::herk's storage contract); ``bcast_impl``
    is the audited lowering of the panel broadcasts."""
    p, q = mesh_shape(a.mesh)
    if c is not None and (c.m != a.m or c.n != a.m or c.grid != (p, q) or c.nb != a.nb):
        raise ValueError("herk_dist: C layout must match A A^H")
    a_loc = local_view(a.tiles, p, q)
    nb = a.nb
    acc = dense_acc(p, q, a_loc.shape[2], -(-a.mt // q), nb, a.dtype, a.tiles.device)
    with bcast_impl_scope(resolve_bcast_impl(bcast_impl)):
        for k in range(a.nt):
            # the column panel masked to A's true column extent (identity pad
            # diagonals must not leak into A A^H) and its transposed gather
            acol, pan_t = _her2k_panels(a_loc, k, p, q, a.n, a.dtype.is_complex)
            acc_outer(acc, acol, pan_t.transpose(-1, -2))
    if not full:
        keep_triangle(acc, p, q, nb, uplo)
    prod = tiles_of(acc, nb).mul_(alpha)
    if c is not None:
        prod.add_(c.tiles * beta)
    return DistMatrix(tiles=prod, m=a.m, n=a.m, nb=nb, mesh=a.mesh, diag_pad=a.mt * nb == a.m)


# ---------------------------------------------------------------------------
# distributed condition estimation
# ---------------------------------------------------------------------------


def _norm1est_dist(measure_solve, transfer_solve, n: int, dtype, device, iters: int = 5,
                   same_verb: bool = False) -> torch.Tensor:
    """The xLACN2 1-norm power iteration of ``linalg.norms.norm1est`` as
    ``slate_tpu``'s single loop of 2 iters + 1 phase-alternating trips:
    even trips apply the MEASURE solve (the last one to the alternating-sign
    safeguard vector), odd trips the TRANSFER solve (steering the next
    probe by argmax).  ``same_verb`` (a Hermitian A^-1) sends both phases
    through the measure solve.  Audit: ``slate_tpu`` traces the body once
    at the loop's multiplicity, a ``lax.cond`` with both of its branches,
    so each solve's first call records at 2 iters + 1 and the rest at 0."""
    trips = 2 * iters + 1
    cplx = dtype.is_complex

    def sign_of(y):
        if cplx:
            ay = y.abs()
            one = torch.ones((), dtype=dtype, device=device)
            return torch.where(ay == 0, one, y / torch.where(ay == 0, 1, ay)).to(dtype)
        return torch.where(y >= 0, 1.0, -1.0).to(dtype)

    # alternating-sign safeguard vector (xLACN2's final stage)
    kk = torch.arange(n, dtype=torch.float64, device=device)
    v = (1.0 - 2.0 * (kk % 2)).to(dtype) * (1.0 + kk / max(n - 1, 1)).to(dtype)
    x = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
    y = torch.zeros((n,), dtype=dtype, device=device)
    est = torch.zeros((), dtype=torch.float64, device=device)
    alt = torch.zeros((), dtype=torch.float64, device=device)
    traced = set()
    for i in range(trips):
        phase0 = i % 2 == 0
        verb = measure_solve if (phase0 or same_verb) else transfer_solve
        with audit_scope(0 if verb in traced else trips):
            out = verb(v if i == 2 * iters else x) if phase0 else verb(sign_of(y))
        traced.add(verb)
        s = out.abs().sum().to(torch.float64)
        if phase0:
            if i == 2 * iters:
                alt = 2.0 * s / (3.0 * n)
            else:
                est = torch.maximum(est, s)
            y = out
        else:
            x = torch.zeros((n,), dtype=dtype, device=device)
            x[torch.argmax(out.abs()).view(1)] = 1.0
    return torch.maximum(est, alt)


# Condest memo.  slate_tpu keeps the estimate on the factor object (a dict
# set through object.__setattr__; the memo dies with the factor) and trusts
# the factor's tiles never to change, as jax arrays cannot.  A torch factor
# can be written in place afterwards, so an entry also holds the tiles'
# identity (summa.tensor_key: storage, layout and version counter), and a
# hit holds only while it agrees.  A write that leaves the version counter
# as it was (through ``.data`` or a numpy alias) is not seen: a caller who
# writes a factor so builds a new DistMatrix for it.


def _condest_memo_key(verb: str, norm: Norm, lookahead, bcast_impl, iters: int, anorm):
    return (verb, norm.value, lookahead, resolve_bcast_impl(bcast_impl), iters, float(anorm))


def _condest_memo_get(factor: DistMatrix, key):
    from ..obs.metrics import serve_count
    from .summa import tensor_key

    memo = getattr(factor, "_condest_memo", None)
    hit = None if memo is None else memo.get(key)
    if hit is None or hit[0] != tensor_key(factor.tiles):
        return None
    serve_count("condest_cache_hits")
    return hit[1]


def _condest_memo_put(factor: DistMatrix, key, rcond: torch.Tensor) -> None:
    from .summa import tensor_key

    memo = getattr(factor, "_condest_memo", None)
    if memo is None:
        memo = {}
        object.__setattr__(factor, "_condest_memo", memo)
    memo[key] = (tensor_key(factor.tiles), rcond)


def _probe_vec(ld: DistMatrix):
    """(to tiles, to vector) maps between an (n,) probe and an (n, 1)
    DistMatrix on the factor's grid."""
    from .dist_refine import _tiles_to_vec, _vec_to_tiles

    p, q = mesh_shape(ld.mesh)
    n, nb = ld.m, ld.nb
    mt, ntv = ld.mt, padded_tiles(1, nb, ld.mesh)

    def dvec(x):
        return DistMatrix(tiles=_vec_to_tiles(x, nb, p, q, mt, ntv), m=n, n=1, nb=nb,
                          mesh=ld.mesh)

    def tvec(d):
        return _tiles_to_vec(d.tiles, n, p, q)

    return dvec, tvec


@instrument("gecondest_dist")
def gecondest_dist(lud: DistMatrix, perm, anorm, norm: Norm = Norm.One, lookahead=None,
                   bcast_impl=None, iters: int = 5) -> torch.Tensor:
    """Reciprocal 1-norm (or Inf-norm) condition estimate from a
    distributed partial-pivot / tournament LU factor (slate::gecondest at
    mesh scale): every probe is a pair of mesh trsm sweeps, O(n^2 / P).
    ``perm`` is the padded-row-space permutation the factor drivers return,
    ``anorm`` the matching norm of A (``norm_dist``).  Probe solves are
    single-column, so ``lookahead`` defaults to the strict depth 0.
    Returns rcond = 1 / (||A|| ||A^-1||_est), a 0-d f64 tensor; memoized on
    the factor."""
    from ..linalg.norms import _recondest
    from .dist_lu import permute_rows_dist
    from .dist_trsm import trsm_dist

    key = _condest_memo_key("ge", norm, lookahead, bcast_impl, iters, anorm)
    cached = _condest_memo_get(lud, key)
    if cached is not None:
        return cached
    la = 0 if lookahead is None else lookahead
    bi = resolve_bcast_impl(bcast_impl)
    dev = lud.tiles.device
    perm = torch.as_tensor(perm, device=dev)
    inv_perm = torch.argsort(perm)
    dvec, tvec = _probe_vec(lud)

    def fwd(x):
        # A^-1 x = U^-1 L^-1 P x  (P A = L U)
        pr = permute_rows_dist(dvec(x), perm)
        y = trsm_dist(lud, pr, Uplo.Lower, Op.NoTrans, Diag.Unit, lookahead=la, bcast_impl=bi)
        return tvec(trsm_dist(lud, y, Uplo.Upper, Op.NoTrans, lookahead=la, bcast_impl=bi))

    def adj(x):
        # A^-H x = P^T L^-H U^-H x
        z = trsm_dist(lud, dvec(x), Uplo.Upper, Op.ConjTrans, lookahead=la, bcast_impl=bi)
        w = trsm_dist(lud, z, Uplo.Lower, Op.ConjTrans, Diag.Unit, lookahead=la, bcast_impl=bi)
        return tvec(permute_rows_dist(w, inv_perm))

    measure, transfer = (adj, fwd) if norm == Norm.Inf else (fwd, adj)
    ainv = _norm1est_dist(measure, transfer, lud.m, lud.dtype, dev, iters)
    rcond = _recondest(torch.as_tensor(anorm, device=dev).to(torch.float64), ainv)
    _condest_memo_put(lud, key, rcond)
    return rcond


@instrument("pocondest_dist")
def pocondest_dist(ld: DistMatrix, anorm, lookahead=None, bcast_impl=None,
                   iters: int = 5) -> torch.Tensor:
    """Reciprocal condition estimate from a distributed Cholesky factor
    (slate::pocondest at mesh scale): A^-1 is Hermitian, so one solve verb
    (two mesh trsm sweeps) serves both probe directions; strict-depth
    probes and the memo as :func:`gecondest_dist`."""
    from ..linalg.norms import _recondest
    from .dist_trsm import trsm_dist

    key = _condest_memo_key("po", Norm.One, lookahead, bcast_impl, iters, anorm)
    cached = _condest_memo_get(ld, key)
    if cached is not None:
        return cached
    la = 0 if lookahead is None else lookahead
    bi = resolve_bcast_impl(bcast_impl)
    dev = ld.tiles.device
    dvec, tvec = _probe_vec(ld)

    def solve(x):
        y = trsm_dist(ld, dvec(x), Uplo.Lower, Op.NoTrans, lookahead=la, bcast_impl=bi)
        return tvec(trsm_dist(ld, y, Uplo.Lower, Op.ConjTrans, lookahead=la, bcast_impl=bi))

    ainv = _norm1est_dist(solve, solve, ld.m, ld.dtype, dev, iters, same_verb=True)
    rcond = _recondest(torch.as_tensor(anorm, device=dev).to(torch.float64), ainv)
    _condest_memo_put(ld, key, rcond)
    return rcond
