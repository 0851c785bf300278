"""Mixed-precision mesh solves: the f32 factor + f64 refinement ladder behind
the default f64 ``posv_mesh`` / ``gesv_mesh``.

Counterpart of ``slate_tpu/parallel/dist_refine.py`` (the reference's
``gesv_mixed`` / ``posv_mixed`` and their GMRES-IR forms at mesh scale),
with its names, options, counters and order:

- ``Option.MixedPrecision`` (resolve chain: explicit option > ``use_mixed``
  context > ``SLATE_TPU_MIXED`` > ``auto``): ``off`` keeps the direct f64
  path, ``ir`` / ``gmres`` pin one tier, ``auto`` runs the ladder IR ->
  GMRES-IR -> the full-f64 fallback (:func:`mixed_mesh_route`).
- ``Option.ResidualImpl``: the residual ``b - A x`` by the f64 GemmC SUMMA
  (``f64``) or by the Ozaki int8 SUMMA (``ozaki``, ``summa.gemm_summa_ozaki``
  with A split once per operator).  ``auto`` is ``ozaki`` on a TPU and
  ``f64`` elsewhere: on the card it is ``f64``.
- Classic IR (:func:`posv_mixed_mesh`, :func:`gesv_mixed_mesh`): the f32
  mesh factor (every opt threaded: Lookahead, BcastImpl, PanelImpl,
  FaultTolerance) applied by the f32 triangular sweeps, refined against the
  f64 residual until ``||r|| <= ||x|| ||A|| eps sqrt(n)``
  (``linalg.refine.gate_cte``).
- Distributed GMRES-IR (:func:`posv_mixed_gmres_mesh`,
  :func:`gesv_mixed_gmres_mesh`): left-preconditioned restarted GMRES per
  right-hand side, the operator (SUMMA matvec) and the preconditioner (the
  f32 factor's sweeps) applied on the mesh.

The loops are host loops.  ``slate_tpu``'s refinement is one
``lax.while_loop`` with no host sync; here each refinement trip reads its
convergence test on the host once (one scalar), and the GMRES Arnoldi steps
read their measured residual once per step.  The arithmetic of every trip
is ``slate_tpu``'s, so ``iters``, the tier taken and the ``ir.*`` counters
agree.  The comm audit agrees too: ``slate_tpu`` records a loop's
collectives once, when it traces the body, at the loop's worst-case trip
count; here the first trip records at that multiplicity
(``comm.audit_scope``) and later trips at 0.  (A failed factor never
enters the loop here, so it records no loop collectives; ``slate_tpu``
traces the body all the same.)

The routed ladder runs in one ``{kind}_mixed`` driver span with a phase
per tier (``ir``, ``gmres``, ``fallback``); a refinement trip tags its
solve ``correct`` and its residual ``residual`` for the schedule capture,
and the flight recorder records the factor but not the refinement loops
(``obs.flight.no_flight``), as in ``slate_tpu``.

Under ``Option.NumMonitor=on`` (auto: on iff observability is on) the
refinement keeps its (||r||, ||x||) trajectory, read back once at the end
(``ir.residual_history``), and ``MixedPrecision=auto`` takes the health
tier (``_route_health``, a ``health`` phase of the span): the f32 factor's
growth / margin gauges and a distributed condition estimate decide whether
the solve enters at GMRES-IR instead of IR (``num.routed_gmres``).
"""

from __future__ import annotations

import contextlib
import math
import os
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..obs import flight as _flight
from ..obs.span import driver_span, instrument
from ..linalg.refine import _lstsq_min_norm, gate_cte, ir_count, ir_gauge
from ..ops.matmul import matmul
from ..types import Diag, MethodGemm, Norm, Op, Option, Options, Uplo, get_option
from .comm import (COL_AXIS, ROW_AXIS, audit_scope, phase_scope, pmax, psum_a,
                   resolve_bcast_impl)
from .dist import DistMatrix, from_dense, local_view, padded_tiles, to_dense
from .dist_aux import masked_abs, norm_dist
from .dist_lu import permute_rows_dist
from .dist_trsm import trsm_dist
from .mesh import VirtualMesh, mesh_shape
from .summa import (OzakiSplit, gemm_summa, gemm_summa_ozaki, ozaki_presplit_cached, same_bits,
                    tensor_key)

_DEFAULT_NB = 256

# ---------------------------------------------------------------------------
# Option.MixedPrecision / Option.ResidualImpl
# ---------------------------------------------------------------------------

MIXED_MODES = ("off", "ir", "gmres", "auto")
MIXED_ENV = "SLATE_TPU_MIXED"
_MIXED_DEFAULT = [None]

RESIDUAL_IMPLS = ("f64", "ozaki", "auto")
RESIDUAL_ENV = "SLATE_TPU_RESIDUAL_IMPL"


def _check_mode(mode: str) -> str:
    if mode not in MIXED_MODES:
        raise ValueError(
            f"unknown mixed-precision mode {mode!r}; expected one of {MIXED_MODES}"
        )
    return mode


def resolve_mixed(opts: Optional[Options] = None) -> str:
    """Resolved Option.MixedPrecision mode: explicit option >
    ``use_mixed`` context > ``SLATE_TPU_MIXED`` env > ``auto``."""
    mode = get_option(opts, Option.MixedPrecision)
    if mode is None:
        mode = _MIXED_DEFAULT[-1]
    if mode is None:
        mode = os.environ.get(MIXED_ENV) or "auto"
    return _check_mode(str(mode))


@contextlib.contextmanager
def use_mixed(mode: str):
    """Session-default mixed-precision mode for drivers called inside; an
    explicit Option.MixedPrecision still wins."""
    _MIXED_DEFAULT.append(_check_mode(mode))
    try:
        yield
    finally:
        _MIXED_DEFAULT.pop()


def resolve_residual_impl(opts: Optional[Options] = None) -> str:
    """Resolved Option.ResidualImpl: explicit option >
    ``SLATE_TPU_RESIDUAL_IMPL`` env > auto (``ozaki`` on a TPU backend,
    ``f64`` elsewhere, so ``f64`` in the port)."""
    impl = get_option(opts, Option.ResidualImpl)
    if impl is None:
        impl = os.environ.get(RESIDUAL_ENV) or "auto"
    impl = str(impl)
    if impl not in RESIDUAL_IMPLS:
        raise ValueError(f"unknown residual impl {impl!r}; expected one of {RESIDUAL_IMPLS}")
    if impl == "auto":
        from ..ops.matmul import _tpu_is_default

        return "ozaki" if _tpu_is_default() else "f64"
    return impl


def _la(opts):
    return get_option(opts, Option.Lookahead)


def _max_iter(opts, max_iter=None) -> int:
    if max_iter is not None:
        return int(max_iter)
    return int(get_option(opts, Option.MaxIterations, 30))


def _astype_dist(d: DistMatrix, dtype) -> DistMatrix:
    return DistMatrix(tiles=d.tiles.to(dtype), m=d.m, n=d.n, nb=d.nb, mesh=d.mesh,
                      diag_pad=d.diag_pad)


def _is_f64(x) -> bool:
    dt = getattr(x, "dtype", None)
    return dt == torch.float64 or (isinstance(dt, np.dtype) and dt == np.float64)


def _require_f64(a, who: str) -> None:
    if not _is_f64(a):
        raise TypeError(
            f"{who} is the f32-factor + f64-refine path and requires float64 "
            f"input, got {getattr(a, 'dtype', None)}; complex/f32 solves use the direct drivers"
        )


def residual_comm_bytes(
    mt: int, ntb: int, kt: int, nb: int, p: int, q: int,
    bcast_impl: Optional[str] = None, residual_impl: str = "f64",
    n_slices: int = 9,
) -> int:
    """Audited comm bytes of ONE residual SUMMA (A (mt x kt tiles) against
    X (kt x ntb tiles)): the GemmC broadcast volume times the payload size,
    8 B per element for the f64 panels, ``n_slices`` B for the int8 digit
    planes."""
    itemsize = n_slices if residual_impl == "ozaki" else 8
    mtl, ntl = mt // p, ntb // q
    a_bytes = mtl * nb * nb * itemsize
    b_bytes = ntl * nb * nb * itemsize
    if resolve_bcast_impl(bcast_impl) == "psum":
        return kt * (a_bytes + b_bytes)
    return kt * ((q - 1) * a_bytes + (p - 1) * b_bytes)


def _inf_norm_pair(rt: torch.Tensor, xt: torch.Tensor, mesh: VirtualMesh, m_true: int,
                   n_true: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inf-norms of two same-shape tile stacks with one row-sum psum: the
    refinement loop's (||r||, ||x||) per trip."""
    p, q = mesh_shape(mesh)
    st = torch.stack([local_view(rt, p, q), local_view(xt, p, q)], dim=2)
    absa = masked_abs(st, p, q, m_true, n_true)  # (p, q, 2, mtl, ntl, nb, nb)
    rowsums = psum_a(absa.sum(dim=(4, 6)), COL_AXIS, q)  # (p, 1, 2, mtl, nb)
    out = pmax(pmax(rowsums.amax(dim=(3, 4)), ROW_AXIS, p), COL_AXIS, q)[0, 0]
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Classic iterative refinement
# ---------------------------------------------------------------------------


def _ir_common(ad: DistMatrix, bd: DistMatrix, lo_solve, info, max_iter: int, la, bi: str,
               ri: str, split: Optional[OzakiSplit] = None, nm: bool = False):
    """The refinement loop over a factored low-precision solve.

    ``lo_solve(rd) -> DistMatrix`` applies the f32 factor and returns the
    f64 upcast.  Returns (x_tiles, iters, converged, rnorm, xnorm, history).
    A failed factor (info != 0) skips the loop and NaN-fills x.  The first
    trip is the initial solve (x = 0, r = b, it = -1), so ``iters`` counts
    the correction steps after it, as in ``slate_tpu``.  ``nm``
    (monitored) keeps each trip's (||r||, ||x||) on the device: ``history``
    is the (max_iter + 1, 2) trajectory, NaN past the last trip, as
    ``slate_tpu``'s carried buffer (None unmonitored)."""
    n = ad.m
    anorm = norm_dist(Norm.Inf, ad)
    cte = gate_cte(anorm, n, ad.tiles.dtype)
    ok = bool(torch.as_tensor(info) == 0)

    def wrap(t, like):
        return DistMatrix(tiles=t, m=like.m, n=like.n, nb=like.nb, mesh=like.mesh,
                          diag_pad=like.diag_pad)

    def residual(x_t):
        if ri == "ozaki":
            return gemm_summa_ozaki(-1.0, ad, wrap(x_t, bd), 1.0, bd, lookahead=la,
                                    bcast_impl=bi, a_split=split).tiles
        return gemm_summa(-1.0, ad, wrap(x_t, bd), 1.0, bd, method=MethodGemm.GemmC,
                          lookahead=la, bcast_impl=bi).tiles

    rdt = ad.tiles.real.dtype
    x_t, r_t = torch.zeros_like(bd.tiles), bd.tiles
    rn = torch.tensor(math.inf, dtype=rdt, device=bd.tiles.device)
    xn = torch.zeros((), dtype=rdt, device=bd.tiles.device)
    it, done = -1, False
    trips = []
    while ok and not done and it < max_iter:
        # slate_tpu audits the loop body once at max_iter + 1 trips; the
        # flight recorder does not descend into it (slate_tpu's fused loop
        # has no host between its phases): the factor before it records
        with audit_scope(max_iter + 1 if it == -1 else 0), _flight.no_flight():
            with phase_scope("correct"):
                d = lo_solve(wrap(r_t, bd)).tiles
            x_t = x_t + d
            with phase_scope("residual"):
                r_t = residual(x_t)
            rn, xn = _inf_norm_pair(r_t, x_t, ad.mesh, bd.m, bd.n)
        if nm:
            trips.append(torch.stack([rn, xn]))
        it += 1
        done = bool(rn <= xn * cte)  # the one host read per trip
    if not ok:
        x_t = torch.full_like(x_t, math.nan)
    hist = None
    if nm:
        hist = torch.full((max_iter + 1, 2), math.nan, dtype=rdt, device=bd.tiles.device)
        if trips:
            hist[:len(trips)] = torch.stack(trips)
    return x_t, it, done and ok, rn, xn, hist


def _posv_lo_solve(ld: DistMatrix, la, bi: str):
    def lo_solve(rd: DistMatrix) -> DistMatrix:
        r32 = _astype_dist(rd, torch.float32)
        y = trsm_dist(ld, r32, Uplo.Lower, Op.NoTrans, lookahead=la, bcast_impl=bi)
        x = trsm_dist(ld, y, Uplo.Lower, Op.ConjTrans, lookahead=la, bcast_impl=bi)
        return _astype_dist(x, rd.dtype)

    return lo_solve


def _gesv_lo_solve(lud: DistMatrix, perm, la, bi: str):
    def lo_solve(rd: DistMatrix) -> DistMatrix:
        r32 = _astype_dist(rd, torch.float32)
        pr = permute_rows_dist(r32, perm)
        y = trsm_dist(lud, pr, Uplo.Lower, Op.NoTrans, Diag.Unit, lookahead=la, bcast_impl=bi)
        x = trsm_dist(lud, y, Uplo.Upper, Op.NoTrans, lookahead=la, bcast_impl=bi)
        return _astype_dist(x, rd.dtype)

    return lo_solve


def _factor_f32(kind: str, a: torch.Tensor, mesh: VirtualMesh, nb: int, opts):
    """The f32 mesh factor with ``opts`` threaded as a direct f32 call would
    (Lookahead, BcastImpl, PanelImpl, FaultTolerance)."""
    from .drivers import getrf_mesh, potrf_mesh

    a32 = a.to(torch.float32)
    if kind == "posv":
        l, info = potrf_mesh(a32, mesh, nb, opts)
        return l, None, info
    return getrf_mesh(a32, mesh, nb, opts)


def _prefactor(kind: str, a: torch.Tensor, mesh: VirtualMesh, nb: int, opts):
    """(fact, perm, info, ad): the f32 factor and the distributed f64 A,
    computed once per routed solve and shared down the ladder.  posv reads
    the lower triangle (the potrf contract) and refines against its mirror
    (real f64: no conjugation); for a full symmetric A that is the bitwise
    identity."""
    a = _refined_operand(kind, a)
    fact, perm, info = _factor_f32(kind, a, mesh, nb, opts)
    ad = from_dense(a, mesh, nb, diag_pad_one=True)
    return fact, perm, info, ad


def _refined_operand(kind: str, a: torch.Tensor) -> torch.Tensor:
    return torch.tril(a) + torch.tril(a, -1).T if kind == "posv" else a


# Stationary-operator prefactor memo (one operator, a stream of right-hand
# sides).  slate_tpu keys it on id(a) (jax arrays are immutable); the key
# here is the tensor's storage, layout and version counter
# (summa.tensor_key), so a write into A in place misses at once.  A write
# made past the version counter (through ``.data``, a numpy or DLPack alias,
# a raw pointer) keeps the key, so a hit also rebuilds A's distributed f64
# form and holds only while it is bitwise the cached one (one O(n^2) pass
# against the O(n^3) factor it saves); otherwise the entry is dropped and A
# factored anew.  Only a torch tensor already on the mesh's device is
# memoized (a numpy operand is copied per call), and residency is bounded
# by the entry cap and SLATE_TPU_PREFACTOR_CACHE_MAX_BYTES (default 256 MiB,
# 0 disables).
_PREFACTOR_MEMO: "OrderedDict" = OrderedDict()
_PREFACTOR_CAP = 4
_PREFACTOR_MAX_BYTES_ENV = "SLATE_TPU_PREFACTOR_CACHE_MAX_BYTES"


def _prefactor_max_bytes() -> int:
    try:
        return int(float(os.environ.get(_PREFACTOR_MAX_BYTES_ENV, "") or (1 << 28)))
    except ValueError:
        return 1 << 28


def clear_prefactor_cache() -> None:
    _PREFACTOR_MEMO.clear()


def _prefactor_cached(kind: str, a, mesh: VirtualMesh, nb: int, opts):
    """:func:`_prefactor` memoized on the operand (see the memo note)."""
    if (not isinstance(a, torch.Tensor) or a.device.type != mesh.device.type
            or a.numel() * a.element_size() > _prefactor_max_bytes()):
        return _prefactor(kind, torch.as_tensor(a, device=mesh.device), mesh, nb, opts)
    from ..serve.cache import options_signature

    key = (tensor_key(a), kind, id(mesh), nb, options_signature(opts))
    hit = _PREFACTOR_MEMO.get(key)
    if hit is not None:
        ad = from_dense(_refined_operand(kind, a), mesh, nb, diag_pad_one=True)
        if same_bits(ad.tiles, hit[3].tiles):
            _PREFACTOR_MEMO.move_to_end(key)
            return hit
        del _PREFACTOR_MEMO[key]  # written past the version counter
    pre = _prefactor(kind, a, mesh, nb, opts)
    _PREFACTOR_MEMO[key] = pre
    while len(_PREFACTOR_MEMO) > _PREFACTOR_CAP:
        _PREFACTOR_MEMO.popitem(last=False)
    return pre


def _mixed_ir_solve(kind: str, a, b, mesh: VirtualMesh, nb: int, max_iter, opts, pre=None):
    """Factor + refinement; (x dense, iters, converged, rnorm, xnorm, info,
    residual bytes per trip, the trajectory under Option.NumMonitor=on or
    None)."""
    p, q = mesh_shape(mesh)
    la = _la(opts)
    bi = resolve_bcast_impl(get_option(opts, Option.BcastImpl))
    ri = resolve_residual_impl(opts)
    mi = _max_iter(opts, max_iter)
    fact, perm, info, ad = pre if pre is not None else _prefactor_cached(kind, a, mesh, nb, opts)
    bd = from_dense(b, mesh, nb)
    split = ozaki_presplit_cached(ad) if ri == "ozaki" else None
    if kind == "posv":
        lo_solve = _posv_lo_solve(fact, la, bi)
    else:
        lo_solve = _gesv_lo_solve(fact, perm, la, bi)
    from ..obs import numerics as _num

    nm = _num.resolve_num_monitor(_num.monitor_from_opts(opts)) == "on"
    x_t, iters, conv, rn, xn, hist = _ir_common(ad, bd, lo_solve, info, mi, la, bi, ri, split,
                                                nm)
    xd = DistMatrix(tiles=x_t, m=bd.m, n=bd.n, nb=nb, mesh=mesh)
    per_iter = float(residual_comm_bytes(ad.tiles.shape[0], bd.tiles.shape[1], ad.nt, nb, p, q,
                                         bi, ri))
    return to_dense(xd), iters, conv, rn, xn, info, per_iter, hist


def _record_ir(kind: str, iters: int, raw_iters: int, rnorm, xnorm, per_iter,
               hist=None) -> None:
    """The ir.* counters and gauges of one refined solve; ``raw_iters`` is
    the trip counter before convergence masking (the loop ran raw + 1
    residual SUMMAs; -1: a failed factor, no trip).  A monitored solve's
    trajectory ``hist`` lands as the ``ir.residual_history`` series."""
    ir_count("ir.solves", kind)
    ir_gauge("ir.iters", max(iters, 0), kind)
    ir_gauge("ir.rnorm", float(rnorm), kind)
    ir_gauge("ir.xnorm", float(xnorm), kind)
    ir_count("ir.iters_total", kind, max(iters, 0))
    ir_count("ir.residual_gemm_bytes", kind, per_iter * (raw_iters + 1))
    if iters >= 0:
        ir_count("ir.converged", kind)
    if hist is not None:
        from ..obs import numerics as _num

        _num.record_ir_history(kind, hist, raw_iters)


def _mixed_driver(kind: str, a, b, mesh, nb, max_iter, opts, pre):
    _require_f64(a, f"{kind}_mixed_mesh")
    x, raw_iters, conv, rn, xn, info, per_iter, hist = _mixed_ir_solve(
        kind, a, b, mesh, nb, max_iter, opts, pre)
    iters = raw_iters if conv else -1
    _record_ir(kind, iters, raw_iters, rn, xn, per_iter, hist)
    dev = x.device
    return (x, torch.tensor(iters, dtype=torch.int32, device=dev),
            torch.as_tensor(info, device=dev).to(torch.int32))


@instrument("posv_mixed_mesh")
def posv_mixed_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, max_iter: Optional[int] = None,
    opts: Optional[Options] = None, pre=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed SPD solve, f32 mesh factor + f64 mesh refinement
    (src/posv_mixed.cc).  Returns (x, iters, info); iters -1 means the
    refinement did not converge (or the factor failed: x is then NaN) and
    the caller should escalate.  ``a`` holds the lower triangle (upper
    ignored).  ``pre`` is the ladder's shared prefactor (internal)."""
    return _mixed_driver("posv", a, b, mesh, nb, max_iter, opts, pre)


@instrument("gesv_mixed_mesh")
def gesv_mixed_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, max_iter: Optional[int] = None,
    opts: Optional[Options] = None, pre=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed general solve, f32 partial-pivot mesh factor + f64 mesh
    refinement (src/gesv_mixed.cc).  Returns (x, iters, info); see
    :func:`posv_mixed_mesh`."""
    return _mixed_driver("gesv", a, b, mesh, nb, max_iter, opts, pre)


# ---------------------------------------------------------------------------
# Distributed GMRES-IR: restarted left-preconditioned GMRES per right-hand
# side, the operator and the preconditioner applied on the mesh
# ---------------------------------------------------------------------------


def _vec_to_tiles(v: torch.Tensor, nb: int, p: int, q: int, mt: int, ntv: int) -> torch.Tensor:
    """Dense (m,) vector -> the cyclic tile stack of an (m, 1) DistMatrix."""
    from ..core.tiling import to_cyclic, to_tiles

    x = torch.zeros((mt * nb, ntv * nb), dtype=v.dtype, device=v.device)
    x[: v.shape[0], 0] = v
    return to_cyclic(to_tiles(x, nb), p, q)


def _tiles_to_vec(t: torch.Tensor, m: int, p: int, q: int) -> torch.Tensor:
    from ..core.tiling import from_cyclic, from_tiles

    return from_tiles(from_cyclic(t, p, q), m, 1)[:, 0]


def _gmres_dist(pm_resid, b: torch.Tensor, restart: int, tol: torch.Tensor,
                max_restarts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-preconditioned restarted GMRES (``slate_tpu``'s ``_gmres_dist``):
    ``pm_resid(v, c) = M^-1 (c - A v)``.  Each cycle's step j = 0 measures
    the restart's true preconditioned residual M^-1 (b - A x), which is the
    stopping test; j >= 1 build the Krylov basis (M^-1 A V[j-1], classical
    Gram-Schmidt).  Once a measurement meets ``tol`` the cycle's other
    steps and its update are skipped.  max_restarts + 1 cycles, so the
    last update gets measured.  Returns (x, rnorm)."""
    n = b.shape[0]
    dtype = b.dtype
    m = restart
    x = torch.zeros_like(b)
    rnorm = torch.tensor(math.inf, dtype=b.real.dtype, device=b.device)
    rows = torch.arange(m + 1, device=b.device)
    tol_f = float(tol)
    for _cycle in range(max_restarts + 1):
        V = torch.zeros((m + 1, n), dtype=dtype, device=b.device)
        H = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
        beta = torch.zeros((), dtype=b.real.dtype, device=b.device)
        for j in range(m + 1):
            if j == 0:
                r0 = pm_resid(x, b)
                b0 = torch.linalg.vector_norm(r0)
                V[0] = r0 / torch.where(b0 == 0, torch.ones_like(b0), b0)
                beta = b0
                if not float(beta) > tol_f:  # the one host read per cycle start
                    break
                continue
            w = -pm_resid(V[j - 1], torch.zeros_like(b))
            h = matmul(V.conj(), w[:, None])[:, 0]
            h = h * (rows <= j - 1).to(dtype)
            wg = w - matmul(h[None, :], V)[0]
            hn = torch.linalg.vector_norm(wg)
            V[j] = wg / torch.where(hn == 0, torch.ones_like(hn), hn)
            H[:, j - 1] = h
            H[j, j - 1] = hn.to(dtype)
        improve = float(beta) > tol_f
        rnorm = beta
        if not improve:
            break
        e1 = torch.zeros(m + 1, dtype=dtype, device=b.device)
        e1[0] = beta.to(dtype)
        y = _lstsq_min_norm(H[None], e1[None])[0]
        x = x + matmul(y[None, :], V[:m])[0]
    return x, rnorm


def _gmres_column(ad: DistMatrix, fact_solve, bcol: torch.Tensor, restart: int,
                  max_restarts: int, la, bi: str, audit_mult):
    """GMRES on one right-hand side column; ``audit_mult`` gives the audit
    multiplicity of each preconditioned-residual call."""
    m = ad.m
    p, q = mesh_shape(ad.mesh)
    mt, ntv = ad.tiles.shape[0], padded_tiles(1, ad.nb, ad.mesh)
    dtype = ad.tiles.dtype

    def wrap(t):
        return DistMatrix(tiles=t, m=m, n=1, nb=ad.nb, mesh=ad.mesh)

    def pm_resid(v, c):
        with audit_scope(audit_mult()):
            xd = wrap(_vec_to_tiles(v, ad.nb, p, q, mt, ntv))
            cd = wrap(_vec_to_tiles(c, ad.nb, p, q, mt, ntv))
            rd = gemm_summa(-1.0, ad, xd, 1.0, cd, method=MethodGemm.GemmC, lookahead=la,
                            bcast_impl=bi)
            out = fact_solve(rd)
        return _tiles_to_vec(out.tiles, m, p, q).to(dtype)

    eps = torch.finfo(dtype).eps
    tol = (eps * math.sqrt(float(m)) * torch.linalg.vector_norm(bcol)).to(dtype)
    x, rnorm = _gmres_dist(pm_resid, bcol, restart, tol, max_restarts)
    return x, rnorm, bool(rnorm <= tol)


def _mixed_gmres_solve(kind: str, a, b, mesh: VirtualMesh, nb: int, opts, restart: int,
                       pre=None):
    """Factor + per-column distributed GMRES.  Returns (x, rnorm,
    converged_all, info)."""
    la = _la(opts)
    bi = resolve_bcast_impl(get_option(opts, Option.BcastImpl))
    max_restarts = _max_iter(opts, None)
    fact, perm, info, ad = pre if pre is not None else _prefactor_cached(kind, a, mesh, nb, opts)
    b = torch.as_tensor(b, device=mesh.device)
    b2 = b if b.dim() == 2 else b[:, None]
    if kind == "posv":
        solve = _posv_lo_solve(fact, la, bi)
    else:
        solve = _gesv_lo_solve(fact, perm, la, bi)

    def fact_solve(rd):  # the f32 sweeps, without the upcast
        return _astype_dist(solve(rd), torch.float32)

    # slate_tpu traces the single preconditioned-residual call site once,
    # at (columns) x (max_restarts + 1) x (restart + 1) trips
    calls = [0]

    def audit_mult():
        calls[0] += 1
        return b2.shape[1] * (max_restarts + 1) * (restart + 1) if calls[0] == 1 else 0

    bad = bool(torch.as_tensor(info) != 0)
    cols, rnorms, convs = [], [], []
    for j in range(b2.shape[1]):
        with _flight.no_flight():
            x, rn, cv = _gmres_column(ad, fact_solve, b2[:, j], restart, max_restarts, la, bi,
                                      audit_mult)
        cols.append(torch.full_like(x, math.nan) if bad else x)
        rnorms.append(rn)
        convs.append(cv and not bad)
    x = torch.stack(cols, dim=1) if b.dim() == 2 else cols[0]
    rnorm = torch.stack(rnorms).max()
    ir_count("ir.gmres_solves", kind)
    return x, rnorm, all(convs), info


@instrument("posv_mixed_gmres_mesh")
def posv_mixed_gmres_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
    restart: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed GMRES-IR SPD solve (src/posv_mixed_gmres.cc at mesh
    scale): f32 mesh Cholesky preconditioning f64 restarted GMRES.  Returns
    (x, rnorm, info); converged when rnorm <= eps sqrt(n) ||b|| per
    column."""
    _require_f64(a, "posv_mixed_gmres_mesh")
    x, rnorm, _conv, info = _mixed_gmres_solve("posv", a, b, mesh, nb, opts, restart)
    return x, rnorm, torch.as_tensor(info, device=x.device).to(torch.int32)


@instrument("gesv_mixed_gmres_mesh")
def gesv_mixed_gmres_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
    restart: int = 30,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed GMRES-IR general solve (src/gesv_mixed_gmres.cc at mesh
    scale): f32 partial-pivot LU preconditioning f64 restarted GMRES.
    Returns (x, rnorm, info)."""
    _require_f64(a, "gesv_mixed_gmres_mesh")
    x, rnorm, _conv, info = _mixed_gmres_solve("gesv", a, b, mesh, nb, opts, restart)
    return x, rnorm, torch.as_tensor(info, device=x.device).to(torch.int32)


# ---------------------------------------------------------------------------
# The default routing behind gesv_mesh / posv_mesh
# ---------------------------------------------------------------------------


def _route_health(kind: str, pre, opts) -> bool:
    """The measured-health entry tier of ``MixedPrecision=auto`` under
    Option.NumMonitor=on: the monitored f32 factor's gauges (already
    recorded by its k-loop) and a distributed Hager-Higham estimate over
    the factored tiles (``dist_aux.gecondest_dist`` / ``pocondest_dist``:
    a handful of single-column mesh trsm pairs) decide, by
    ``obs.numerics.route_entry_tier``, whether the input sits where IR on
    an f32 factor cannot converge; then the solve enters at GMRES-IR."""
    from ..obs import numerics as _num
    from .dist_aux import gecondest_dist, pocondest_dist

    fact, perm, info, ad = pre
    if int(info) != 0:
        return False  # a failed factor: the NaN / fallback path
    la = _la(opts)
    bi = get_option(opts, Option.BcastImpl)
    gauges = _num.last_gauges("potrf" if kind == "posv" else "getrf_pp")
    anorm = norm_dist(Norm.One, ad)
    if kind == "posv":
        rcond = pocondest_dist(fact, anorm, lookahead=la, bcast_impl=bi)
    else:
        rcond = gecondest_dist(fact, perm, anorm, lookahead=la, bcast_impl=bi)
    if _num.route_entry_tier(kind, gauges, float(rcond)):
        _num.record_routed_gmres(kind)
        return True
    return False


def mixed_mesh_route(kind: str, a, b, mesh: VirtualMesh, nb: int, opts, plain_fn):
    """Route an f64 ``gesv_mesh`` / ``posv_mesh`` call through the ladder of
    the resolved Option.MixedPrecision.  Returns (x, info), or None when the
    direct path runs (mode off, a non-f64 A, a B that is not 2-D), decided
    before any work, so ``off`` launches exactly what the direct path does.

    The ladder: one f32 factor (shared by every tier); IR (``ir``,
    ``auto``); on failure GMRES-IR (``gmres``, ``auto``; an escalation from
    a failed IR tier counts ``ir.escalated_gmres``); on failure the full-f64
    direct solve ``plain_fn`` (``ir.fallback``), unless
    Option.UseFallbackSolver is False, which returns the best mixed-tier
    result.  Each decision is one host read between tiers.

    Under Option.NumMonitor=on (auto: on iff observability is on) the f32
    factor runs monitored, and ``auto`` first takes the health tier
    (``_route_health``, the span's ``health`` phase): a pathological input
    (growth above ``numerics.GROWTH_THRESHOLD``, cond(A) above
    ``numerics.CONDEST_THRESHOLD``, or a vanishing Cholesky margin) skips
    IR and enters at GMRES-IR (``num.routed_gmres``: a route, not an
    escalation, so no ``ir.escalated_gmres``)."""
    mode = resolve_mixed(opts)
    if mode == "off" or not _is_f64(a) or getattr(b, "ndim", 0) != 2:
        return None
    from ..obs import numerics as _num

    nm_on = _num.resolve_num_monitor(_num.monitor_from_opts(opts)) == "on"
    if nm_on:
        # pin the resolved mode into the opts every tier reads, so the f32
        # factor's k-loop records the gauges the health tier reads
        opts = dict(opts or {})
        opts[Option.NumMonitor] = "on"
    drv = posv_mixed_mesh if kind == "posv" else gesv_mixed_mesh
    with driver_span(f"{kind}_mixed", mode=mode) as sp:
        # the health tier reads only THIS factor's gauges: a factor path
        # that records none (the ABFT kernels, a memo hit) leaves the
        # condition estimate alone to decide
        if nm_on:
            _num.clear_last("potrf" if kind == "posv" else "getrf_pp")
        pre = _prefactor_cached(kind, a, mesh, nb, opts)
        skip_ir = False
        if nm_on and mode == "auto":
            with sp.phase("health"):
                skip_ir = _route_health(kind, pre, opts)
        if mode in ("ir", "auto") and not skip_ir:
            with sp.phase("ir"):
                x, iters, info = drv(a, b, mesh, nb, opts=opts, pre=pre)
            if int(info) == 0 and int(iters) >= 0:
                return x, info
        if mode in ("gmres", "auto"):
            if mode == "auto" and not skip_ir:
                ir_count("ir.escalated_gmres", kind)
            with sp.phase("gmres"):
                x, _rnorm, conv, info = _mixed_gmres_solve(kind, a, b, mesh, nb, opts,
                                                           restart=30, pre=pre)
            info = torch.as_tensor(info, device=x.device).to(torch.int32)
            if int(info) == 0 and conv:
                return x, info
        if not get_option(opts, Option.UseFallbackSolver, True):
            return x, info
        ir_count("ir.fallback", kind)
        with sp.phase("fallback"):
            return plain_fn()
