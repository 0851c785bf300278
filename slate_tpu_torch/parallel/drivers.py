"""Mesh-level drivers: dense-in / dense-out distributed gemm, Cholesky, LU
solves and least squares.

Counterpart of ``slate_tpu/parallel/drivers.py`` (the reference's
``src/gemm.cc``, ``src/posv.cc``, ``src/gesv.cc``, ``getrf*.cc``,
``geqrf.cc`` and ``gels_qr.cc`` run with a 2D block-cyclic distribution):
``gemm_mesh`` (SUMMA), ``potrf_mesh`` / ``posv_mesh`` (Cholesky),
``getrf_nopiv_mesh`` / ``gesv_nopiv_mesh`` (no pivoting),
``getrf_tntpiv_mesh`` / ``gesv_tntpiv_mesh`` (tournament pivoting, CALU),
``getrf_mesh`` / ``gesv_mesh`` (partial pivoting, the reference's default
``MethodLU::PartialPiv``), ``geqrf_mesh`` / ``gels_mesh`` (CAQR),
``her2k_mesh`` (her2k / syr2k, both triangles), the eigensolver
``heev_mesh`` and the SVD ``svd_mesh`` (src/heev.cc, svd.cc: the two-stage
chains of ``dist_twostage.py`` and ``dist_stedc.py``), the inverses ``getri_mesh``
and ``potri_mesh`` (src/getri.cc, potri.cc: the factor, then the two
sweeps on the identity) and the band multiplies ``gbmm_mesh`` /
``hbmm_mesh`` (band storage on the dense tile stack, projected on (kl,
ku)), the band solves ``pbsv_mesh`` / ``gbsv_mesh`` (the windowed
``pbtrf_band_dist`` / ``gbtrf_band_dist``, then the dense mesh sweeps) and
``tbsm_mesh``, with the ``_la/_bi/_pi/_ui/_nm`` option readers.  Factorization inputs
are padded with an identity diagonal block (``from_dense(...,
diag_pad_one=True)``), so padded runs stay exact.

``Option.FaultTolerance`` (``ft.policy.FtPolicy``; off by default) reroutes
``gemm_mesh``, ``potrf_mesh`` (and so ``posv_mesh``),
``getrf_nopiv_mesh`` (and so ``gesv_nopiv_mesh``) and ``her2k_mesh`` to the
checksum-carrying drivers of ``ft/abft.py``; off runs the plain kernels
untouched.  As in
``slate_tpu``, the pivoted LU and QR drivers have no ABFT form and run
plain under an active policy, and FaultTolerance together with
``Option.Checkpoint`` raises ``ValueError``.

``Option.Checkpoint`` (a snapshot interval; explicit > ``SLATE_TPU_CKPT`` >
off) routes ``potrf_mesh`` / ``posv_mesh``, ``getrf_nopiv_mesh`` /
``gesv_nopiv_mesh``, ``getrf_mesh`` / ``gesv_mesh``, ``geqrf_mesh`` /
``gels_mesh`` and ``heev_mesh``'s stage 1 to the checkpointed loops of
``ft/ckpt.py`` (``potrf_ckpt``, ``getrf_nopiv_ckpt``, ``getrf_pp_ckpt``,
``geqrf_ckpt``, ``he2hb_ckpt``); off, or absent, calls the plain drivers
as before.  The tournament-pivoted LU and the band solves have no
checkpointed form in ``slate_tpu`` and raise ``NotImplementedError``
under it.

An f64 ``posv_mesh`` / ``gesv_mesh`` with a 2-D right-hand side goes
through the ``Option.MixedPrecision`` ladder by default (``auto``: f32 mesh
factor + f64 refinement, GMRES-IR escalation, the full-f64 fallback;
``parallel/dist_refine.py``), as in ``slate_tpu``; ``off``, any other dtype
and a 1-D B run the direct path, which is also the ladder's fallback tier.
Under FaultTolerance the ladder's f32 factor is the ABFT ``potrf_ft``.

The other drivers of ``slate_tpu.parallel.drivers`` come with their
slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..obs.span import instrument
from ..types import Diag, Op, Option, Options, Side, Uplo, get_option
from .dist import DistMatrix, from_dense, to_dense
from .dist_chol import potrf_dist
from .dist_lu import getrf_nopiv_dist, getrf_pp_dist, getrf_tntpiv_dist, permute_rows_dist
from .dist_qr import DistQR, geqrf_dist, unmqr_dist
from .dist_refine import (  # noqa: F401 (the mixed drivers, re-exported as in slate_tpu)
    gesv_mixed_gmres_mesh,
    gesv_mixed_mesh,
    mixed_mesh_route,
    posv_mixed_gmres_mesh,
    posv_mixed_mesh,
)
from .dist_trsm import trsm_dist
from .mesh import VirtualMesh
from .summa import gemm_summa

_DEFAULT_NB = 256


def _la(opts: Optional[Options]):
    """Raw Option.Lookahead (None: ``comm.la_depth`` maps it to 1)."""
    return get_option(opts, Option.Lookahead)


def _bi(opts: Optional[Options]):
    """Raw Option.BcastImpl (None: ``comm.resolve_bcast_impl``'s chain)."""
    return get_option(opts, Option.BcastImpl)


def _pi(opts: Optional[Options]):
    """Raw Option.PanelImpl (None: ``ops.kernels.resolve_panel_impl``'s chain)."""
    return get_option(opts, Option.PanelImpl)


def _ui(opts: Optional[Options]):
    """Raw Option.UpdateImpl (None: ``ops.kernels.resolve_update_impl``'s chain)."""
    return get_option(opts, Option.UpdateImpl)


def _nm(opts: Optional[Options]):
    """Raw Option.NumMonitor (``obs.numerics.resolve_num_monitor`` resolves
    it in the driver: explicit > context > ``SLATE_TPU_NUM`` > auto)."""
    return get_option(opts, Option.NumMonitor)


def _ft_on(opts: Optional[Options]) -> bool:
    """True when Option.FaultTolerance selects an active ABFT policy (also
    validates the value, so a mistyped policy fails loudly instead of
    running unprotected)."""
    from ..ft.policy import FtPolicy, resolve_policy

    return resolve_policy(opts) != FtPolicy.Off


def _ckpt_every(opts: Optional[Options]) -> Optional[int]:
    """Option.Checkpoint's snapshot interval, or None (off): resolved by
    ``ft.ckpt.resolve_checkpoint`` (explicit > ``SLATE_TPU_CKPT`` > off)."""
    from ..ft.ckpt import resolve_checkpoint

    return resolve_checkpoint(get_option(opts, Option.Checkpoint))


def _resilience(opts: Optional[Options]) -> Tuple[bool, Optional[int]]:
    """(FaultTolerance active, Checkpoint interval or None), each resolved
    once.  Arming both raises ``ValueError`` (as ``slate_tpu``: the ABFT
    kernels are not checkpointed, so one of them would be dropped)."""
    ft_on = _ft_on(opts)
    every = _ckpt_every(opts)
    if ft_on and every is not None:
        raise ValueError(
            "Option.FaultTolerance and Option.Checkpoint cannot be combined (the ABFT "
            "kernels are not checkpointed); arm one of them")
    return ft_on, every


def _no_ckpt(every: Optional[int], who: str) -> None:
    """Refuse Option.Checkpoint on a driver whose loop ``slate_tpu`` does
    not checkpoint (rather than run it without snapshots)."""
    if every is not None:
        raise NotImplementedError(
            f"{who}: Option.Checkpoint={every!r} has no checkpointed form of this loop "
            "(ft/ckpt.py checkpoints potrf, getrf_nopiv, getrf_pp, geqrf and he2hb)")


@instrument("gemm_mesh")
def gemm_mesh(
    alpha, a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, beta=0.0, c=None,
    opts: Optional[Options] = None,
) -> torch.Tensor:
    """Distributed C = alpha A B (+ beta C) via SUMMA (src/gemmC.cc).
    ``opts`` carries Option.Lookahead, Option.BcastImpl, Option.UpdateImpl
    and Option.FaultTolerance (any active policy reroutes to the
    checksum-carrying SUMMA of ft/abft.py)."""
    if _ft_on(opts):
        from ..ft.abft import gemm_mesh_ft

        return gemm_mesh_ft(alpha, a, b, mesh, nb, beta, c, opts)
    ad = from_dense(a, mesh, nb)
    bd = from_dense(b, mesh, nb)
    cd = from_dense(c, mesh, nb) if c is not None else None
    return to_dense(gemm_summa(alpha, ad, bd, beta, cd, lookahead=_la(opts),
                               bcast_impl=_bi(opts), update_impl=_ui(opts)))


@instrument("potrf_mesh")
def potrf_mesh(
    a, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[DistMatrix, torch.Tensor]:
    """Distributed lower Cholesky (src/potrf.cc): (L, info); ``a`` is the
    full or lower Hermitian matrix.  Option.FaultTolerance reroutes to the
    checksum-carrying mesh loop (ft/abft.py); Option.Checkpoint to the
    checkpointed loop (``ft.ckpt.potrf_ckpt``)."""
    ft_on, every = _resilience(opts)
    if ft_on:
        from ..ft.abft import potrf_mesh_ft

        return potrf_mesh_ft(a, mesh, nb, opts)
    if every is not None:
        from ..ft.ckpt import potrf_ckpt

        return potrf_ckpt(from_dense(a, mesh, nb, diag_pad_one=True), every=every,
                          bcast_impl=_bi(opts), panel_impl=_pi(opts), num_monitor=_nm(opts))
    return potrf_dist(
        from_dense(a, mesh, nb, diag_pad_one=True), lookahead=_la(opts),
        bcast_impl=_bi(opts), panel_impl=_pi(opts), update_impl=_ui(opts),
        num_monitor=_nm(opts), overwrite_a=True,
    )


def _posv_mesh_plain(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The direct SPD solve at the data's dtype: potrf, then the two
    triangular sweeps.  The whole solve under Option.MixedPrecision=off and
    the fallback tier of the mixed ladder."""
    la, bi = _la(opts), _bi(opts)
    l, info = potrf_mesh(a, mesh, nb, opts)
    bd = from_dense(b, mesh, nb)
    y = trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, lookahead=la, bcast_impl=bi)
    x = trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, lookahead=la, bcast_impl=bi)
    return to_dense(x), info


@instrument("posv_mesh")
def posv_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed SPD solve (src/posv.cc).  Returns (X dense, info).  An
    f64 system with a 2-D B goes through the Option.MixedPrecision ladder
    by default (``dist_refine.mixed_mesh_route``; the f32 factor takes every
    opt a direct call would: Lookahead, BcastImpl, PanelImpl,
    FaultTolerance); ``off``, any other dtype or a 1-D B run the direct
    potrf + two sweeps.  Option.FaultTolerance protects the factorization
    (through ``potrf_mesh``); the sweeps run unprotected."""
    routed = mixed_mesh_route("posv", a, b, mesh, nb, opts,
                              lambda: _posv_mesh_plain(a, b, mesh, nb, opts))
    if routed is not None:
        return routed
    return _posv_mesh_plain(a, b, mesh, nb, opts)


def _solve(lu: DistMatrix, b, mesh: VirtualMesh, nb: int, perm, opts) -> torch.Tensor:
    """Permute B (when pivoted), then the unit-lower and upper sweeps."""
    la, bi = _la(opts), _bi(opts)
    bd = from_dense(b, mesh, nb)
    if perm is not None:
        bd = permute_rows_dist(bd, perm)
    y = trsm_dist(lu, bd, Uplo.Lower, Op.NoTrans, Diag.Unit, lookahead=la, bcast_impl=bi)
    x = trsm_dist(lu, y, Uplo.Upper, Op.NoTrans, lookahead=la, bcast_impl=bi)
    return to_dense(x)


@instrument("getrf_nopiv_mesh")
def getrf_nopiv_mesh(
    a, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[DistMatrix, torch.Tensor]:
    """Distributed LU without pivoting (src/getrf_nopiv.cc): (LU, info).
    Option.FaultTolerance reroutes to the checksum-carrying LU-nopiv mesh
    loop (ft/abft.py); Option.Checkpoint to the checkpointed loop
    (``ft.ckpt.getrf_nopiv_ckpt``)."""
    ft_on, every = _resilience(opts)
    if ft_on:
        from ..ft.abft import getrf_nopiv_mesh_ft

        return getrf_nopiv_mesh_ft(a, mesh, nb, opts)
    if every is not None:
        from ..ft.ckpt import getrf_nopiv_ckpt

        return getrf_nopiv_ckpt(from_dense(a, mesh, nb, diag_pad_one=True), every=every,
                                bcast_impl=_bi(opts), panel_impl=_pi(opts),
                                num_monitor=_nm(opts))
    return getrf_nopiv_dist(
        from_dense(a, mesh, nb, diag_pad_one=True), lookahead=_la(opts),
        bcast_impl=_bi(opts), panel_impl=_pi(opts), update_impl=_ui(opts),
        num_monitor=_nm(opts), overwrite_a=True,
    )


@instrument("gesv_nopiv_mesh")
def gesv_nopiv_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed LU solve without pivoting: factor, then the two
    triangular sweeps.  Returns (X dense, info).  Option.FaultTolerance
    protects the factorization (through ``getrf_nopiv_mesh``); the sweeps
    run unprotected."""
    lu, info = getrf_nopiv_mesh(a, mesh, nb, opts)
    return _solve(lu, b, mesh, nb, None, opts), info


@instrument("getrf_tntpiv_mesh")
def getrf_tntpiv_mesh(
    a, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[DistMatrix, torch.Tensor, torch.Tensor]:
    """Distributed tournament-pivoted LU (src/getrf_tntpiv.cc): P A = L U.
    Returns (LU, perm over the padded row space, info).  No ABFT and no
    checkpointed form, as in ``slate_tpu``: an active FaultTolerance policy
    runs plain, Option.Checkpoint raises."""
    _no_ckpt(_resilience(opts)[1], "getrf_tntpiv_mesh")
    return getrf_tntpiv_dist(
        from_dense(a, mesh, nb, diag_pad_one=True), lookahead=_la(opts),
        bcast_impl=_bi(opts), panel_impl=_pi(opts), num_monitor=_nm(opts),
        overwrite_a=True,
    )


@instrument("gesv_tntpiv_mesh")
def gesv_tntpiv_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed general solve with tournament pivoting (src/gesv.cc
    with MethodLU::CALU): factor, permute B, two sweeps."""
    lu, perm, info = getrf_tntpiv_mesh(a, mesh, nb, opts)
    return _solve(lu, b, mesh, nb, perm, opts), info


@instrument("getrf_mesh")
def getrf_mesh(
    a, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[DistMatrix, torch.Tensor, torch.Tensor]:
    """Distributed partial-pivot LU, the reference's default getrf
    (src/getrf.cc:23-200): (LU, perm over the padded row space, info).  No
    ABFT form, as in ``slate_tpu`` (an active policy runs plain);
    Option.Checkpoint routes to ``ft.ckpt.getrf_pp_ckpt``."""
    _ft_on_, every = _resilience(opts)
    if every is not None:
        from ..ft.ckpt import getrf_pp_ckpt

        return getrf_pp_ckpt(from_dense(a, mesh, nb, diag_pad_one=True), every=every,
                             bcast_impl=_bi(opts), num_monitor=_nm(opts))
    return getrf_pp_dist(
        from_dense(a, mesh, nb, diag_pad_one=True), lookahead=_la(opts),
        bcast_impl=_bi(opts), panel_impl=_pi(opts), num_monitor=_nm(opts),
        overwrite_a=True,
    )


def _gesv_mesh_plain(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The direct general solve at the data's dtype: partial-pivot
    factor, permute B, two sweeps.  The whole solve under
    Option.MixedPrecision=off and the fallback tier of the mixed ladder."""
    lu, perm, info = getrf_mesh(a, mesh, nb, opts)
    return _solve(lu, b, mesh, nb, perm, opts), info


@instrument("gesv_mesh")
def gesv_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed general solve with partial pivoting (src/gesv.cc,
    MethodLU::PartialPiv).  Returns (X dense, info).  An f64 system with a
    2-D B goes through the Option.MixedPrecision ladder by default (f32
    partial-pivot factor + f64 refinement, GMRES-IR, the full-f64
    fallback; ``dist_refine.mixed_mesh_route``); ``off``, any other dtype
    or a 1-D B run the direct path."""
    routed = mixed_mesh_route("gesv", a, b, mesh, nb, opts,
                              lambda: _gesv_mesh_plain(a, b, mesh, nb, opts))
    if routed is not None:
        return routed
    return _gesv_mesh_plain(a, b, mesh, nb, opts)


@instrument("geqrf_mesh")
def geqrf_mesh(
    a, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> DistQR:
    """Distributed CAQR factorization (src/geqrf.cc).  Returns DistQR.
    ``opts`` carries Option.BcastImpl, Option.PanelImpl and
    Option.Checkpoint (``ft.ckpt.geqrf_ckpt``: the multi-array carry
    snapshotted every K panel steps, under the resolved PanelImpl chain
    as in ``slate_tpu``)."""
    _ft_on_, every = _resilience(opts)
    if every is not None:
        from ..ft.ckpt import geqrf_ckpt

        return geqrf_ckpt(from_dense(a, mesh, nb), every=every, bcast_impl=_bi(opts),
                          num_monitor=_nm(opts))
    return geqrf_dist(from_dense(a, mesh, nb), bcast_impl=_bi(opts), panel_impl=_pi(opts),
                      num_monitor=_nm(opts), overwrite_a=True)


@instrument("gels_mesh")
def gels_mesh(
    a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed least squares min ||A X - B|| for m >= n via CAQR
    (src/gels_qr.cc): X = R^-1 (Q^H B)[:n].  Returns (X dense, info), info
    1 + the first zero of diag(R), else 0.  R goes to its square
    distribution through one dense round trip, as in ``slate_tpu``."""
    m, n = a.shape
    bi = _bi(opts)
    f = geqrf_mesh(a, mesh, nb, opts)
    qb = to_dense(unmqr_dist(f, from_dense(b, mesh, nb), Op.ConjTrans, bcast_impl=bi))[:n]
    r = torch.triu(to_dense(f.fact)[:n, :n])
    del f
    rd = from_dense(r, mesh, nb, diag_pad_one=True)
    xd = trsm_dist(rd, from_dense(qb, mesh, nb), Uplo.Upper, Op.NoTrans, bcast_impl=bi)
    zero = torch.diagonal(r) == 0
    info = torch.where(zero.any(), zero.to(torch.int8).argmax() + 1, 0).to(torch.int32)
    return to_dense(xd), info


@instrument("her2k_mesh")
def her2k_mesh(
    alpha, a, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, beta=0.0, c=None, conj: bool = True,
    opts: Optional[Options] = None,
) -> torch.Tensor:
    """Distributed rank-2k update C = alpha A op(B) + op(alpha) B op(A) +
    beta C (conj=True: her2k, src/her2k.cc; conj=False: syr2k), returned
    FULL (both triangles).  Option.FaultTolerance reroutes to the
    checksum-carrying her2k (ft/abft.py)."""
    from .dist_blas3 import her2k_dist

    if _ft_on(opts):
        from ..ft.abft import her2k_mesh_ft

        return her2k_mesh_ft(alpha, a, b, mesh, nb, beta, c, conj, opts)
    ad = from_dense(a, mesh, nb)
    bd = from_dense(b, mesh, nb)
    cd = from_dense(c, mesh, nb) if c is not None else None
    out = her2k_dist(alpha, ad, bd, beta, cd, conj=conj, full=True, lookahead=_la(opts),
                     bcast_impl=_bi(opts))
    n = ad.m
    return to_dense(out)[:n, :n]


def _eye_like(a, mesh: VirtualMesh) -> torch.Tensor:
    a = torch.as_tensor(a)  # no copy: only its size and dtype are read
    return torch.eye(a.shape[0], dtype=a.dtype, device=mesh.device)


@instrument("getri_mesh")
def getri_mesh(a, mesh: VirtualMesh, nb: int = _DEFAULT_NB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed inverse (src/getri.cc): the partial-pivot factor, then
    A X = I solved on the mesh (the pivoted sweeps on the identity: the
    same O(n^3) as the reference's trtri + trmm chain).  Returns (X dense,
    info)."""
    eye = _eye_like(a, mesh)
    lu, perm, info = getrf_mesh(a, mesh, nb)
    pb = permute_rows_dist(from_dense(eye, mesh, nb), perm)
    y = trsm_dist(lu, pb, Uplo.Lower, Op.NoTrans, Diag.Unit)
    x = trsm_dist(lu, y, Uplo.Upper, Op.NoTrans)
    return to_dense(x), info


@instrument("potri_mesh")
def potri_mesh(a, mesh: VirtualMesh, nb: int = _DEFAULT_NB) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed SPD inverse (src/potri.cc): the Cholesky factor, then
    A^-1 = L^-H L^-1 by the two mesh sweeps on the identity.  Returns
    (X dense, info)."""
    eye = _eye_like(a, mesh)
    l, info = potrf_mesh(a, mesh, nb)
    y = trsm_dist(l, from_dense(eye, mesh, nb), Uplo.Lower, Op.NoTrans)
    x = trsm_dist(l, y, Uplo.Lower, Op.ConjTrans)
    return to_dense(x), info


@instrument("gbmm_mesh")
def gbmm_mesh(
    alpha, a, kl: int, ku: int, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, beta=0.0, c=None,
    opts: Optional[Options] = None,
) -> torch.Tensor:
    """Distributed general-band times dense (src/gbmm.cc): the band
    projected on (kl, ku), then ``gemm_mesh``."""
    from ..core.matrix import band_project

    return gemm_mesh(alpha, band_project(torch.as_tensor(a, device=mesh.device), kl, ku), b,
                     mesh, nb, beta, c, opts)


@instrument("hbmm_mesh")
def hbmm_mesh(
    side: Side, alpha, a, kd: int, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, beta=0.0,
    c=None, uplo: Uplo = Uplo.Lower, opts: Optional[Options] = None,
) -> torch.Tensor:
    """Distributed Hermitian-band times dense (src/hbmm.cc): the stored
    band triangle projected on kd, then ``hemm_summa``."""
    from ..core.matrix import band_project
    from .dist_blas3 import hemm_summa

    kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
    ad = from_dense(band_project(torch.as_tensor(a, device=mesh.device), kl, ku), mesh, nb)
    bd = from_dense(b, mesh, nb)
    cd = from_dense(c, mesh, nb) if c is not None else None
    return to_dense(hemm_summa(side, alpha, ad, bd, beta, cd, uplo=uplo, lookahead=_la(opts),
                               bcast_impl=_bi(opts)))


@instrument("heev_mesh")
def heev_mesh(
    a, mesh: VirtualMesh, nb: int = 64, want_vectors: bool = True,
    distributed_solver: bool = True, opts: Optional[Options] = None,
):
    """Distributed Hermitian eigensolver (src/heev.cc with a grid): stage 1
    (``he2hb_dist``, the O(n^3) reduction) and its back-transform on the
    mesh; the band as O(n nb) diagonal storage (``gather_diagband``,
    Hermitian-averaged), the wavefront chase ``hb2st`` on it; the
    tridiagonal divide and conquer with its merge tree sharded
    (``stedc_dist``; ``distributed_solver=False`` takes the replicated
    ``stedc``); the stage-2 back-transform streamed over Z's column shards
    (``chase_apply_dist``).  Returns (w ascending, Z), or w alone.
    ``opts`` carries Option.BcastImpl and Option.Checkpoint, which
    checkpoints stage 1, the O(n^3) reduction (``ft.ckpt.he2hb_ckpt``);
    Option.NumMonitor ``on`` records stage 1's orthogonality gauge
    (``num.he2hb_orth_margin``)."""
    from ..linalg.eig import hb2st, symmetrize_diagband
    from ..linalg.tridiag import stedc, sterf
    from .dist_stedc import stedc_dist
    from .dist_twostage import chase_apply_dist, gather_diagband, he2hb_dist, unmtr_he2hb_dist

    a = torch.as_tensor(a, device=mesh.device)
    n = a.shape[0]
    every = _ckpt_every(opts)
    if every is not None:
        from ..ft.ckpt import he2hb_ckpt

        f = he2hb_ckpt(from_dense(a, mesh, nb), every=every, bcast_impl=_bi(opts),
                       num_monitor=_nm(opts))
    else:
        f = he2hb_dist(from_dense(a, mesh, nb), bcast_impl=_bi(opts), num_monitor=_nm(opts))
    bandd = symmetrize_diagband(gather_diagband(f.band, nb), nb)
    d, e, f2, phases = hb2st(bandd, nb, diag_storage=True)
    if not want_vectors:
        return sterf(d, e)
    if distributed_solver:
        w, ztri = stedc_dist(d, e, mesh, bcast_impl=_bi(opts))
    else:
        w, ztri = stedc(d, e)
    z = ztri.to(a.dtype)
    if a.is_complex():
        z = phases[:, None] * z
    z = chase_apply_dist(f2.vs, f2.taus, z, n, nb, mesh, bcast_impl=_bi(opts))
    zd = unmtr_he2hb_dist(f, from_dense(z, mesh, nb))
    return w, to_dense(zd)


@instrument("svd_mesh")
def svd_mesh(a, mesh: VirtualMesh, nb: int = 64, want_vectors: bool = True):
    """Distributed SVD (src/svd.cc with a grid): ``ge2tb_dist`` and both
    stage-1 back-transforms on the mesh, the band as O(n nb) diagonals, the
    chase ``tb2bd``, the Golub-Kahan solve ``bdsqr``, and both stage-2
    families streamed over the vectors' column shards
    (``chase_apply_dist``).  Returns (U, s, Vh) or s; m < n works on A^H."""
    from ..linalg.svd import bdsqr, tb2bd
    from .dist_twostage import (
        chase_apply_dist,
        gather_diagband,
        ge2tb_dist,
        unmbr_ge2tb_u_dist,
        unmbr_ge2tb_v_dist,
    )

    a = torch.as_tensor(a, device=mesh.device)
    m, n = a.shape
    dtype = a.dtype
    if m < n:
        ah = a.conj().T
        if not want_vectors:
            return svd_mesh(ah, mesh, nb, False)
        u, s, vh = svd_mesh(ah, mesh, nb, True)
        return vh.conj().T.resolve_conj(), s, u.conj().T.resolve_conj()
    f = ge2tb_dist(from_dense(a, mesh, nb))
    bandd = gather_diagband(f.band, nb)[:n]  # (n, 4nb), O(n nb) replicated
    d, e, f2, pu, pv = tb2bd(bandd, nb, diag_storage=True)
    if not want_vectors:
        return bdsqr(d, e, want_vectors=False)
    s, ub, vb = bdsqr(d, e, want_vectors=True)
    u = chase_apply_dist(f2.lvs, f2.ltaus, pu[:, None] * ub.to(dtype), n, nb, mesh)
    u_full = torch.zeros((m, n), dtype=dtype, device=a.device)
    u_full[:n] = u
    ud = unmbr_ge2tb_u_dist(f, from_dense(u_full, mesh, nb))
    v = chase_apply_dist(f2.rvs, f2.rtaus, pv[:, None] * vb.to(dtype), n, nb, mesh)
    vd = unmbr_ge2tb_v_dist(f, from_dense(v, mesh, nb))
    return to_dense(ud), s, to_dense(vd).conj().T.resolve_conj()


@instrument("tbsm_mesh")
def tbsm_mesh(
    a, kd: int, b, mesh: VirtualMesh, nb: int = _DEFAULT_NB, uplo: Uplo = Uplo.Lower,
    diag: Diag = Diag.NonUnit, perm=None,
) -> torch.Tensor:
    """Distributed triangular-band solve, optionally applying LU pivots
    first (src/tbsm.cc, the tbsmPivots path): ``perm`` is a permutation of
    the padded row space (``gbtrf_band_dist``'s), applied to B by
    ``permute_rows_dist``; then ``trsm_dist`` on the band-projected A."""
    from ..core.matrix import band_project

    kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
    ad = from_dense(band_project(torch.as_tensor(a, device=mesh.device), kl, ku), mesh, nb,
                    diag_pad_one=True)
    bd = from_dense(b, mesh, nb)
    if perm is not None:
        bd = permute_rows_dist(bd, perm)
    return to_dense(trsm_dist(ad, bd, uplo, Op.NoTrans, diag))


def _band_opts(opts: Optional[Options], who: str) -> None:
    """The band solves have no checkpointed loop (Option.Checkpoint raises,
    as ``slate_tpu`` has none).  Option.NumMonitor is ignored, as
    ``slate_tpu``'s band drivers ignore it: the band loops carry no gauge,
    so ``on`` solves the same bits as ``off`` and records nothing."""
    _no_ckpt(_resilience(opts)[1], who)


@instrument("pbsv_mesh")
def pbsv_mesh(
    a, b, kd: int, mesh: VirtualMesh, nb: int = _DEFAULT_NB, opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed Hermitian-band solve (src/pbsv.cc, pbtrf.cc): the
    factorization's k-loop touches only the tile window inside the
    bandwidth (``pbtrf_band_dist``: O(n kd^2) work; Cholesky preserves the
    band); a band as wide as the grid degenerates to the dense schedule.
    The two sweeps are the dense ``trsm_dist`` (the banded L's masked
    products are small against the factor for a skinny B).  Returns (X
    dense, info).  ``opts`` carries Option.Lookahead and Option.BcastImpl."""
    from ..core.matrix import band_project
    from .dist_chol import pbtrf_band_dist

    _band_opts(opts, "pbsv_mesh")
    la, bi = _la(opts), _bi(opts)
    ab = band_project(torch.as_tensor(a, device=mesh.device), kd, kd)
    l, info = pbtrf_band_dist(from_dense(ab, mesh, nb, diag_pad_one=True), kd, lookahead=la,
                              bcast_impl=bi, overwrite_a=True)
    del ab
    bd = from_dense(b, mesh, nb)
    y = trsm_dist(l, bd, Uplo.Lower, Op.NoTrans, lookahead=la, bcast_impl=bi)
    x = trsm_dist(l, y, Uplo.Lower, Op.ConjTrans, lookahead=la, bcast_impl=bi)
    return to_dense(x), info


@instrument("gbsv_mesh")
def gbsv_mesh(
    a, b, kl: int, ku: int, mesh: VirtualMesh, nb: int = _DEFAULT_NB,
    opts: Optional[Options] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed general-band solve (src/gbsv.cc, gbtrf.cc): the
    partial-pivot band LU whose panel, swaps, row solve and trailing update
    touch only the band envelope (``gbtrf_band_dist``; U fills in to
    kl + ku under pivoting), O(n (kl + nb)(kl + ku + nb)) work; then B
    permuted and the two dense sweeps.  Returns (X dense, info)."""
    from ..core.matrix import band_project
    from .dist_lu import gbtrf_band_dist

    _band_opts(opts, "gbsv_mesh")
    la, bi = _la(opts), _bi(opts)
    ab = band_project(torch.as_tensor(a, device=mesh.device), kl, ku)
    lu, perm, info = gbtrf_band_dist(from_dense(ab, mesh, nb, diag_pad_one=True), kl, ku,
                                     lookahead=la, bcast_impl=bi, overwrite_a=True)
    del ab
    pb = permute_rows_dist(from_dense(b, mesh, nb), perm)
    y = trsm_dist(lu, pb, Uplo.Lower, Op.NoTrans, Diag.Unit, lookahead=la, bcast_impl=bi)
    x = trsm_dist(lu, y, Uplo.Upper, Op.NoTrans, lookahead=la, bcast_impl=bi)
    return to_dense(x), info
