"""Cholesky family of the port: potrf / potrs / posv / potri and the band
drivers pbtrf / pbtrs / pbsv.

Counterpart of the potrf/potrs/posv/potri and pb* parts of
``slate_tpu/linalg/chol.py``, with the same forms, thresholds and info code:

- f32 (and any non-f64 dtype) with n > ``_POTRF_SCAN_MIN_N`` runs
  :func:`_potrf_scan` — nb = 256 panel steps whose diagonal block is
  factored with its inverse by ``ops.kernels.chol_diag_inv`` (the hand-
  written CUDA kernel on the card);
- f64 / c128 with n >= ``_POTRF_LL_MIN_N`` takes ``slate_tpu``'s
  memory-routed left-looking form (``_potrf_f64_form`` ->
  ``obs.memmodel.potrf_f64_form``): ``ozaki`` runs :func:`_potrf_ll_ozaki`
  (a persistent int8 digit cache of the factored panels, ``ops.ozaki``),
  ``staged`` and ``fused`` both run :func:`potrf_left_looking_staged`, the
  in-place panel loop; its diagonal blocks recurse through
  :func:`_potrf_and_inv` down to 256-wide leaves that call the same kernel.
  On the card the f64 Ozaki gate answers False (``ops.matmul``), so the
  route is the panel loop there;
- everything else runs the recursive :func:`_potrf_lower` with a
  ``torch.linalg`` cholesky leaf;
- a lower band with 4 kd <= n runs the windowed ``linalg.band.pbtrf_band``;
  a wider band runs :func:`potrf_array` on the band-projected operand (so
  an f32 band above n = 16384 reaches the kernel through ``_potrf_scan``).

PyTorch runs eagerly, so where ``slate_tpu`` threads immutable arrays
through ``fori_loop``s, ``dynamic_update_slice``s and ``jnp.block``s, this
module loops in Python and writes into preallocated tensors in place.  At
n = 32768 one f32 copy of the matrix is 4.3 GB, so each avoided copy
matters.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional, Tuple, Union

import torch

from ..obs.span import instrument
from ..blas3.blas3 import _NB, _split, trsm_array
from ..core.matrix import (
    BaseMatrix,
    HermitianBandMatrix,
    HermitianMatrix,
    TriangularBandMatrix,
    TriangularMatrix,
    band_project,
    operand_device,
    symmetrize,
)
from ..ops.kernels import chol_diag_inv, panel_engaged
from ..ops.matmul import matmul, matmul_sub_
from ..types import Diag, Op, Options, Side, Uplo

ArrayLike = Union[torch.Tensor, BaseMatrix]

_POTRF_SCAN_MIN_N = 16384  # above this slate_tpu's recursive trace is too large
_POTRF_LL_MIN_N = 4096  # f64/c128: left-looking from here


def _ht(x: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose (a view; plain transpose for real dtypes)."""
    return x.conj().T if x.is_complex() else x.T


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky with ``lax.linalg.cholesky``'s conventions: the input
    is symmetrized first, and a non-SPD input gives a factor whose lower
    triangle is all NaN and whose upper triangle is zero (lax takes the
    lower triangle of its NaN result; ``torch.linalg.cholesky`` would raise
    instead)."""
    l, info = torch.linalg.cholesky_ex((a + _ht(a)) / 2)
    return torch.where(info == 0, l, torch.full_like(l, float("nan"))).tril_()


def _tri_inv(l: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(l.shape[0], dtype=l.dtype, device=l.device)
    return torch.linalg.solve_triangular(l, eye, upper=False)


def _potrf_lower(a: torch.Tensor) -> torch.Tensor:
    """Recursive lower Cholesky of a full Hermitian matrix; NaN-poisons on
    non-SPD input (potrf_array turns that into an info code)."""
    n = a.shape[0]
    if n <= _NB:
        return _cholesky(a)
    h = _split(n)
    # slate_tpu assembles jnp.block([[l11, 0], [l21, l22]]); here the blocks
    # are written into one preallocated factor
    l = torch.zeros_like(a)
    l[:h, :h] = l11 = _potrf_lower(a[:h, :h])
    # L21 = A21 L11^-H  (solve X L11^H = A21)
    l[h:, :h] = l21 = trsm_array(Side.Right, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, 1.0, l11, a[h:, :h])
    a22 = a[h:, h:].clone()
    matmul_sub_(a22, l21, _ht(l21))  # herk: A22 - L21 L21^H
    l[h:, h:] = _potrf_lower(a22)
    return l


def _diag_factor(dblk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) of one diagonal block: the kernel (or its twin on CPU)
    when Option.PanelImpl engages it, else the torch.linalg pair."""
    if panel_engaged(dblk.dtype):
        return chol_diag_inv(dblk.contiguous())
    ld = _cholesky(dblk)
    return ld, _tri_inv(ld)


def _potrf_scan(a: torch.Tensor, nb: int = 256, nbuckets: int = 4,
                overwrite_a: bool = False) -> torch.Tensor:
    """Panel-stepped lower Cholesky, ``slate_tpu``'s ``_potrf_scan``: the
    k-range is cut into ``nbuckets`` statically shrinking trailing views;
    each step factors its diagonal block with its inverse, solves the panel
    as one gemm against L_kk^-H, and applies the masked full-width trailing
    update.  Input must be full Hermitian.  ``overwrite_a`` lets the
    factorization run in ``a``'s storage when no padding is needed
    (potrf_array passes its own symmetrized copy)."""
    n = a.shape[0]
    nsteps = -(-n // nb)
    np_ = nsteps * nb
    if np_ == n and overwrite_a:
        ap = a
    else:
        ap = torch.zeros((np_, np_), dtype=a.dtype, device=a.device)
        ap[:n, :n] = a
        ap.diagonal()[n:] = 1
    cplx = a.is_complex()

    bounds = [nsteps * g // nbuckets for g in range(nbuckets)] + [nsteps]
    for g in range(nbuckets):
        k0, k1 = bounds[g], bounds[g + 1]
        if k0 == k1:
            continue
        off = k0 * nb
        view = ap[off:, off:]  # a view: updates land in ap directly
        nv = np_ - off
        rows = torch.arange(nv, device=a.device)
        for k in range(k0, k1):
            kk = k * nb - off  # view-local panel head
            col = view[:, kk:kk + nb]
            # panel solve as an explicit-inverse gemm (the diagonal block is
            # factored jointly with its inverse)
            ld, linv = _diag_factor(view[kk:kk + nb, kk:kk + nb])
            linv_h = linv.conj().T if cplx else linv.T
            sol = matmul(col, linv_h).to(view.dtype)
            below = (rows >= kk + nb)[:, None]
            ondiag = ((rows >= kk) & (rows < kk + nb))[:, None]
            dpat = torch.zeros((nv, nb), dtype=view.dtype, device=a.device)
            dpat[kk:kk + nb] = ld.tril()
            newcol = torch.where(below, sol, torch.where(ondiag, dpat, col))
            col.copy_(newcol)
            l21 = newcol * below.to(view.dtype)
            matmul_sub_(view, l21, l21.conj().T if cplx else l21.T)
    return ap[:n, :n]


def _potrf_and_inv(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) of a full Hermitian block, jointly and all-gemm: the
    recursion's l21 = a21 inv11^H and inv21 = -inv22 l21 inv11 are gemms,
    and the 256-wide leaves are the diagonal-block kernel."""
    n = a.shape[0]
    if n <= _NB:
        if panel_engaged(a.dtype):
            return chol_diag_inv(a.contiguous())
        if a.dtype == torch.float64:
            return _potrf_inv_base_f64(a)
        ld = _cholesky(a)
        return ld, _tri_inv(ld)
    h = _split(n)
    # slate_tpu assembles both results with jnp.block; here the blocks are
    # written into two preallocated outputs
    l = torch.zeros_like(a)
    linv = torch.zeros_like(a)
    l11, i11 = _potrf_and_inv(a[:h, :h])
    l[:h, :h], linv[:h, :h] = l11, i11
    l21 = matmul(a[h:, :h], _ht(i11)).to(a.dtype)
    a22 = a[h:, h:].clone()
    matmul_sub_(a22, l21, _ht(l21))
    l22, i22 = _potrf_and_inv(a22)
    l[h:, :h], l[h:, h:], linv[h:, h:] = l21, l22, i22
    linv[h:, :h] = -matmul(i22, matmul(l21, i11).to(a.dtype)).to(a.dtype)
    return l, linv


def _potrf_inv_base_f64(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32-seeded, f64-refined (L, L^-1) of a small f64 block — the leaf
    ``slate_tpu`` runs under PanelImpl=xla, here reached only under xla
    too: the f32 factor and inverse, three coupled refinement sweeps

        E = X (A - L L^T) X^T,  L <- L (I + low(E)),  X <- X (2 I - L X)

    and a residual gate that falls back to the exact f64 pair."""
    n = a.shape[0]
    dt = a.dtype
    l32 = _cholesky(a.to(torch.float32))
    x32 = _tri_inv(l32)
    seed_ok = bool(torch.isfinite(l32).all())
    l = torch.where(torch.isfinite(l32), l32, 0).tril().to(dt)
    x = torch.where(torch.isfinite(x32), x32, 0).tril().to(dt)
    eye = torch.eye(n, dtype=dt, device=a.device)
    half_low = torch.ones((n, n), dtype=dt, device=a.device).tril(-1) + 0.5 * eye
    for _ in range(3):
        r = a - l @ l.T
        e = x @ r @ x.T
        l = l + l @ (e * half_low)
        x = x @ (2.0 * eye - l @ x)
    eps = torch.finfo(dt).eps
    resid = torch.linalg.norm(a - l @ l.T)
    tol = 1e3 * n * eps * torch.linalg.norm(a)
    resid_x = torch.linalg.norm(eye - l @ x)
    tol_x = 1e3 * n * eps * torch.linalg.norm(x) * torch.linalg.norm(l)
    good = (
        seed_ok
        and bool(torch.isfinite(resid)) and bool(resid <= tol)
        and bool(torch.isfinite(resid_x)) and bool(resid_x <= tol_x)
    )
    if good:
        return l.tril(), x.tril()
    le = _cholesky(a)
    return le, _tri_inv(le)


def potrf_left_looking_staged(a: torch.Tensor, nb: Optional[int] = None,
                              donate: bool = False) -> torch.Tensor:
    """Left-looking blocked lower Cholesky: every panel subtracts the
    factored history as one large-k gemm, factors its diagonal block with
    its inverse (:func:`_potrf_and_inv`) and solves the rows below as a gemm.

    ``slate_tpu`` has two forms of this loop, one XLA program ("fused") or
    one donated program per panel ("staged"), and picks by modelled HBM
    peak because XLA keeps several live copies of the matrix across the
    unrolled chain.  Eager PyTorch has no such copies: both forms are the
    same in-place panel loop, which is this function, with its peak one
    matrix plus a panel step's transients
    (``obs.memmodel.potrf_staged_peak``).  ``donate=True`` factors ``a``
    in place (``slate_tpu``'s donation: the caller must not reuse ``a``);
    the default works on a copy."""
    n = a.shape[0]
    if nb is None:
        nb = 4096 if n >= 16384 else 2048
    if n <= nb:
        return _potrf_lower(a)
    nsteps = -(-n // nb)
    ap = _potrf_ll_pad(a, nsteps, nb, donate)
    for j in range(nsteps):
        _potrf_ll_panel_step(ap, j * nb, nb)
    return ap[:n, :n].tril_()  # ap is this function's own: project in place


def _potrf_ll_ozaki(a: torch.Tensor, nb: Optional[int] = None,
                    n_slices: Optional[int] = None, overwrite_a: bool = False) -> torch.Tensor:
    """Left-looking f64 lower Cholesky with a persistent Ozaki digit cache
    (``slate_tpu``'s ``_potrf_ll_ozaki``).  Cholesky bounds every factor row
    a priori, |L[i, j]| <= sqrt(A[i, i]), so each row's digit grid is fixed
    at 2^e[i] > sqrt(A[i, i]) before factoring: every factored panel is
    split ONCE into the (S, n, n) int8 cache (``ops.ozaki.split_rows``) and
    each panel's update is one plane-level product over the whole history
    (``ops.ozaki.matmul_planes``), no per-use splits.  S = 9, or 10 above
    n = 8192, where the bound's slack can exceed one 6-bit plane.  Peak:
    the S n^2 cache beside ~4 f64 matrices
    (``obs.memmodel.potrf_ozaki_cache_peak``); ``potrf_array`` routes here
    only where ``memmodel.potrf_f64_form`` says that fits."""
    from ..ops.ozaki import _row_exp, matmul_planes, split_rows

    n = a.shape[0]
    if n_slices is None:
        n_slices = 10 if n > 8192 else 9
    if nb is None:
        nb = 4096 if n >= 16384 else 2048
    if n <= nb:
        return _potrf_lower(a)
    nsteps = -(-n // nb)
    np_ = nsteps * nb
    ap = _potrf_ll_pad(a, nsteps, nb, overwrite_a)
    root = ap.diagonal().real.clamp(min=0).sqrt().to(torch.float32)
    e = _row_exp(root)[:, None]
    q = torch.zeros((n_slices, np_, np_), dtype=torch.int8, device=ap.device)
    for j in range(nsteps):
        r0 = j * nb
        panel = ap[r0:, r0:r0 + nb]
        if j:
            panel = panel - matmul_planes(q[:, r0:, :r0], e[r0:], q[:, r0:r0 + nb, :r0],
                                          e[r0:r0 + nb])
        dblk, linv = _potrf_and_inv(panel[:nb].contiguous())
        dblk = dblk.tril()
        if panel.shape[0] > nb:
            below = matmul(panel[nb:], linv.T).to(ap.dtype)
            cpanel = torch.cat([dblk, below], dim=0)
        else:
            cpanel = dblk
        if j + 1 < nsteps:  # the last panel is never read back
            q[:, r0:, r0:r0 + nb] = split_rows(cpanel, n_slices, e[r0:])[0]
        ap[r0:, r0:r0 + nb] = cpanel
    return ap[:n, :n].tril_()


def _route_budget(device) -> int:
    """The device-memory budget of the f64 route: ``SLATE_TPU_HBM_BYTES``,
    else the card's memory, else (a CPU operand) the host's memory, passed
    to the model explicitly."""
    from ..obs import memmodel

    try:
        return memmodel.hbm_budget(device)
    except ValueError:
        return int(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def _potrf_f64_form(n: int, ozaki_dispatch: bool, itemsize: int = 8, device=None) -> str:
    """ozaki | staged | fused for one big f64 / c128 factorization, by
    modelled peak against the device's budget (``obs.memmodel.potrf_f64_form``,
    ``slate_tpu``'s rules; every port call is concrete)."""
    from ..obs import memmodel

    return memmodel.potrf_f64_form(n, True, ozaki_dispatch, budget=_route_budget(device),
                                   itemsize=itemsize)


def _potrf_ll_pad(a: torch.Tensor, nsteps: int, nb: int, overwrite_a: bool) -> torch.Tensor:
    """Pad to a panel multiple with a unit diagonal in the pad block (exact:
    diag(A, I) factors to diag(L, I)); without padding, ``a`` itself when
    ``overwrite_a`` else a copy."""
    n = a.shape[0]
    np_ = nsteps * nb
    if np_ == n:
        return a if overwrite_a else a.clone()
    ap = torch.zeros((np_, np_), dtype=a.dtype, device=a.device)
    ap[:n, :n] = a
    ap.diagonal()[n:] = 1
    return ap


def _potrf_ll_panel_step(ap: torch.Tensor, r0: int, nb: int) -> None:
    """One left-looking panel step, in place on the padded matrix."""
    panel = ap[r0:, r0:r0 + nb]
    if r0:
        left = ap[r0:, :r0]  # factored L[r0:, :r0]
        matmul_sub_(panel, left, _ht(left[:nb]))
    dblk, linv = _potrf_and_inv(panel[:nb])
    if panel.shape[0] > nb:
        panel[nb:] = matmul(panel[nb:], _ht(linv)).to(ap.dtype)
    panel[:nb] = dblk


def _info(l: torch.Tensor) -> torch.Tensor:
    """0 on success, else 1 + index of the first non-positive or NaN pivot
    (int32 tensor on l's device)."""
    d = l.diagonal().real
    bad = ~(torch.isfinite(d) & (d > 0))
    first = bad.to(torch.int8).argmax()
    return torch.where(bad.any(), first + 1, 0).to(torch.int32)


@instrument("potrf_array")
def potrf_array(a: torch.Tensor, uplo: Uplo = Uplo.Lower) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factor A = L L^H (or U^H U).  ``a`` holds the uplo triangle (the
    other is ignored).  Returns (factor triangle, info); info = 0 on success
    else 1 + index of the first non-positive pivot."""
    n = a.shape[0]
    full = symmetrize(a, uplo, conj=a.is_complex())  # owned here: factored in place
    if a.dtype in (torch.float64, torch.complex128) and n >= _POTRF_LL_MIN_N:
        from ..ops.matmul import _F64_DISPATCH, _tpu_is_default

        ozaki_ok = a.dtype == torch.float64 and _F64_DISPATCH["ozaki"] and _tpu_is_default()
        form = _potrf_f64_form(n, ozaki_ok, a.element_size(), a.device)
        if form == "ozaki":
            l = _potrf_ll_ozaki(full, overwrite_a=True)
        else:  # staged and fused: the in-place panel loop on the symmetrized copy
            l = potrf_left_looking_staged(full, donate=True)
    elif n > _POTRF_SCAN_MIN_N:
        l = _potrf_scan(full, overwrite_a=True)
    else:
        l = _potrf_lower(full)
    info = _info(l)
    l = l.tril_()  # every form returns storage of its own: project in place
    if uplo == Uplo.Upper:
        return _ht(l), info
    return l, info


def potrf(a: ArrayLike, opts: Optional[Options] = None, device=None):
    """slate::potrf driver.  Computes on ``operand_device(a, device)``: a
    numpy operand goes to the card unless ``device`` says otherwise."""
    uplo = a.uplo if isinstance(a, BaseMatrix) else Uplo.Lower
    ad = a.data if isinstance(a, BaseMatrix) else a
    f, info = potrf_array(torch.as_tensor(ad, device=operand_device(a, device)), uplo)
    return TriangularMatrix(data=f, uplo=uplo), info


def potrs_array(l: torch.Tensor, b: torch.Tensor, uplo: Uplo = Uplo.Lower) -> torch.Tensor:
    """Solve A X = B given the Cholesky factor."""
    if uplo == Uplo.Lower:
        y = trsm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.NonUnit, 1.0, l, b)
        return trsm_array(Side.Left, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, 1.0, l, y)
    y = trsm_array(Side.Left, Uplo.Upper, Op.ConjTrans, Diag.NonUnit, 1.0, l, b)
    return trsm_array(Side.Left, Uplo.Upper, Op.NoTrans, Diag.NonUnit, 1.0, l, y)


def potrs(factor: TriangularMatrix, b: ArrayLike, device=None):
    dev = operand_device(factor, device)
    bd = b.array if isinstance(b, BaseMatrix) else b
    out = potrs_array(torch.as_tensor(factor.data, device=dev), torch.as_tensor(bd, device=dev), factor.uplo)
    if isinstance(b, BaseMatrix):
        return replace(b, data=out)
    return out


@instrument("posv_array")
def posv_array(a: torch.Tensor, b: torch.Tensor, uplo: Uplo = Uplo.Lower):
    """Factor + solve.  Returns (x, factor, info)."""
    f, info = potrf_array(a, uplo)
    x = potrs_array(f, b, uplo)
    return x, f, info


def posv(a: ArrayLike, b: ArrayLike, opts: Optional[Options] = None, device=None):
    """slate::posv driver.  Computes on ``operand_device(a, device)``; ``b``
    follows ``a``."""
    uplo = a.uplo if isinstance(a, BaseMatrix) else Uplo.Lower
    dev = operand_device(a, device)
    ad = torch.as_tensor(a.data if isinstance(a, BaseMatrix) else a, device=dev)
    bd = torch.as_tensor(b.array if isinstance(b, BaseMatrix) else b, device=dev)
    x, f, info = posv_array(ad, bd, uplo)
    if isinstance(b, BaseMatrix):
        x = replace(b, data=x)
    return x, TriangularMatrix(data=f, uplo=uplo), info


def potri_array(l: torch.Tensor, uplo: Uplo = Uplo.Lower) -> torch.Tensor:
    """A^-1 from the Cholesky factor (src/potri.cc): trtri, then the
    triangle product of trtrm; returns the ``uplo`` triangle of A^-1."""
    from .tri import trtri_array, trtrm_array

    return trtrm_array(trtri_array(l, uplo, Diag.NonUnit), uplo)


def potri(factor: TriangularMatrix, device=None) -> HermitianMatrix:
    """slate::potri over the factor's view, on ``operand_device(factor,
    device)``."""
    data = torch.as_tensor(factor.data, device=operand_device(factor, device))
    return HermitianMatrix(data=potri_array(data, factor.uplo), uplo=factor.uplo)


# ---------------------------------------------------------------------------
# band Cholesky (src/pbtrf.cc, pbtrs.cc, pbsv.cc)
# ---------------------------------------------------------------------------


def _band_worthwhile(n: int, band: int) -> bool:
    from .band import band_worthwhile

    return band_worthwhile(n, band)


def pbtrf_array(a: torch.Tensor, kd: int, uplo: Uplo = Uplo.Lower
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band Cholesky (src/pbtrf.cc).  A narrow lower band takes the windowed
    O(n kd^2) path (``linalg.band.pbtrf_band``); a wide band (4 kd > n) or
    an upper one the dense factorization of the band-projected operand,
    projected back (exact either way).  Returns (factor, info)."""
    kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
    if uplo == Uplo.Lower and _band_worthwhile(a.shape[0], kd):
        from .band import pbtrf_band

        f = pbtrf_band(a, kd)
        return f.l, f.info
    f, info = potrf_array(band_project(a, kl, ku), uplo)
    return band_project(f, kl, ku), info


def pbtrs_array(f: torch.Tensor, b: torch.Tensor, kd: int, uplo: Uplo = Uplo.Lower
                ) -> torch.Tensor:
    """Solve from :func:`pbtrf_array`'s factor, by the same routing."""
    if uplo == Uplo.Lower and _band_worthwhile(f.shape[0], kd):
        from .band import BandChol, _pick_nb, pbtrs_band

        fb = BandChol(f, kd, _pick_nb(kd), torch.zeros((), dtype=torch.int32, device=f.device))
        return pbtrs_band(fb, b)
    return potrs_array(f, b, uplo)


def pbsv_array(a: torch.Tensor, b: torch.Tensor, kd: int, uplo: Uplo = Uplo.Lower):
    """Band factor + solve (src/pbsv.cc).  Returns (x, factor, info)."""
    f, info = pbtrf_array(a, kd, uplo)
    return pbtrs_array(f, b, kd, uplo), f, info


def pbsv(a: HermitianBandMatrix, b: ArrayLike, opts: Optional[Options] = None, device=None):
    """slate::pbsv over a Hermitian band view, on ``operand_device(a,
    device)``; returns (x wrapped like ``b``, the TriangularBandMatrix
    factor, info)."""
    dev = operand_device(a, device)
    bd = torch.as_tensor(b.array if isinstance(b, BaseMatrix) else b, device=dev)
    x, f, info = pbsv_array(torch.as_tensor(a.data, device=dev), bd, a.kd, a.uplo)
    if isinstance(b, BaseMatrix):
        x = replace(b, data=x)
    return x, TriangularBandMatrix.from_array(f, a.uplo, a.kd), info
