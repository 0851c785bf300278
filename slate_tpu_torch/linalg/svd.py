"""SVD: two-stage reduction ge2tb -> tb2bd -> bidiagonal solve + lifts.

Counterpart of ``slate_tpu/linalg/svd.py`` (the reference's ``src/ge2tb.cc``,
``src/tb2bd.cc``, LAPACK ``bdsqr``, ``src/unmbr_ge2tb.cc``,
``src/unmbr_tb2bd.cc`` and ``src/svd.cc``), with its names, factor types and
return conventions.

- ``ge2tb``: per block column an offset-pivot QR panel and the compact-WY
  application to the trailing columns, then the LQ panel of the block row
  (the QR of its conjugate transpose) and its application from the right.
  Both panels go through ``linalg.qr._panel_qr_offset_t`` (the
  ``csrc/qr_panel.cu`` kernel on a CUDA tensor under PanelImpl
  ``pallas``/``auto``).  The last LQ steps, where the remaining width is
  <= 1, are the identity in ``slate_tpu`` (it factors a zero panel and
  multiplies its factors by 0); here they are skipped, so ``ge2tb``
  launches nblocks QR panels and one LQ panel per block k with
  (k + 1) nb < n - 1.
- ``tb2bd``: the wavefront chase of ``linalg.eig._wavefront_chase_band``
  with one right and one left Householder a hop; complex bidiagonals are
  phase-normalized to real.
- ``bdsqr``: the Golub-Kahan embedding, a real symmetric tridiagonal with
  zero diagonal and off-diagonals (d0, e0, d1, ...), solved by ``stedc``;
  its positive eigenpairs are (sigma, (v, u) interleaved / sqrt 2).
- ``svd_staged`` is ``slate_tpu``'s phase-per-program form; here it runs
  the same chain as ``svd_array``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.span import instrument
from ..ops.matmul import matmul
from .eig import _apply_panels, _chase_frame, _chase_sweep_apply, _ht, _larfg_masked, _pick
from .eig import _wavefront_chase_segmented
from .tridiag import _STEDC_STAGE_ABOVE, stedc, stedc_staged, sterf

_SVD_NB = 32


class Ge2tbFactors(NamedTuple):
    """Band + stage-1 reflectors in global coordinates: ``vq[k]`` zero
    above row k nb, ``vl[k]`` zero above column (k + 1) nb (column vectors
    of A^H; zero for a dead LQ panel)."""

    band: torch.Tensor  # (m, n) with upper-band content (bandwidth nb above diag)
    vq: torch.Tensor  # (K, mp2, nb) left (U-side) reflectors
    tq: torch.Tensor  # (K, nb, nb)
    vl: torch.Tensor  # (K, np2, nb) right (V-side) reflectors
    tl: torch.Tensor  # (K, nb, nb)
    nb: int


def _lq_active(k: int, nb: int, n: int) -> bool:
    """Whether block row k's LQ panel runs: more than one column is left
    right of the superdiagonal block."""
    return (k + 1) * nb < n - 1


def ge2tb(a: torch.Tensor, nb: int = _SVD_NB, segments: int = 1) -> Ge2tbFactors:
    """General (m >= n) -> upper triangular band by alternating QR/LQ
    panels.  ``segments`` is ``slate_tpu``'s chip escape hatch (its block
    loop in several programs); here the loop is one eager loop either way."""
    from .qr import _panel_qr_offset_t

    m, n = a.shape
    if m < n:
        raise ValueError(f"ge2tb requires m >= n, got {tuple(a.shape)}")
    nblocks = -(-n // nb)
    mp2 = max(m, (nblocks + 1) * nb)
    np2 = max(n, (nblocks + 1) * nb)
    dev, dtype = a.device, a.dtype
    ap = torch.nn.functional.pad(a, (0, np2 - n, 0, mp2 - m))
    rows = torch.arange(mp2, device=dev)
    cols = torch.arange(np2, device=dev)
    vqs = torch.zeros((nblocks, mp2, nb), dtype=dtype, device=dev)
    tqs = torch.zeros((nblocks, nb, nb), dtype=dtype, device=dev)
    vls = torch.zeros((nblocks, np2, nb), dtype=dtype, device=dev)
    tls = torch.zeros((nblocks, nb, nb), dtype=dtype, device=dev)
    for k in range(nblocks):
        j0, j1 = k * nb, k * nb + nb
        # ---- QR panel: eliminate below the diagonal of block column k
        colblk = ap[:, j0:j1]
        below = (rows >= j0)[:, None]
        r_a, vq, _tau, tq = _panel_qr_offset_t(torch.where(below, colblk, 0), j0)
        # Q^H on the trailing columns (vq is zero above row j0)
        trail = ap[j0:, j1:]
        w1 = matmul(_ht(vq[j0:]), trail)
        trail -= matmul(vq[j0:], matmul(_ht(tq), w1)).to(dtype)
        ap[:, j0:j1] = torch.where(below, r_a, colblk)
        vqs[k] = vq
        tqs[k] = tq
        # ---- LQ panel on block row k: QR of the conj-transposed row block
        if not _lq_active(k, nb, n):
            continue
        rowblk = ap[j0:j1, :]
        right = (cols >= j1)[:, None]
        l_a, vl, _taul, tl = _panel_qr_offset_t(torch.where(right, _ht(rowblk), 0), j1)
        # A <- A (I - Vl Tl Vl^H) on rows >= j1 (vl is zero above j1)
        blk = ap[j1:, j1:]
        blk -= matmul(matmul(matmul(blk, vl[j1:]), tl), _ht(vl[j1:])).to(dtype)
        ap[j0:j1, j1:] = _ht(l_a[j1:])
        vls[k] = vl
        tls[k] = tl
    return Ge2tbFactors(ap[:m, :n], vqs, tqs, vls, tls, nb)


def unmbr_ge2tb_u(f: Ge2tbFactors, c: torch.Tensor) -> torch.Tensor:
    """C <- Q C for the stage-1 left factor (unmbr_ge2tb U side)."""
    return _apply_panels(f.vq, f.tq, c, [k * f.nb for k in range(f.vq.shape[0])])


def unmbr_ge2tb_v(f: Ge2tbFactors, c: torch.Tensor) -> torch.Tensor:
    """C <- P C for the stage-1 right factor (the LQ panels, applied as
    left ops on V's columns); dead panels are zero and apply as the
    identity."""
    return _apply_panels(f.vl, f.tl, c, [(k + 1) * f.nb for k in range(f.vl.shape[0])])


# ---------------------------------------------------------------------------
# Stage 2: band -> bidiagonal (src/tb2bd.cc)
# ---------------------------------------------------------------------------


class Tb2bdFactors(NamedTuple):
    """Bulge-chase reflectors: left (U-side) and right (V-side) per
    (sweep, hop)."""

    lvs: torch.Tensor  # (nsweeps, max_hops, w)
    ltaus: torch.Tensor
    rvs: torch.Tensor
    rtaus: torch.Tensor
    w: int
    n: int


def _phase(x: torch.Tensor) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax == 0, torch.ones((), dtype=x.dtype, device=x.device),
                       x / torch.where(ax == 0, 1, ax))


def tb2bd(band: torch.Tensor, w: int = _SVD_NB, segments: int = 1, diag_storage: bool = False):
    """Upper-band (bandwidth w) square matrix (or its diagonal-band
    storage (n, 4w)) -> real upper bidiagonal (d, e) plus reflectors and
    the phases (pu, pv) with B' = Pu^H B Pv.  Per hop: a right Householder
    eliminating a row tail, then a left one eliminating the column bulge
    it made."""
    n = band.shape[0]
    dtype, dev = band.dtype, band.device
    pad = 4 * w
    ba = _chase_frame(band, w, pad, diag_storage)
    nsweeps = max(n - 1, 1)
    max_hops = max(1, -(-(n - 1) // w))
    lvs = torch.zeros((nsweeps, max_hops, w), dtype=dtype, device=dev)
    ltaus = torch.zeros((nsweeps, max_hops), dtype=dtype, device=dev)
    rvs = torch.zeros_like(lvs)
    rtaus = torch.zeros_like(ltaus)

    def one(blocks, idx0, nact):
        # right Householder: W <- W G with (x G)[1:] = 0, x the row idx0
        vr, taur = _larfg_masked(_pick(blocks[:, :, w:2 * w], idx0, 1).conj(), nact)
        colb = blocks[:, :, w:2 * w]
        colb.baddbmm_(torch.bmm(colb, vr[:, :, None]), (taur.conj()[:, None] * vr.conj())[:, None, :],
                      alpha=-1)
        # left Householder: eliminate column c0 below the diagonal
        vl, taul = _larfg_masked(blocks[:, w:2 * w, w], nact)
        mid = blocks[:, w:2 * w, :]
        mid.baddbmm_((taul[:, None] * vl)[:, :, None], torch.bmm(vl.conj()[:, None, :], mid), alpha=-1)
        return blocks, vr, taur, vl, taul

    if n > 1:
        _wavefront_chase_segmented(ba, n, w, nsweeps, max_hops, one, (rvs, rtaus, lvs, ltaus),
                                   segments)
    d = ba[pad:pad + n, 2 * w].clone()
    e = ba[pad:pad + n - 1, 2 * w + 1].clone() if n > 1 else torch.zeros(0, dtype=dtype, device=dev)
    f = Tb2bdFactors(lvs, ltaus, rvs, rtaus, w, n)
    if band.is_complex():
        # phase-normalize to a real nonnegative bidiagonal: a sequential
        # scan pu_i = phase(d_i pv_i), pv_{i+1} = conj(phase(conj(pu_i) e_i))
        pus, pvs = [], []
        pv_i = torch.ones((), dtype=dtype, device=dev)
        for i in range(n):
            pu_i = _phase(d[i] * pv_i)
            pus.append(pu_i)
            pvs.append(pv_i)
            if i < n - 1:
                pv_i = _phase(pu_i.conj() * e[i]).conj()
        pu, pv = torch.stack(pus), torch.stack(pvs)
        d_r = (pu.conj() * d * pv).real
        e_r = (pu[:-1].conj() * e * pv[1:]).real
    else:
        pu = torch.ones(n, dtype=dtype, device=dev)
        pv = torch.ones(n, dtype=dtype, device=dev)
        d_r, e_r = d, e
    return d_r, e_r, f, pu, pv


def unmbr_tb2bd_u(f: Tb2bdFactors, z: torch.Tensor) -> torch.Tensor:
    """Z <- (stage-2 left basis) Z: H_i^H applied reverse-chronologically."""
    return _apply_chase(f, z, left=True)


def unmbr_tb2bd_v(f: Tb2bdFactors, z: torch.Tensor) -> torch.Tensor:
    """Z <- (stage-2 right basis) Z: G_i applied reverse-chronologically."""
    return _apply_chase(f, z, left=False)


def _apply_chase(f: Tb2bdFactors, z: torch.Tensor, left: bool) -> torch.Tensor:
    """The batched sweep application: both sides apply I - conj(tau) v v^H
    in reverse order, the adjoint=False path of ``_chase_sweep_apply``."""
    vs = f.lvs if left else f.rvs
    taus = f.ltaus if left else f.rtaus
    return _chase_sweep_apply(vs, taus, z, f.n, f.w, adjoint=False)


# ---------------------------------------------------------------------------
# Bidiagonal SVD via the Golub-Kahan tridiagonal (bdsqr equivalent)
# ---------------------------------------------------------------------------


def bdsqr(d: torch.Tensor, e: torch.Tensor, want_vectors: bool = True):
    """SVD of the real upper bidiagonal (d, e): (s descending, U, V) or s.
    Values and residuals are machine precision; U / V orthogonality
    degrades as ~eps / sigma for singular values near zero (the +-sigma
    Golub-Kahan pairs nearly collide)."""
    n = d.shape[0]
    rdt, dev = d.dtype, d.device
    if n == 1:
        s = d.abs()
        if not want_vectors:
            return s
        sgn = torch.where(d[0] >= 0, 1.0, -1.0).to(rdt)
        return s, sgn * torch.ones((1, 1), dtype=rdt, device=dev), torch.ones((1, 1), dtype=rdt, device=dev)
    gk_e = torch.zeros(2 * n - 1, dtype=rdt, device=dev)
    gk_e[0::2] = d
    gk_e[1::2] = e
    gk_d = torch.zeros(2 * n, dtype=rdt, device=dev)
    if not want_vectors:
        w = sterf(gk_d, gk_e)
        return torch.flip(torch.clamp(w[n:], min=0.0), (0,))
    w, z = (stedc_staged if 2 * n > _STEDC_STAGE_ABOVE else stedc)(gk_d, gk_e)
    # the positive eigenvalues are the last n; descending for SVD order
    sel = torch.arange(2 * n - 1, n - 1, -1, device=dev)
    s = torch.clamp(w[sel], min=0.0)
    zq = z[:, sel] * torch.sqrt(torch.tensor(2.0, dtype=rdt, device=dev))
    # perfect shuffle: rows 0, 2, 4, ... are V components, 1, 3, 5, ... U
    return s, zq[1::2, :], zq[0::2, :]


# ---------------------------------------------------------------------------
# Driver (src/svd.cc)
# ---------------------------------------------------------------------------


def _svd(a: torch.Tensor, want_vectors: bool, nb: int):
    m, n = a.shape
    dtype = a.dtype
    if m < n:
        # work on A^H and swap the factors
        if not want_vectors:
            return _svd(_ht(a), False, nb)
        u, s, vh = _svd(_ht(a), True, nb)
        return _ht(vh).resolve_conj(), s, _ht(u).resolve_conj()
    f1 = ge2tb(a, nb)
    d, e, f2, pu, pv = tb2bd(f1.band[:n, :n], nb)
    if not want_vectors:
        return bdsqr(d, e, want_vectors=False)
    s, ub, vb = bdsqr(d, e, want_vectors=True)
    # lift U: phases, stage-2 left, embed to m rows, stage-1 Q panels
    u = unmbr_tb2bd_u(f2, pu[:, None] * ub.to(dtype))
    u_full = torch.zeros((m, n), dtype=dtype, device=a.device)
    u_full[:n] = u
    u_full = unmbr_ge2tb_u(f1, u_full)
    # lift V: phases, stage-2 right, stage-1 LQ panels
    v = unmbr_ge2tb_v(f1, unmbr_tb2bd_v(f2, pv[:, None] * vb.to(dtype)))
    return u_full, s, _ht(v).resolve_conj()


def svd_staged(a: torch.Tensor, want_vectors: bool = True, nb: int = _SVD_NB):
    """``slate_tpu``'s phase-per-program SVD: the chain of ``svd_array``."""
    return _svd(a, want_vectors, nb)


@instrument("svd_array")
def svd_array(a: torch.Tensor, want_vectors: bool = True, nb: int = _SVD_NB):
    """Singular value decomposition (slate::svd): s descending, or
    (U_thin, s, Vh_thin)."""
    return _svd(a, want_vectors, nb)
