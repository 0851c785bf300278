"""Two-stage Hermitian eigensolver: he2hb -> hb2st -> tridiag -> back.

Counterpart of ``slate_tpu/linalg/eig.py`` (the reference's ``src/he2hb.cc``,
``src/hb2st.cc``, ``src/unmtr_hb2st.cc``, ``src/unmtr_he2hb.cc``,
``src/heev.cc``, ``src/hegst.cc`` and ``src/hegv.cc``), with its names,
factor types and return conventions.

- Stage 1 (``he2hb``): per block column an offset-pivot panel QR
  (``linalg.qr._panel_qr_offset_t``: ``ops.kernels.qr_panel_offset``, the
  hand-written ``csrc/qr_panel.cu`` on a CUDA tensor under PanelImpl
  ``pallas``/``auto``; the plain pair on a CPU tensor, under ``xla`` and
  for complex), then the two-sided compact-WY update
  B' = B - W~ V^H - V W~^H.  V is zero above the panel's pivot rows, so the
  update and the Hermitian average run on the trailing block only, where
  ``slate_tpu`` computes the full matrix and masks it (outside the
  trailing block both are exact no-ops).
- Stage 2 (``hb2st``): the wavefront bulge chase of
  ``_wavefront_chase_band`` on diagonal-band storage (n + 2 pad, 4w).
  A step's live hops sit 4w - 1 rows apart, so their 3w x 3w windows are
  disjoint, and a window's element (r, c) is frame element
  (row b + r, column c - r + 2w): one ``as_strided`` view with row stride
  4w - 1 IS the shear of ``slate_tpu`` (its pad + flatten + strided
  reshape), with no copy and no arithmetic.  The per-hop Householder
  updates run in place through that view on every live hop of the step
  at once, and they touch only band offsets |c - r| < 2w, inside the
  frame, so nothing outside a window's band is read or written.  That in
  place write is the reference's put loop over slots as one scatter,
  valid because live windows are disjoint; idle wavefront slots are
  dropped on the host, where ``slate_tpu`` parks them on dummy rows and
  drops their factor rows by an out-of-bounds index.
- The back-transforms apply one batched sweep of disjoint w-row slabs at
  a time (``_chase_sweep_apply``) and the stage-1 panels right to left.

The staged / segmented forms (``heev_staged``, ``_wavefront_chase_segmented``,
``_chase_apply_staged``) exist in ``slate_tpu`` to stay under the TPU
runtime's per-program limits; here they keep their names and signatures
and run the fused code path.  The chase and the back-transform loops are
host-bound eager loops (about 30 small ops a wavefront step).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..obs.span import instrument
from ..core.matrix import symmetrize
from ..ops.matmul import _tf32_scope, matmul
from ..types import MethodEig, Precision, Uplo
from .tridiag import stedc, stedc_vals, steqr, sterf

_EIG_NB = 32  # stage-1 band width (reference nb; hb2st window size)


def _ht(x: torch.Tensor) -> torch.Tensor:
    """Conjugate transpose of the last two dims (a view)."""
    return x.conj().transpose(-1, -2) if x.is_complex() else x.transpose(-1, -2)


class He2hbFactors(NamedTuple):
    """Band matrix + stacked compact-WY reflectors: ``v[k]`` holds panel
    k's explicit reflectors in global row coordinates (zeros above the
    panel's pivot rows), padded to a common height."""

    band: torch.Tensor  # (n, n) full Hermitian array with bandwidth-nb content
    v: torch.Tensor  # (K, np2, nb) global-coordinate reflectors
    t: torch.Tensor  # (K, nb, nb) per-panel WY accumulators
    nb: int


def _he2hb_panel_count(n: int, nb: int) -> int:
    k = 0
    while (k + 1) * nb < n - 1:
        k += 1
    return k


def _two_sided_update(ap: torch.Tensor, v: torch.Tensor, t: torch.Tensor) -> None:
    """B -= W~ V^H + V W~^H with W~ = Y T - 1/2 V (T^H V^H Y T), Y = B V, in
    place on the (trailing) block ``ap``, then its Hermitian average."""
    dtype = ap.dtype
    y = matmul(ap, v).to(dtype)
    wmat = matmul(y, t).to(dtype)
    x = matmul(_ht(t), matmul(_ht(v), wmat)).to(dtype)
    wt = wmat - 0.5 * matmul(v, x).to(dtype)
    ap.sub_(matmul(wt, _ht(v)).to(dtype) + matmul(v, _ht(wt)).to(dtype))
    ap.copy_(0.5 * (ap + _ht(ap)))


def he2hb(a: torch.Tensor, nb: int = _EIG_NB) -> He2hbFactors:
    """Full Hermitian -> Hermitian band (bandwidth nb), Q stored per panel.
    Per step: the offset-pivot panel QR of the masked block column, [R; 0]
    and its mirror written into the band, and the two-sided trailing
    update."""
    from .qr import _panel_qr_offset_t

    n = a.shape[0]
    cplx = a.is_complex()
    a = symmetrize(a, Uplo.Lower, conj=cplx)
    nsteps = _he2hb_panel_count(n, nb)
    np2 = max(n, (nsteps + 1) * nb)
    dev, dtype = a.device, a.dtype
    if nsteps == 0:
        return He2hbFactors(a, torch.zeros((0, np2, nb), dtype=dtype, device=dev),
                            torch.zeros((0, nb, nb), dtype=dtype, device=dev), nb)
    ap = torch.nn.functional.pad(a, (0, np2 - n, 0, np2 - n))
    rows = torch.arange(np2, device=dev)
    vs = torch.zeros((nsteps, np2, nb), dtype=dtype, device=dev)
    ts = torch.zeros((nsteps, nb, nb), dtype=dtype, device=dev)
    for k in range(nsteps):
        j0 = k * nb
        c0 = j0 + nb
        colblk = ap[:, j0:c0]
        below = (rows >= c0)[:, None]
        masked = torch.where(below, colblk, 0)
        r_a, v, _tau, t = _panel_qr_offset_t(masked, c0)
        # panel columns <- history above c0, [R; 0] below; mirror row block
        newcols = torch.where(below, r_a, colblk)
        ap[:, j0:c0] = newcols
        ap[j0:c0, c0:] = _ht(newcols[c0:])
        # two-sided trailing update: v is zero above c0
        _two_sided_update(ap[c0:, c0:], v[c0:], t)
        vs[k] = v
        ts[k] = t
    return He2hbFactors(ap[:n, :n], vs, ts, nb)


def _apply_panels(vs: torch.Tensor, ts: torch.Tensor, c: torch.Tensor, row0s, adjoint: bool = False
                  ) -> torch.Tensor:
    """C <- Q C (or Q^H C) for a stack of global-coordinate panels, panel k
    zero above row ``row0s[k]``: right to left for Q, left to right for
    Q^H.  ``c`` is padded to the panels' height and cropped back."""
    nsteps, np2, _ = vs.shape
    n = c.shape[0]
    cp = torch.nn.functional.pad(c, (0, 0) * (c.dim() - 1) + (0, np2 - n))
    for i in range(nsteps):
        k = i if adjoint else nsteps - 1 - i
        r0 = row0s[k]
        v, t = vs[k, r0:], ts[k]
        t = _ht(t) if adjoint else t
        cp[r0:] -= matmul(v, matmul(t, matmul(_ht(v), cp[r0:]))).to(cp.dtype)
    return cp[:n]


def unmtr_he2hb(f: He2hbFactors, c: torch.Tensor) -> torch.Tensor:
    """C <- Q C with Q = Q_0 Q_1 ... (src/unmtr_he2hb.cc), right to left."""
    return _apply_panels(f.v, f.t, c, [(k + 1) * f.nb for k in range(f.v.shape[0])])


# ---------------------------------------------------------------------------
# Stage 2: band -> tridiagonal bulge chasing (src/hb2st.cc)
# ---------------------------------------------------------------------------


def _larfg_masked(x: torch.Tensor, nactive) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder of x (..., w) restricted to its first ``nactive``
    entries (an int, a tensor broadcasting against x's batch dims, or None
    for all w): H = I - tau v v^H with v[0] = 1, H x = beta e1.
    Complex-safe (LAPACK larfg); the identity (tau = 0) when nothing is
    left to eliminate.  beta = -sign(Re alpha) ||x|| with sign +1 for
    Re alpha >= 0 (so -0.0 reads +1)."""
    w = x.shape[-1]
    dev = x.device
    short = None
    if nactive is not None:
        nact = torch.as_tensor(nactive, device=dev)[..., None]
        mask = torch.arange(w, device=dev) < nact
        short = nact[..., 0] <= 1
        x = torch.where(mask, x, 0)
    alpha = x[..., 0]
    x2 = x.abs() ** 2 if x.is_complex() else x * x
    a2 = x2[..., 0]
    tailnorm2 = x2.sum(dim=-1) - a2
    degenerate = tailnorm2 <= 0
    if x.is_complex():
        degenerate = degenerate & (alpha.imag == 0)
    norm = torch.sqrt(a2 + tailnorm2)
    beta = torch.where(alpha.real < 0, norm, -norm)  # real by construction
    betac = beta.to(x.dtype)
    denom = alpha - betac
    denom = torch.where(denom == 0, 1, denom)
    v = x / denom[..., None]
    v[..., 0] = 1
    zero_tau = degenerate | (beta == 0)
    if short is not None:
        v = torch.where(mask, v, 0)
        v = torch.where(short[..., None], (torch.arange(w, device=dev) == 0).to(x.dtype), v)
        zero_tau = zero_tau | short
    tau = torch.where(zero_tau, 0, ((betac - alpha) / betac).conj())
    return v, tau


class Hb2stFactors(NamedTuple):
    """Bulge-chase reflectors: vs[j, t] (length w, v[0] = 1) + taus[j, t]."""

    vs: torch.Tensor  # (n-1, max_hops, w)
    taus: torch.Tensor  # (n-1, max_hops)
    w: int
    n: int


def _dense_to_diagband(a: torch.Tensor, w: int, pad: int) -> torch.Tensor:
    """Dense (n, n) -> diagonal-band storage (n + 2 pad, 4w) with
    ba[i, dd] = A[i - pad, i - pad + dd - 2w] (zero outside the band or the
    matrix): the 4w diagonals j - i in [-2w, 2w) hold the working set of
    both bulge chases."""
    n = a.shape[0]
    D = 4 * w
    i = torch.arange(n, device=a.device)[:, None]
    j = i + torch.arange(D, device=a.device)[None, :] - 2 * w
    ok = (j >= 0) & (j < n)
    vals = torch.where(ok, a[i, j.clamp(0, n - 1)], 0)
    out = torch.zeros((n + 2 * pad, D), dtype=a.dtype, device=a.device)
    out[pad:pad + n] = vals
    return out


def _chase_frame(band: torch.Tensor, w: int, pad: int, diag_storage: bool) -> torch.Tensor:
    """The contiguous (n + 2 pad, 4w) working frame of a bulge chase, from
    a dense (n, n) band matrix or from diagonal storage (n, 4w)."""
    if diag_storage:
        if band.shape[1] != 4 * w:
            raise ValueError(f"diag storage needs (n, {4 * w}), got {tuple(band.shape)}")
        n = band.shape[0]
        out = torch.zeros((n + 2 * pad, 4 * w), dtype=band.dtype, device=band.device)
        out[pad:pad + n] = band
        return out
    return _dense_to_diagband(band, w, pad)


def symmetrize_diagband(bandd: torch.Tensor, w: int) -> torch.Tensor:
    """Hermitian-average a diagonal-band frame (n, 4w): element (i, dd)
    holds A[i, i + o] (o = dd - 2w), its mirror conj(A[i + o, i]) lives at
    (i + o, 2w - o)."""
    n, D = bandd.shape
    assert D == 4 * w, (tuple(bandd.shape), w)
    dev = bandd.device
    o = torch.arange(D, device=dev) - 2 * w
    src_r = torch.arange(n, device=dev)[:, None] + o[None, :]
    src_c = 2 * w - o
    ok = (src_r >= 0) & (src_r < n) & ((src_c >= 0) & (src_c < D))[None, :]
    g = bandd[src_r.clamp(0, n - 1), src_c.clamp(0, D - 1)[None, :]]
    return 0.5 * (bandd + torch.where(ok, g.conj() if bandd.is_complex() else g, bandd))


def _chase_schedule(n: int, w: int, nsweeps: int, max_hops: int, s_lo: int, s_hi: int):
    """The live hops of wavefront steps s_lo..s_hi-1: hop (sweep j, hop t)
    runs at step s = 4j + t, in slot i = s // 4 - j.  A step's live slots
    are one run [i0, i1); returns a (steps, 3) int array of (i0, i1, s)
    with the empty steps dropped."""
    k_slots = max_hops // 4 + 1
    s = np.arange(s_lo, s_hi)[:, None]
    i = np.arange(k_slots)[None, :]
    j = s // 4 - i
    t = s - 4 * j
    r0 = j + 1 + t * w
    valid = (j >= 0) & (j < nsweeps) & (t < max_hops) & (r0 <= n - 1)
    live = valid.any(axis=1)
    i0 = valid.argmax(axis=1)
    i1 = k_slots - valid[:, ::-1].argmax(axis=1)
    return np.stack([i0, i1, s[:, 0]], axis=1)[live]


def _wavefront_chase_band(ba, n, w, nsweeps, max_hops, one, facs, s_lo=None, s_hi=None):
    """Band-storage wavefront chase, in place on the contiguous frame
    ``ba`` (n + 2 pad, 4w), pad = 4w.

    Hop (sweep j, hop t) touches the 3w x 3w diagonal window at
    r0 = j + 1 + t w; two hops conflict iff their r0 differ by < 3w.
    Scheduling (j, t) at step s = 4j + t puts concurrent hops exactly
    4w - 1 >= 3w rows apart and runs every conflicting pair in order, so a
    chase is ~4n steps.  A step's live windows are one strided view of the
    frame (module doc): ``one(blocks, idx0, nact)`` updates them in place
    and returns (blocks, *per-hop factors); idx0 is the in-window
    row/column of the vector being eliminated (w - 1 on a sweep's first
    hop, else 0), nact how many of its w entries lie inside the matrix
    (None: all).  The factors land at their (j, t) rows of ``facs``."""
    D, pad, w3 = 4 * w, 4 * w, 3 * w
    assert ba.is_contiguous() and ba.shape[1] == D
    nsteps = 4 * (nsweeps - 1) + max_hops
    sched = _chase_schedule(n, w, nsweeps, max_hops, s_lo or 0, nsteps if s_hi is None else s_hi)
    # every live hop's factor row (j, t) = (j0 - k, s - 4 (j0 - k)), flat
    # j max_hops + t, in step order: one device tensor sliced per step
    j0s = sched[:, 2] // 4 - sched[:, 0]
    nk = sched[:, 1] - sched[:, 0]
    offs = np.concatenate([[0], np.cumsum(nk)])
    first = j0s * max_hops + sched[:, 2] - 4 * j0s
    rows = np.repeat(first - offs[:-1] * (4 - max_hops), nk) + np.arange(offs[-1]) * (4 - max_hops)
    fidx_all = torch.as_tensor(rows, device=ba.device)
    flat_facs = [f.view(-1, *f.shape[2:]) for f in facs]
    base = ba.storage_offset()
    with _tf32_scope(ba, Precision.Highest):  # the hops' products are bmm
        for (i0, i1, s), j0, o in zip(sched.tolist(), j0s.tolist(), offs.tolist()):
            K = i1 - i0
            r0 = j0 + 1 + (s - 4 * j0) * w
            blocks = ba.as_strided((K, w3, w3), ((4 * w - 1) * D, D - 1, 1),
                                   base + (pad + r0 - w) * D + 2 * w)
            idx0 = [w - 1 if s - 4 * (j0 - k) == 0 else 0 for k in range(K)]
            r_last = r0 + (K - 1) * (4 * w - 1)
            nact = None if n - r_last >= w else [max(0, min(n - r0 - k * (4 * w - 1), w))
                                                  for k in range(K)]
            _, *vals = one(blocks, idx0, nact)
            for f, v in zip(flat_facs, vals):
                f.index_copy_(0, fidx_all[o:o + K], v)
    return (ba, *facs)


def _pick(x: torch.Tensor, idx0, dim: int) -> torch.Tensor:
    """x[k].select(dim - 1, idx0[k]) of a (K, R, C) view for host indices
    ``idx0``: the eliminated column (dim 2) or row (dim 1) of each hop."""
    if all(i == idx0[0] for i in idx0):
        return x.select(dim, idx0[0])
    return torch.stack([x[k].select(dim - 1, i) for k, i in enumerate(idx0)])


# the fused wavefront chase's validated ceiling in slate_tpu (its TPU
# worker faults above it); kept for the staged drivers' segment count
_CHASE_SEGMENT_ABOVE = 8192


def _chase_segments(n: int) -> int:
    """Segment count of the staged drivers: 1 at or below the ceiling,
    else ~one segment per 4096 rows."""
    return 1 if n <= _CHASE_SEGMENT_ABOVE else max(2, n // 4096)


def _wavefront_chase_segmented(ba, n, w, nsweeps, max_hops, one, facs, segments):
    """The chase over ``segments`` step ranges, state carried: the same
    steps in the same order as the fused form."""
    nsteps = 4 * (nsweeps - 1) + max_hops
    if segments <= 1:
        return _wavefront_chase_band(ba, n, w, nsweeps, max_hops, one, facs)
    bounds = [nsteps * i // segments for i in range(segments)] + [nsteps]
    for i in range(segments):
        _wavefront_chase_band(ba, n, w, nsweeps, max_hops, one, facs, bounds[i], bounds[i + 1])
    return (ba, *facs)


def hb2st(band: torch.Tensor, w: int = _EIG_NB, segments: int = 1, diag_storage: bool = False):
    """Hermitian band (bandwidth w; dense, or diagonal-band storage
    (n, 4w) when ``diag_storage``) -> real tridiagonal (d, e) + reflectors.
    Returns (d, e_real, factors, phases); eigenvectors lift as
    z_band = phases * unmtr_hb2st(factors, z_tridiag).  Per hop: one left
    Householder on rows [r0, r0 + w) and its mirrored right application."""
    n = band.shape[0]
    dtype, dev = band.dtype, band.device
    pad = 4 * w
    ba = _chase_frame(band, w, pad, diag_storage)
    max_hops = max(1, -(-(n - 1) // w))
    nsweeps = max(n - 2, 1)
    vs = torch.zeros((max(n - 1, 1), max_hops, w), dtype=dtype, device=dev)
    taus = torch.zeros((max(n - 1, 1), max_hops), dtype=dtype, device=dev)

    def one(blocks, idx0, nact):
        v, tau = _larfg_masked(_pick(blocks[:, w:2 * w, :], idx0, 2), nact)
        # left: H applied to rows [r0, r0 + w) (window rows [w, 2w))
        mid = blocks[:, w:2 * w, :]
        mid.baddbmm_((tau[:, None] * v)[:, :, None], torch.bmm(v.conj()[:, None, :], mid), alpha=-1)
        # right: A H^H on cols [r0, r0 + w) (window cols [w, 2w))
        colb = blocks[:, :, w:2 * w]
        colb.baddbmm_(torch.bmm(colb, v[:, :, None]), (tau.conj()[:, None] * v.conj())[:, None, :],
                      alpha=-1)
        return blocks, v, tau

    if n > 2:
        _wavefront_chase_segmented(ba, n, w, nsweeps, max_hops, one, (vs, taus), segments)
    d = ba[pad:pad + n, 2 * w].real
    e = ba[pad + 1:pad + n, 2 * w - 1]  # A[i, i - 1], i = 1..n-1
    if band.is_complex():
        # phase-rotate to a real tridiagonal: T_real = P^H T P
        ae = e.abs()
        s = torch.where(ae == 0, torch.ones((), dtype=dtype, device=dev),
                        e / torch.where(ae == 0, 1, ae))
        phases = torch.cat([torch.ones(1, dtype=dtype, device=dev), torch.cumprod(s, 0)])
        e_real = ae
    else:
        phases = torch.ones(n, dtype=dtype, device=dev)
        e_real = e.clone()
    return d.clone(), e_real, Hb2stFactors(vs, taus, w, n), phases


def _chase_sweep_apply(vs: torch.Tensor, taus: torch.Tensor, z: torch.Tensor, n: int, w: int,
                       adjoint: bool, j0: int = 0) -> torch.Tensor:
    """Apply a bulge-chase reflector family to Z one batched sweep at a
    time: within sweep j the hops touch disjoint w-row slabs (rows
    j + 1 + t w), so a sweep is one batched rank-1 update of a
    (max_hops, w, nrhs) view.  adjoint=False applies U = H_1^H H_2^H ...
    (reverse order, conj tau), True applies U^H.  ``j0`` offsets the
    family's sweep indices (vs[jj] is global sweep j0 + jj)."""
    nsweeps, max_hops = vs.shape[0], vs.shape[1]
    nrhs = z.shape[1]
    span = max_hops * w
    zp = torch.zeros((n + span, nrhs), dtype=z.dtype, device=z.device)
    zp[:n] = z
    if n <= 1:
        return zp[:n]
    vz = vs.to(z.dtype)
    cz = taus.to(z.dtype)
    cz = cz if adjoint else cz.conj()
    cv = (cz[:, :, None] * vz)[:, :, :, None]  # (nsweeps, max_hops, w, 1)
    vh = vz.conj()[:, :, None, :]  # (nsweeps, max_hops, 1, w)
    with _tf32_scope(zp, Precision.Highest):
        for jj in range(nsweeps):
            jl = jj if adjoint else nsweeps - 1 - jj
            j = j0 + jl
            slab = zp[j + 1:j + 1 + span].view(max_hops, w, nrhs)
            slab.baddbmm_(cv[jl], torch.bmm(vh[jl], slab), alpha=-1)
    return zp[:n]


def unmtr_hb2st(f: Hb2stFactors, z: torch.Tensor) -> torch.Tensor:
    """Z <- Q Z for the stage-2 Q (src/unmtr_hb2st.cc): U = H_1^H H_2^H ...
    applied last to first, one batched sweep at a time."""
    return _chase_sweep_apply(f.vs, f.taus, z, f.n, f.w, adjoint=False)


def _chase_apply_staged(vs, taus, z, n: int, w: int, adjoint: bool) -> torch.Tensor:
    """``slate_tpu``'s sweep-block staged apply (one TPU program per block
    of sweeps): the same sweeps in the same order as
    ``_chase_sweep_apply``."""
    return _chase_sweep_apply(vs, taus, z, n, w, adjoint)


# ---------------------------------------------------------------------------
# Drivers: heev / hegst / hegv (src/heev.cc, hegst.cc, hegv.cc)
# ---------------------------------------------------------------------------


def _heev(a, want_vectors, method, nb, vals):
    n = a.shape[0]
    dtype = a.dtype
    if n == 1:
        w = a[0, 0].real.reshape(1)
        return (w, torch.ones((1, 1), dtype=dtype, device=a.device)) if want_vectors else w
    f1 = he2hb(a, nb)
    d, e, f2, phases = hb2st(f1.band, nb)
    if not want_vectors:
        return vals(d, e)
    if method == MethodEig.DC:
        w, ztri = stedc(d, e)
    else:
        w, ztri = steqr(d, e)
    z = ztri.to(dtype)
    if a.is_complex():
        z = phases[:, None] * z
    z = unmtr_hb2st(f2, z)
    return w, unmtr_he2hb(f1, z)


@instrument("heev_array")
def heev_array(a: torch.Tensor, want_vectors: bool = True, method: MethodEig = MethodEig.DC,
               nb: int = _EIG_NB):
    """Hermitian eigen-decomposition (src/heev.cc): two-stage reduction,
    tridiagonal solve (DC default / QR iteration), two back-transforms.
    Returns w ascending (and Z if want_vectors)."""
    return _heev(a, want_vectors, method, nb, sterf)


def heev_staged(a: torch.Tensor, want_vectors: bool = True, method: MethodEig = MethodEig.DC,
                nb: int = _EIG_NB):
    """``slate_tpu``'s phase-per-program heev: the same chain as
    ``heev_array``, with the values-only solve always the divide and
    conquer (``stedc_vals``) as there."""
    return _heev(a, want_vectors, method, nb, stedc_vals)


def hegst_array(a: torch.Tensor, l: torch.Tensor, itype: int = 1) -> torch.Tensor:
    """Reduce generalized to standard form (src/hegst.cc) given B = L L^H:
    itype 1: C = L^-1 A L^-H; itype 2/3: C = L^H A L."""
    from ..blas3.blas3 import trmm_array, trsm_array
    from ..types import Diag, Op, Side

    a = symmetrize(a, Uplo.Lower, conj=a.is_complex())
    if itype == 1:
        y = trsm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.NonUnit, 1.0, l, a)
        return trsm_array(Side.Right, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, 1.0, l, y)
    y = trmm_array(Side.Left, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, 1.0, l, a)
    return trmm_array(Side.Right, Uplo.Lower, Op.NoTrans, Diag.NonUnit, 1.0, l, y)


def hegv_array(a: torch.Tensor, b: torch.Tensor, itype: int = 1, want_vectors: bool = True,
               method: MethodEig = MethodEig.DC):
    """Generalized Hermitian eig (src/hegv.cc): potrf(B) -> hegst -> heev
    -> back-solve.  Returns (w, X, info), X B-orthonormal."""
    from ..blas3.blas3 import trmm_array, trsm_array
    from ..types import Diag, Op, Side
    from .chol import potrf_array

    l, info = potrf_array(b, Uplo.Lower)
    c = hegst_array(a, l, itype)
    if not want_vectors:
        return heev_array(c, want_vectors=False, method=method), None, info
    w, z = heev_array(c, want_vectors=True, method=method)
    # itype 1 and 2 have y = L^H x, so x = L^-H y; itype 3 has x = L y
    if itype in (1, 2):
        x = trsm_array(Side.Left, Uplo.Lower, Op.ConjTrans, Diag.NonUnit, 1.0, l, z)
    else:
        x = trmm_array(Side.Left, Uplo.Lower, Op.NoTrans, Diag.NonUnit, 1.0, l, z)
    return w, x, info

