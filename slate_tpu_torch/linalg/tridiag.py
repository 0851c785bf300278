"""Symmetric tridiagonal eigensolvers: sterf (values), steqr (QR iteration
with vectors), stedc (divide and conquer).

Counterpart of ``slate_tpu/linalg/tridiag.py`` (the reference's
``src/sterf.cc``, ``src/steqr2.cc`` and ``src/stedc*.cc``), with its names,
constants and arithmetic:

- ``sterf`` / ``steqr`` are the masked fixed-shape implicit-shift QR sweeps
  of ``_steqr_impl``.  ``lax.while_loop`` / ``fori_loop`` become Python
  loops: each sweep reads its active window [lo, hi) once on the host and
  runs the Givens recurrence over it only (the reference's masked steps
  outside the window leave every value as it was).  Every routine takes a
  leading batch dim where ``slate_tpu`` vmaps (the 32-wide base solves of
  stedc), a member that has converged is frozen as a vmapped while_loop
  freezes it, and ``sterf`` routes to ``stedc_vals`` above
  ``_STERF_QR_MAX``.
- ``stedc`` is the level-wise batched merge tree: a pad to
  N = 2^L * ``_DC_SMALL``, one batched steqr over the base blocks, and per
  level one batched secular solve and one batched assembly product.  The
  merges are written with an explicit batch dim (``slate_tpu`` vmaps them);
  above ``_CHUNK_AT`` they run in root-column chunks of ``_CHUNK_COLS``.
- The deflation scan (``_deflate_z``) and its undo (``_undo_deflation_rows``)
  are sequential over the poles in the reference.  A step whose pole pair is
  not close is the identity (c = 1, s = 0, z untouched), so the port reads
  the close pairs on the host once per merge and loops over those alone, in
  the reference's order.
- Sorting is stable everywhere the reference sorts (``jnp.argsort`` is;
  ``torch.argsort`` only with ``stable=True``): the pad eigenvalues and
  deflated poles tie.
- ``stedc_staged`` exists in ``slate_tpu`` to stay under the TPU runtime's
  per-program limit.  Eager PyTorch dispatches every merge level on its
  own already, so it is the same code path as ``stedc``.

Products run through ``ops.matmul.matmul`` at Highest (no TF32 for f32 on
the card), as the reference's einsums run at ``PRECISE``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.matmul import matmul


def _wilkinson_shift(a, b, c):
    """Eigenvalue of [[a, b], [b, c]] closest to c (LAPACK convention)."""
    d = (a - c) / 2
    sgn = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    denom = d + sgn * torch.sqrt(d * d + b * b)
    denom = torch.where(denom == 0, torch.finfo(a.dtype).tiny, denom)
    return c - b * b / denom


def _steqr_impl(d: torch.Tensor, e: torch.Tensor, z: Optional[torch.Tensor], max_sweeps: int):
    """Shared implicit-shift QR iteration on (d, e); rotates z's columns if
    given.  ``d`` (n,) or a batch (B, n), ``e`` (..., n - 1), ``z``
    (..., n, n).  Each outer iteration finds the active unreduced window
    [lo, hi] (the smallest split holding the first unconverged
    off-diagonal) and runs one bulge-chase sweep across it.  Returns
    (d, z, sweeps); z is a (1, 1) zero block when not given."""
    batched = d.dim() == 2
    if not batched:
        d, e = d[None], e[None]
        z = z[None] if z is not None else None
    B, n = d.shape
    dtype, dev = d.dtype, d.device
    fi = torch.finfo(dtype)
    eps, tiny = fi.eps, fi.tiny
    has_z = z is not None
    d = d.clone()
    e = e.clone()
    zz = z.clone() if has_z else torch.zeros((B, 1, 1), dtype=dtype, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    if n == 1:
        return (d, zz, iters) if batched else (d[0], zz[0], iters[0])
    idx = torch.arange(n - 1, device=dev)

    def negligible(d, e):
        # |e_i| <= eps * sqrt(|d_i| |d_i+1|) -> treat as zero (dsteqr test)
        thresh = eps * torch.sqrt(d[:, :-1].abs() * d[:, 1:].abs()) + tiny
        return e.abs() <= thresh

    while True:
        negl = negligible(d, e)
        running = (iters < max_sweeps) & ~negl.all(dim=1)
        lo = torch.argmax((~negl).to(torch.int8), dim=1)  # first non-negligible
        after = negl & (idx[None, :] > lo[:, None])
        hi = torch.where(after.any(dim=1), torch.argmax(after.to(torch.int8), dim=1),
                         torch.full_like(lo, n - 1))
        # one host read a sweep: who runs, and the union of the windows
        run_h, lo_h, hi_h = torch.stack([running.long(), lo, hi]).tolist()
        live = [b for b in range(B) if run_h[b]]
        if not live:
            break
        k_lo = min(lo_h[b] for b in live)
        k_hi = max(hi_h[b] for b in live)
        e = torch.where(running[:, None] & negl, 0.0, e)
        rows = torch.arange(B, device=dev)
        shift = _wilkinson_shift(d[rows, hi - 1], e[rows, hi - 1], d[rows, hi])
        x = d[rows, lo] - shift
        zb = e[rows, lo]
        for k in range(k_lo, k_hi):
            inside = running & (k >= lo) & (k < hi)
            r = torch.hypot(x, zb)
            r = torch.where(r == 0, tiny, r)
            cs = torch.where(inside, x / r, 1.0)
            sn = torch.where(inside, zb / r, 0.0)
            k1, km1, ke1 = min(k + 1, n - 1), max(k - 1, 0), min(k + 1, n - 2)
            dk, dk1, ek = d[:, k], d[:, k1], e[:, k]
            # G^T [[dk, ek], [ek, dk1]] G
            new_dk = cs * cs * dk + 2 * cs * sn * ek + sn * sn * dk1
            new_dk1 = sn * sn * dk - 2 * cs * sn * ek + cs * cs * dk1
            new_ek = cs * sn * (dk1 - dk) + (cs * cs - sn * sn) * ek
            # the previous off-diagonal e[k-1] takes the length r
            ekm1 = torch.where((k > lo) & inside, r, e[:, km1])
            d[:, k] = torch.where(inside, new_dk, dk)
            d[:, k1] = torch.where(inside, new_dk1, dk1)
            e[:, km1] = ekm1
            e[:, k] = torch.where(inside, new_ek, e[:, k])
            # the bulge of the next step: G rotates e[k+1] into position;
            # outside the window the carried bulge passes through untouched
            ek1 = e[:, ke1].clone()
            nxt = inside & (k + 1 < hi)
            e[:, ke1] = torch.where(nxt, cs * ek1, ek1)
            zb = torch.where(inside, torch.where(k + 1 < hi, sn * ek1, 0.0), zb)
            if has_z:
                c0, c1 = zz[:, :, k].clone(), zz[:, :, k1].clone()
                ins = inside[:, None]
                zz[:, :, k] = torch.where(ins, cs[:, None] * c0 + sn[:, None] * c1, c0)
                zz[:, :, k1] = torch.where(ins, -sn[:, None] * c0 + cs[:, None] * c1, c1)
            x = torch.where(inside, e[:, k], x)
        iters = iters + running.to(torch.int32)
    return (d, zz, iters) if batched else (d[0], zz[0], iters[0])


_STERF_QR_MAX = 256  # above this, QR iteration's serial rotations lose


def sterf(d: torch.Tensor, e: torch.Tensor, max_sweeps: Optional[int] = None) -> torch.Tensor:
    """Eigenvalues of the symmetric tridiagonal (d, e), ascending
    (slate::sterf).  Up to ``_STERF_QR_MAX`` the implicit-shift QR
    iteration; above it the values-only divide and conquer
    (``stedc_vals``).  Passing ``max_sweeps`` forces the QR iteration at
    any n (it selects the algorithm, not just the cap)."""
    n = d.shape[0]
    if n > _STERF_QR_MAX and max_sweeps is None:
        return stedc_vals(d, e)
    ms = max_sweeps if max_sweeps is not None else 30 * n
    w, _, _ = _steqr_impl(d, e, None, ms)
    return torch.sort(w, dim=-1).values


def steqr(d: torch.Tensor, e: torch.Tensor, z: Optional[torch.Tensor] = None,
          max_sweeps: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of the tridiagonal (d, e) by implicit QR with
    accumulation into ``z`` (default I): slate::steqr2.  Returns (w
    ascending, z's columns in that order).  ``d`` may carry a batch dim."""
    n = d.shape[-1]
    if z is None:
        z = torch.eye(n, dtype=d.dtype, device=d.device).expand(*d.shape[:-1], n, n)
    ms = max_sweeps if max_sweeps is not None else 30 * n
    w, zz, _ = _steqr_impl(d, e, z, ms)
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.gather(w, -1, order),
            torch.gather(zz, -1, order.unsqueeze(-2).expand(zz.shape)))


# ---------------------------------------------------------------------------
# Divide & conquer (src/stedc.cc + stedc_{deflate,merge,secular,solve}.cc).
# Every merge routine takes (m, nn) batches: m merges of width nn.
# ---------------------------------------------------------------------------


def _suffix_next(vals: torch.Tensor, active: torch.Tensor, fill) -> torch.Tensor:
    """nxt[i] = vals[j] of the nearest active j > i (else ``fill``), along
    the last dim."""
    masked = torch.where(active, vals, fill)
    nxt_incl = torch.flip(torch.cummin(torch.flip(masked, (-1,)), dim=-1).values, (-1,))
    tail = torch.full_like(nxt_incl[..., :1], fill)
    return torch.cat([nxt_incl[..., 1:], tail], dim=-1)


def _prefix_prev(vals: torch.Tensor, active: torch.Tensor, fill) -> torch.Tensor:
    """prv[i] = vals[j] of the nearest active j < i (else ``fill``)."""
    masked = torch.where(active, vals, fill)
    m = torch.cummax(masked, dim=-1).values
    head = torch.full_like(m[..., :1], fill)
    return torch.cat([head, m[..., :-1]], dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b, ...]] along the last dim for (m, nn) ``x`` and (m, ...)
    ``idx``."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


def _root_brackets(dd, zf, rho, active, znorm2, tol):
    """The per-root interval data shared by the monolithic and the sharded
    root finders: (pos, has_nbr, gap, nbr_i) over all nn roots."""
    m, nn = dd.shape
    dtype, dev = dd.dtype, dd.device
    big = torch.tensor(torch.finfo(dtype).max / 4, dtype=dtype, device=dev)
    absrho = rho.abs()
    pos = rho >= 0
    idxs = torch.arange(nn, device=dev).to(dtype).expand(m, nn)
    # interval of root k: (d_k, next active d) for rho > 0, (prev, d_k) for
    # rho < 0; the outermost root capped by the |rho| ||z||^2 bound
    nxt_i = _suffix_next(idxs, active, float(nn - 1)).to(torch.int64)
    has_nxt = _suffix_next(dd, active, big) < big
    outer = (absrho * znorm2 + tol)[:, None]
    gap_p = torch.where(has_nxt, _take(dd, nxt_i) - dd, outer)
    prv_i = _prefix_prev(idxs, active, 0.0).to(torch.int64)
    has_prv = _prefix_prev(dd, active, -big) > -big
    gap_m = torch.where(has_prv, _take(dd, prv_i) - dd, -outer)
    p = pos[:, None]
    return pos, torch.where(p, has_nxt, has_prv), torch.where(p, gap_p, gap_m), torch.where(p, nxt_i, prv_i)


def _solve_roots(dd, zz2, rho, self_i, gap, nbr_i, has_nbr, bisect_iters):
    """Bisection in anchored coordinates plus the laed4 fixed-point polish
    for the roots ``self_i`` (m, K): returns (mu, aidx, lo, hi)."""
    dtype = dd.dtype
    tiny = torch.finfo(dtype).tiny
    pos = (rho >= 0)[:, None]
    rho_ = rho[:, None]

    def f_at(anchor_idx, mu):
        dan = dd[:, None, :] - _take(dd, anchor_idx)[:, :, None]  # d_j - anchor_k
        den = dan - mu[:, :, None]
        den = torch.where(den == 0, tiny, den)
        return 1.0 + rho_ * (zz2[:, None, :] / den).sum(dim=-1)

    # nearest-pole anchoring (laed4): the root's half-interval by the
    # secular sign at the midpoint, mu anchored at the closer pole
    fmid = f_at(self_i, gap * 0.5)
    far = fmid < 0
    use_nbr = far & has_nbr
    aidx = torch.where(use_nbr, nbr_i, self_i)
    half = gap * 0.5
    zero = torch.zeros_like(gap)
    lo0_p = torch.where(use_nbr, half - gap, zero)
    hi0_p = torch.where(use_nbr, zero, torch.where(has_nbr, half, gap))
    lo0_m = torch.where(use_nbr, zero, torch.where(has_nbr, half, gap))
    hi0_m = torch.where(use_nbr, half - gap, zero)
    lo0_m, hi0_m = torch.minimum(lo0_m, hi0_m), torch.maximum(lo0_m, hi0_m)
    lo = torch.where(pos, lo0_p, lo0_m)
    hi = torch.where(pos, hi0_p, hi0_m)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        fm = f_at(aidx, mid)
        go_right = torch.where(pos, fm < 0, fm > 0)
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    mu = 0.5 * (lo + hi)

    # fixed-point polish: mu = rho z_a^2 / (1 + rho sum_{j != a} z_j^2 /
    # (Dan_kj - mu)); candidates outside the bisection bracket are rejected
    nn = dd.shape[1]
    dan_full = dd[:, None, :] - _take(dd, aidx)[:, :, None]
    not_anchor = torch.arange(nn, device=dd.device)[None, None, :] != aidx[:, :, None]
    zz2_anch = _take(zz2, aidx)
    for _ in range(25):
        den = dan_full - mu[:, :, None]
        den = torch.where(den == 0, tiny, den)
        other = torch.where(not_anchor, zz2[:, None, :] / den, 0.0).sum(dim=-1)
        g = rho_ * zz2_anch / (1.0 + rho_ * other)
        ok = torch.isfinite(g) & (g > lo) & (g < hi)
        mu = torch.where(ok, g, mu)
    return mu, aidx


def _secular_merge(d: torch.Tensor, z: torch.Tensor, rho: torch.Tensor, bisect_iters: int = 70):
    """Eigen-decomposition of diag(d) + rho z z^T for each of m merges
    ((m, n) d ascending, (m, n) z, (m,) rho): every root bisected in its own
    gap variable mu_k = lambda_k - d_k (LAPACK laed4 anchoring), z
    recomputed from the converged roots by the Gu-Eisenstat formula, and
    the deflation of ``_deflate_z`` (negligible rho z_k^2; near-equal poles
    merged by a Givens rotation undone on V's rows).  Returns (lam, V)."""
    m, n = d.shape
    dtype, dev = d.dtype, d.device
    fi = torch.finfo(dtype)
    eps, tiny = fi.eps, fi.tiny
    absrho = rho.abs()
    znorm2 = (z * z).sum(dim=1)
    tol = 8.0 * eps * (absrho * znorm2 + d.abs().amax(dim=1) + tiny)
    z, cs_arr, sn_arr, active = _deflate_z(d, z, rho)
    zz2 = torch.where(active, z * z, 0.0)
    pos, has_nbr, gap, nbr_i = _root_brackets(d, z, rho, active, znorm2, tol)
    self_i = torch.arange(n, device=dev).expand(m, n)
    mu, aidx = _solve_roots(d, zz2, rho, self_i, gap, nbr_i, has_nbr, bisect_iters)
    mu = torch.where(active, mu, 0.0)
    aidx = torch.where(active, aidx, self_i)
    anch = _take(d, aidx)
    lam = anch + mu

    # Gu-Eisenstat z-hat: |zhat_k|^2 = prod_{j act} (lam_j - d_k) /
    # (|rho| prod_{j != k act} (d_j - d_k)), lam_j - d_k anchored
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    D = d[:, None, :] - d[:, :, None]  # (k, j): d_j - d_k
    act_j = active[:, None, :] & ~eye
    Dsafe = torch.where(D == 0, 1.0, D)
    lamd = (anch[:, None, :] - d[:, :, None]) + mu[:, None, :]  # (k, j): lam_j - d_k
    ratio = torch.where(act_j, lamd / Dsafe, 1.0)
    prod = ratio.abs().prod(dim=2)
    lamk_dk = torch.diagonal(lamd, dim1=1, dim2=2)
    zhat = torch.sign(z) * torch.sqrt(prod * lamk_dk.abs() / torch.clamp(absrho, min=tiny)[:, None])
    zhat = torch.where(active, zhat, 0.0)

    # eigenvectors: v[i, k] = zhat_i / (d_i - lam_k), anchored form
    den = (d[:, :, None] - anch[:, None, :]) - mu[:, None, :]
    den = torch.where(den == 0, tiny, den)
    v = zhat[:, :, None] / den
    v = torch.where(active[:, None, :], v, 0.0)
    nrm = torch.sqrt((v * v).sum(dim=1))
    v = v / torch.where(nrm == 0, 1.0, nrm)[:, None, :]
    v = v + torch.where(active, 0.0, 1.0)[:, None, :] * eye.to(dtype)
    return lam, _undo_deflation_rows(v, cs_arr, sn_arr)


def _secular_roots_shard(dd, zf, rho, active, kidx, bisect_iters: int = 70):
    """Converged roots for the root indices ``kidx`` (K,) of
    diag(dd) + rho z z^T ((m, nn) dd ascending, zf the deflation-rotated
    z): the sharded restriction of ``_secular_merge``'s root finder, every
    (nn x nn) tensor (K x nn).  Returns (mu, aidx), each (m, K)."""
    m, nn = dd.shape
    dtype = dd.dtype
    fi = torch.finfo(dtype)
    zz2 = torch.where(active, zf * zf, 0.0)
    znorm2 = (zf * zf).sum(dim=1)
    tol = 8.0 * fi.eps * (rho.abs() * znorm2 + dd.abs().amax(dim=1) + fi.tiny)
    pos, has_nbr, gap_full, nbr_full = _root_brackets(dd, zf, rho, active, znorm2, tol)
    gap = gap_full[:, kidx]
    nbr_i = nbr_full[:, kidx]
    has_nbr_k = has_nbr[:, kidx]
    self_i = kidx.expand(m, kidx.shape[0])
    mu, aidx = _solve_roots(dd, zz2, rho, self_i, gap, nbr_i, has_nbr_k, bisect_iters)
    act_k = active[:, kidx]
    return torch.where(act_k, mu, 0.0), torch.where(act_k, aidx, self_i)


def _zhat_shard(dd, zf, rho, active, lam_anch_d, mu_all, kidx):
    """|zhat| for the pole indices ``kidx`` (Gu-Eisenstat), from the
    replicated converged roots; lam_anch_d[j] = dd[aidx_j].  (m, K)."""
    m, nn = dd.shape
    dtype, dev = dd.dtype, dd.device
    tiny = torch.finfo(dtype).tiny
    dk = dd[:, kidx]  # (m, K)
    D = dd[:, None, :] - dk[:, :, None]  # d_j - d_k
    Dsafe = torch.where(D == 0, 1.0, D)
    lamd = (lam_anch_d[:, None, :] - dk[:, :, None]) + mu_all[:, None, :]  # lam_j - d_k
    offk = torch.arange(nn, device=dev)[None, :] != kidx[:, None]
    act_j = active[:, None, :] & offk[None]
    ratio = torch.where(act_j, lamd / Dsafe, 1.0)
    prod = ratio.abs().prod(dim=2)
    lamk_dk = lamd[:, torch.arange(kidx.shape[0], device=dev), kidx]
    zhat = torch.sign(zf[:, kidx]) * torch.sqrt(
        prod * lamk_dk.abs() / torch.clamp(rho.abs(), min=tiny)[:, None])
    return torch.where(active[:, kidx], zhat, 0.0)


def _deflate_z(d: torch.Tensor, z: torch.Tensor, rho: torch.Tensor):
    """Deflation pre-pass shared by every merge: Givens-rotate near-equal
    poles (zeroing the second z entry), scanning the poles downward, and
    mask negligible z components (dlaed2's linear criterion).  (m, nn)
    batches.  Returns (z_rotated, cs, sn, active)."""
    m, n = d.shape
    dtype = d.dtype
    fi = torch.finfo(dtype)
    absrho = rho.abs()
    tol = 8.0 * fi.eps * (absrho * (z * z).sum(dim=1) + d.abs().amax(dim=1) + fi.tiny)
    close = (d[:, 1:] - d[:, :-1]).abs() <= tol[:, None]
    z = z.clone()
    cs_a = torch.ones((m, max(n - 1, 0)), dtype=dtype, device=d.device)
    sn_a = torch.zeros_like(cs_a)
    # a step whose pair is not close leaves everything as it was: visit the
    # close pairs alone, in the reference's descending order
    for i in reversed(torch.nonzero(close.any(dim=0)).flatten().tolist()):
        zi, zi1 = z[:, i].clone(), z[:, i + 1].clone()
        both = (zi1.abs() > 0) & close[:, i]
        r = torch.hypot(zi, zi1)
        rs = torch.where(r == 0, 1.0, r)
        cs_a[:, i] = torch.where(both, zi / rs, 1.0)
        sn_a[:, i] = torch.where(both, zi1 / rs, 0.0)
        z[:, i] = torch.where(both, r, zi)
        z[:, i + 1] = torch.where(both, 0.0, zi1)
    active = absrho[:, None] * z.abs() > tol[:, None]
    return z, cs_a, sn_a, active


def _undo_deflation_rows(v: torch.Tensor, cs_arr: torch.Tensor, sn_arr: torch.Tensor) -> torch.Tensor:
    """Undo the deflation rotations on V's rows, ascending (the reverse of
    the descending scan): V <- R_i^T V on rows (i, i + 1).  ``v`` (m, nn,
    K).  The identity rotations (c = 1, s = 0) are skipped: they leave
    every row as it was."""
    if v.shape[1] <= 1:
        return v
    moved = torch.nonzero(((cs_arr != 1) | (sn_arr != 0)).any(dim=0)).flatten().tolist()
    if not moved:
        return v
    v = v.clone()
    for i in moved:
        c, s = cs_arr[:, i, None], sn_arr[:, i, None]
        r0, r1 = v[:, i].clone(), v[:, i + 1].clone()
        v[:, i] = c * r0 - s * r1
        v[:, i + 1] = s * r0 + c * r1
    return v


# Above this merge width the merge runs in root-column chunks: the
# monolithic form keeps several (2s)^2 tensors live at once.
_CHUNK_AT = 16384
_CHUNK_COLS = 2048


def _merge_chunk_prep(dd_s, z_s, rho):
    """Shared chunked-merge prelude: deflation, chunked secular roots and
    chunked zhat, with (m, 2s/chunks, 2s) peak tensors.  Returns (zf, cs_a,
    sn_a, active, lam, lam_anch_d, mu_all, zhat, nch, cols)."""
    nn = dd_s.shape[1]
    dev = dd_s.device
    zf, cs_a, sn_a, active = _deflate_z(dd_s, z_s, rho)
    nch = max(1, nn // _CHUNK_COLS)
    cols = nn // nch
    mus, aidxs = [], []
    for ci in range(nch):
        kidx = ci * cols + torch.arange(cols, device=dev)
        mu_c, aidx_c = _secular_roots_shard(dd_s, zf, rho, active, kidx)
        mus.append(mu_c)
        aidxs.append(aidx_c)
    mu_all = torch.cat(mus, dim=1)
    aidx_all = torch.cat(aidxs, dim=1)
    lam_anch_d = torch.gather(dd_s, 1, aidx_all)
    lam = lam_anch_d + mu_all
    zhs = []
    for ci in range(nch):
        kidx = ci * cols + torch.arange(cols, device=dev)
        zhs.append(_zhat_shard(dd_s, zf, rho, active, lam_anch_d, mu_all, kidx))
    zhat = torch.cat(zhs, dim=1)
    return zf, cs_a, sn_a, active, lam, lam_anch_d, mu_all, zhat, nch, cols


def _merge_chunk_v(dd_s, lam_anch_d, mu_all, zhat, active, cs_a, sn_a, inv, kidx):
    """Eigenvector slab (m, 2s, K) for the root columns ``kidx``, in child
    row order."""
    dtype = dd_s.dtype
    nn = dd_s.shape[1]
    tiny = torch.finfo(dtype).tiny
    den = (dd_s[:, :, None] - lam_anch_d[:, None, kidx]) - mu_all[:, None, kidx]
    den = torch.where(den == 0, tiny, den)
    v = zhat[:, :, None] / den
    act_k = active[:, kidx]
    v = torch.where(act_k[:, None, :], v, 0.0)
    nrm = torch.sqrt((v * v).sum(dim=1))
    v = v / torch.where(nrm == 0, 1.0, nrm)[:, None, :]
    ek = (torch.arange(nn, device=dd_s.device)[None, :, None] == kidx[None, None, :]).to(dtype)
    v = v + torch.where(act_k[:, None, :], 0.0, 1.0) * ek
    v = _undo_deflation_rows(v, cs_a, sn_a)
    return torch.gather(v, 1, inv[:, :, None].expand(v.shape))  # child row order


def _merge_chunked(dd_s, z_s, rho, s, q_pair, inv):
    """One merge level in root-column chunks with bounded peak memory:
    (m, 2s) sorted poles, q_pair (m, 2, s_rows, s), inv (m, 2s).  Returns
    (lam, q_new (m, 2 s_rows, 2s))."""
    m, nn = dd_s.shape
    dev = dd_s.device
    zf, cs_a, sn_a, active, lam, lam_anch_d, mu_all, zhat, nch, cols = _merge_chunk_prep(dd_s, z_s, rho)
    srows = q_pair.shape[2]
    q_new = torch.zeros((m, 2 * srows, nn), dtype=dd_s.dtype, device=dev)
    for ci in range(nch):
        kidx = ci * cols + torch.arange(cols, device=dev)
        v = _merge_chunk_v(dd_s, lam_anch_d, mu_all, zhat, active, cs_a, sn_a, inv, kidx)
        q_new[:, :srows, ci * cols:(ci + 1) * cols] = matmul(q_pair[:, 0], v[:, :s, :])
        q_new[:, srows:, ci * cols:(ci + 1) * cols] = matmul(q_pair[:, 1], v[:, s:, :])
    return lam, q_new


def _merge_chunked_vals(dd_s, z_s, rho, s, top, bot, inv):
    """Values-only wide merge: the same prelude and slabs as
    ``_merge_chunked``, each chunk reduced straight to its boundary-row
    contributions.  ``top`` / ``bot`` are the child boundary rows (2m, s)."""
    dev = dd_s.device
    zf, cs_a, sn_a, active, lam, lam_anch_d, mu_all, zhat, nch, cols = _merge_chunk_prep(dd_s, z_s, rho)
    tops, bots = [], []
    for ci in range(nch):
        kidx = ci * cols + torch.arange(cols, device=dev)
        v = _merge_chunk_v(dd_s, lam_anch_d, mu_all, zhat, active, cs_a, sn_a, inv, kidx)
        tops.append(matmul(top[0::2][:, None, :], v[:, :s, :])[:, 0])
        bots.append(matmul(bot[1::2][:, None, :], v[:, s:, :])[:, 0])
    return lam, torch.cat(tops, dim=1), torch.cat(bots, dim=1)


_DC_SMALL = 32  # base-case size (reference stedc small-problem cutoff)


def stedc(d: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Divide & conquer tridiagonal eigensolver (src/stedc.cc chain):
    (w ascending, Z).  The input is padded to N = 2^L * ``_DC_SMALL`` with a
    decoupled block of pad eigenvalues (4 ||T|| on the diagonal, no
    coupling: exact, and they sort after every real eigenvalue), the base
    blocks are one batched steqr, and every merge level is one batched
    secular solve and one batched assembly product."""
    w, q, _, _ = _stedc_levels(d, e, want_q=True)
    return w, q


def stedc_vals(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Values-only divide and conquer: the merge tree of ``stedc`` with
    each subproblem carrying only (w, Q[0, :], Q[-1, :]), the boundary rows
    a parent merge consumes."""
    w, _, _, _ = _stedc_levels(d, e, want_q=False)
    return w


def _levels(n: int) -> Tuple[int, int]:
    levels = max(1, -(-n // _DC_SMALL) - 1).bit_length()
    return levels, (1 << levels) * _DC_SMALL


def _stedc_levels(d, e, want_q: bool):
    n = d.shape[0]
    if n <= _DC_SMALL:
        w, q = steqr(d, e)
        return w, q, q[0, :], q[-1, :]
    _, N = _levels(n)
    w, q, ep = _stedc_base(d, e, N)

    if want_q:
        s = _DC_SMALL
        while s < N:
            w, q = _merge_level_q(w, q, ep, s, N)
            s *= 2
        wv = w.reshape(N)
        order = torch.argsort(wv, stable=True)
        return wv[order][:n], q[0][:, order[:n]][:n, :], None, None

    # boundary-row path: each subproblem carries only (w, top, bot)
    top = q[:, 0, :]
    bot = q[:, -1, :]
    s = _DC_SMALL
    while s < N:
        m = N // (2 * s)
        rho = ep[(2 * torch.arange(m, device=d.device) + 1) * s - 1]
        dd = w.reshape(m, 2 * s)
        z = torch.cat([bot[0::2], top[1::2]], dim=1)
        order = torch.argsort(dd, dim=1, stable=True)
        dd_s = torch.gather(dd, 1, order)
        z_s = torch.gather(z, 1, order)
        inv = torch.argsort(order, dim=1, stable=True)
        if 2 * s >= _CHUNK_AT:
            w, top, bot = _merge_chunked_vals(dd_s, z_s, rho, s, top, bot, inv)
            s *= 2
            continue
        lam, v_s = _secular_merge(dd_s, z_s, rho)
        v = torch.gather(v_s, 1, inv[:, :, None].expand(v_s.shape))  # child row order
        # eigencolumns stay in sorted-pole root order; one argsort at the end
        top = matmul(top[0::2][:, None, :], v[:, :s, :])[:, 0]
        bot = matmul(bot[1::2][:, None, :], v[:, s:, :])[:, 0]
        w = lam
        s *= 2
    wv = w.reshape(N)
    order = torch.argsort(wv, stable=True)
    return wv[order][:n], None, None, None


# slate_tpu runs stedc level-staged above this n (one TPU program per
# merge level); here the staged and fused forms are one code path
_STEDC_STAGE_ABOVE = 8192


def _stedc_base(d, e, N):
    """Pad (d, e) to N, decouple the _DC_SMALL-wide base blocks at their
    seams, and solve them with one batched steqr.  Returns (w (nblk, S),
    q (nblk, S, S), ep (N - 1,))."""
    n = d.shape[0]
    dtype, dev = d.dtype, d.device
    nblk = N // _DC_SMALL
    scale = d.abs().max() + 2 * (e.abs().max() if n > 1 else 0) + 1
    big = 4 * scale
    dp = torch.cat([d, torch.ones(N - n, dtype=dtype, device=dev) * big])
    ep = torch.cat([e, torch.zeros(N - 1 - (n - 1), dtype=dtype, device=dev)])
    seams = _DC_SMALL * torch.arange(1, nblk, device=dev) - 1
    dp[seams] += -ep[seams]
    dp[seams + 1] += -ep[seams]
    db = dp.reshape(nblk, _DC_SMALL)
    eb = torch.cat([ep, torch.zeros(1, dtype=dtype, device=dev)]).reshape(nblk, _DC_SMALL)
    eb = eb[:, :_DC_SMALL - 1]
    w, q = steqr(db, eb)
    return w, q, ep


def _merge_level_q(w, q, ep, s, N):
    """One merge level with the eigenvector stack carried: the single
    source of the vectors path."""
    m = N // (2 * s)
    rho = ep[(2 * torch.arange(m, device=w.device) + 1) * s - 1]
    dd = w.reshape(m, 2 * s)
    top = q[:, 0, :]
    bot = q[:, -1, :]
    z = torch.cat([bot[0::2], top[1::2]], dim=1)
    order = torch.argsort(dd, dim=1, stable=True)
    dd_s = torch.gather(dd, 1, order)
    z_s = torch.gather(z, 1, order)
    inv = torch.argsort(order, dim=1, stable=True)
    if 2 * s >= _CHUNK_AT:
        return _merge_chunked(dd_s, z_s, rho, s, q.reshape(m, 2, q.shape[1], q.shape[2]), inv)
    lam, v_s = _secular_merge(dd_s, z_s, rho)
    v = torch.gather(v_s, 1, inv[:, :, None].expand(v_s.shape))
    q_top = matmul(q[0::2], v[:, :s, :])
    q_bot = matmul(q[1::2], v[:, s:, :])
    return lam, torch.cat([q_top, q_bot], dim=1)


def stedc_staged(d: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """stedc with each merge level dispatched on its own: ``slate_tpu``'s
    large-n form.  Eager PyTorch already runs each level as its own
    kernels, so this is ``stedc`` itself."""
    return stedc(d, e)
