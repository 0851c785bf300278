"""Hermitian / symmetric indefinite solvers: hetrf / hetrs / hesv (+ sysv).

Counterpart of ``slate_tpu/linalg/indefinite.py`` (the reference's
``src/hetrf.cc``, ``src/hetrs.cc``, ``src/hesv.cc``), with its names, factor
type, info codes and return conventions.  The indefinite matrix is factored
by unitary congruence, A = Q T Q^H, through the eigensolver's two-stage band
reduction (``eig.he2hb`` -> ``eig.hb2st``), with T real symmetric
tridiagonal; the solve is Q (T^-1 (Q^H b)) with a partial-pivot tridiagonal
LU (``gtsv_array``).  On a CUDA tensor every real stage-1 panel runs the
hand-written ``qr_panel_offset`` kernel (``eig.he2hb``); the adjoint applies
are ``eig._apply_panels`` and ``eig._chase_sweep_apply`` with
``adjoint=True``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .eig import (
    _EIG_NB,
    Hb2stFactors,
    He2hbFactors,
    _apply_panels,
    _chase_sweep_apply,
    hb2st,
    he2hb,
    unmtr_hb2st,
    unmtr_he2hb,
)

# ---------------------------------------------------------------------------
# Tridiagonal solve with partial pivoting (LAPACK gtsv)
# ---------------------------------------------------------------------------


def gtsv_array(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve tridiag(dl, d, du) X = B with partial pivoting: rows k and
    k + 1 swap when |l_k| > |d_k| strictly, which fills a second
    superdiagonal.  A zero pivot divides by 1; info is 1 + the first zero
    or non-finite |d| of U, else 0.  Returns (X, info); a 1-D ``b`` gives a
    1-D X.

    The elimination runs on one packed row [U(k, k), U(k, k+1), U(k, k+2),
    b_k] carried from step to step: step k pivots it against row k + 1 of
    the original matrix, writes the upper row and carries the other on.
    Every step is a fixed handful of ops on Python-int indices, with no
    read to the host."""
    if b.dim() == 1:
        x, info = gtsv_array(dl, d, du, b[:, None])
        return x[:, 0], info
    n, nrhs = b.shape
    dtype, dev = b.dtype, b.device
    # next[k]: row k + 1 in the frame of column k, (l_k, d_{k+1}, du_{k+1}, b_{k+1})
    nxt = torch.zeros((max(n - 1, 0), 3 + nrhs), dtype=dtype, device=dev)
    nxt[:, 0] = dl[:n - 1]
    nxt[:, 1] = d[1:]
    nxt[:n - 2, 2] = du[1:n - 1]
    nxt[:, 3:] = b[1:]
    rows = torch.empty((n, 3 + nrhs), dtype=dtype, device=dev)  # U's rows and the reduced b
    row = torch.zeros(3 + nrhs, dtype=dtype, device=dev)
    row[0] = d[0]
    row[1:1 + min(n - 1, 1)] = du[:1]
    row[3:] = b[0]
    zero = row.new_zeros(1)
    for k in range(n - 1):
        nk = nxt[k]
        swap = torch.gt(nk[0].abs(), row[0].abs())
        top = torch.where(swap, nk, row)
        bot = torch.where(swap, row, nk)
        m = bot[0] / torch.where(top[0] == 0, 1, top[0])
        bot.addcmul_(m, top, value=-1)
        rows[k].copy_(top)
        row = torch.cat((bot[1:3], zero, bot[3:]))
    rows[n - 1].copy_(row)
    u = rows[:, :3]
    piv = torch.where(u[:, 0] == 0, 1, u[:, 0])
    x = torch.zeros((n + 2, nrhs), dtype=dtype, device=dev)  # two zero rows of pad
    for k in range(n - 1, -1, -1):
        xk = torch.addcmul(rows[k, 3:], rows[k, 1], x[k + 1], value=-1, out=x[k])
        xk.addcmul_(rows[k, 2], x[k + 2], value=-1).div_(piv[k])
    dd = u[:, 0].abs()
    bad = (dd == 0) | ~torch.isfinite(dd)
    first = torch.argmax(bad.to(torch.int32)) + 1
    info = torch.where(bad.any(), first, 0).to(torch.int32)
    return x[:n], info


# ---------------------------------------------------------------------------
# hetrf / hetrs / hesv
# ---------------------------------------------------------------------------


class HetrfFactors(NamedTuple):
    """A = Q T Q^H: stage-1/2 transforms + real tridiagonal T."""

    stage1: He2hbFactors
    stage2: Hb2stFactors
    phases: torch.Tensor
    d: torch.Tensor  # T main diagonal (real)
    e: torch.Tensor  # T off-diagonal (real)


def hetrf_array(a: torch.Tensor, nb: int = _EIG_NB) -> Tuple[HetrfFactors, torch.Tensor]:
    """Factor the Hermitian indefinite A = Q T Q^H (src/hetrf.cc
    capability).  info is always 0: a singular T is reported by the
    solve."""
    f1 = he2hb(a, nb)
    d, e, f2, phases = hb2st(f1.band, nb)
    return HetrfFactors(f1, f2, phases, d, e), torch.zeros((), dtype=torch.int32, device=a.device)


def _apply_q(f: HetrfFactors, c: torch.Tensor, adjoint: bool) -> torch.Tensor:
    """c <- Q c (or Q^H c): Q = Q_he2hb U_hb2st P_phases."""
    cplx = c.is_complex()
    if not adjoint:
        z = f.phases[:, None] * c if cplx else c
        z = unmtr_hb2st(f.stage2, z)
        return unmtr_he2hb(f.stage1, z)
    z = _unmtr_he2hb_adj(f.stage1, c)
    z = _unmtr_hb2st_adj(f.stage2, z)
    return f.phases.conj()[:, None] * z if cplx else z


def _unmtr_he2hb_adj(f1: He2hbFactors, c: torch.Tensor) -> torch.Tensor:
    """C <- Q^H C for the stage-1 Q: the panels left to right, T^H."""
    return _apply_panels(f1.v, f1.t, c, [(k + 1) * f1.nb for k in range(f1.v.shape[0])],
                         adjoint=True)


def _unmtr_hb2st_adj(f2: Hb2stFactors, z: torch.Tensor) -> torch.Tensor:
    """Z <- U^H Z for the stage-2 U: the chase's reflectors in the order
    they were made, one batched sweep at a time."""
    return _chase_sweep_apply(f2.vs, f2.taus, z, f2.n, f2.w, adjoint=True)


def hetrs_array(f: HetrfFactors, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve A X = B from hetrf factors (src/hetrs.cc).  Returns (X, info),
    info from the tridiagonal solve."""
    squeeze = b.dim() == 1
    bd = b[:, None] if squeeze else b
    y = _apply_q(f, bd, adjoint=True)
    e = f.e.to(bd.dtype)
    t, info = gtsv_array(e, f.d.to(bd.dtype), e, y)
    x = _apply_q(f, t, adjoint=False)
    return (x[:, 0] if squeeze else x), info


def hesv_array(a: torch.Tensor, b: torch.Tensor, nb: int = _EIG_NB):
    """Factor + solve (src/hesv.cc).  Returns (x, factors, info)."""
    f, _ = hetrf_array(a, nb)
    x, info = hetrs_array(f, b)
    return x, f, info


# symmetric aliases (src/sysv; real symmetric is the Hermitian path)
sytrf_array = hetrf_array
sytrs_array = hetrs_array
sysv_array = hesv_array
