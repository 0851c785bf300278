"""Mixed-precision iterative refinement: classic IR and GMRES-IR.

Counterpart of ``slate_tpu/linalg/refine.py`` (``src/{gesv_mixed,
gesv_mixed_gmres,posv_mixed,posv_mixed_gmres}.cc``): factor in f32 (c64
for complex), refine in the operand's precision, stop when
``||r||_inf <= ||x||_inf * cte`` with ``cte = ||A||_inf eps sqrt(n)``
(:func:`gate_cte`), and fall back to the full-precision solve after
max_iter failures when Option.UseFallbackSolver is set.

PyTorch runs eagerly: ``_refine_loop``'s ``while_loop`` and GMRES's restart
loop are Python loops that read their stopping test on the host (one sync
per iteration), and ``_fallback`` runs the full solve only when the
refinement did not converge.  GMRES-IR over several right-hand sides keeps
``slate_tpu``'s ``vmap`` semantics: the columns run as one batch, and a
column that has converged keeps its x while the others go on.

The ``ir.*`` counters live on the port's ``obs.REGISTRY`` with
``slate_tpu``'s names; as there, the single-chip drivers here bump none of
them (the mesh ladder does).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.matrix import symmetrize
from ..ops.matmul import matmul
from ..ops.tile_ops import genorm
from ..types import Norm, Option, Options, Uplo, get_option


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype


def _lo_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.complex64 if dtype.is_complex else torch.float32


def gate_cte(anorm: torch.Tensor, n: int, dtype: torch.dtype, tol_factor: float = 1.0
             ) -> torch.Tensor:
    """The refinement's convergence constant ``||A|| eps sqrt(n) tol_factor``
    (gesv_mixed.cc), in the real dtype of ``dtype``: the loop stops when
    ``||r|| <= ||x|| cte``.  The one definition the single-chip loop and the
    mesh refinement share."""
    rdt = _real_dtype(dtype)
    eps = torch.finfo(rdt).eps
    root_n = torch.sqrt(torch.tensor(float(n), dtype=rdt, device=anorm.device))
    return anorm * eps * root_n * tol_factor


# -- ir.* counters (always on, cheap; a RunReport's ``ir`` section) ----------

_IR_COUNTERS = (
    "ir.solves", "ir.converged", "ir.iters_total", "ir.gmres_solves",
    "ir.escalated_gmres", "ir.fallback", "ir.residual_gemm_bytes",
)


def _registry():
    from ..obs import REGISTRY

    return REGISTRY


def ir_count(name: str, op: str, n: float = 1.0) -> None:
    """Bump one ``ir.*`` counter, tagged by op (gesv / posv)."""
    _registry().counter_add(name, n, op=op)


def ir_gauge(name: str, value: float, op: str) -> None:
    _registry().gauge_set(name, float(value), op=op)


def ir_counter_values() -> dict:
    """The total of every ``ir.*`` counter over its op tags."""
    out = {name.split("ir.", 1)[1]: 0.0 for name in _IR_COUNTERS}
    for entry in _registry().snapshot()["counters"]:
        if entry["name"] in _IR_COUNTERS:
            out[entry["name"].split("ir.", 1)[1]] += float(entry["value"])
    return out


class RefineResult(NamedTuple):
    """A mixed-precision refined solve.  ``iters`` is -1 when the fallback
    full-precision solve produced ``x``, and ``info`` is then that
    factorization's code (0-d int32 tensors; ``converged`` a 0-d bool)."""

    x: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor
    info: torch.Tensor


def _refine_loop(a_hi: torch.Tensor, b: torch.Tensor,
                 lo_solve: Callable[[torch.Tensor], torch.Tensor], max_iter: int,
                 tol_factor: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classic iterative refinement.  Returns (x, iters, converged)."""
    n = a_hi.shape[0]
    cte = gate_cte(genorm(Norm.Inf, a_hi), n, a_hi.dtype, tol_factor)

    def residual(x):
        r = b - matmul(a_hi, x).to(b.dtype)
        return r, genorm(Norm.Inf, r) <= genorm(Norm.Inf, x) * cte

    x = lo_solve(b).to(a_hi.dtype)
    r, done = residual(x)
    it = 0
    while it < max_iter and not bool(done):
        x = x + lo_solve(r).to(a_hi.dtype)
        r, done = residual(x)
        it += 1
    return x, torch.tensor(it, dtype=torch.int32, device=b.device), done


def _fallback(done: torch.Tensor, x: torch.Tensor, iters: torch.Tensor,
              full_solve: Callable[[], Tuple[torch.Tensor, torch.Tensor]]):
    """(x, iters, info): the refined x with info 0 when it converged, else
    ``full_solve()``'s (x, info) with iters -1 (the full solve runs only
    then)."""
    if bool(done):
        return x, iters, torch.zeros((), dtype=torch.int32, device=x.device)
    xf, info = full_solve()
    return xf, torch.full_like(iters, -1), torch.as_tensor(info, device=x.device).to(torch.int32)


def gesv_mixed_array(a: torch.Tensor, b: torch.Tensor, opts: Optional[Options] = None
                     ) -> RefineResult:
    """f32-factor, refine-in-``a.dtype`` LU solve (src/gesv_mixed.cc)."""
    from .lu import gesv_array, getrf_array, getrs_array

    lo = _lo_dtype(a.dtype)
    f = getrf_array(a.to(lo))
    x, iters, done = _refine_loop(a, b, lambda rhs: getrs_array(f, rhs.to(lo)),
                                  get_option(opts, Option.MaxIterations, 30))
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    if get_option(opts, Option.UseFallbackSolver, True):
        def full():
            xf, ff = gesv_array(a, b)
            return xf, ff.info

        x, iters, info = _fallback(done, x, iters, full)
    return RefineResult(x, iters, done, info)


def posv_mixed_array(a: torch.Tensor, b: torch.Tensor, uplo: Uplo = Uplo.Lower,
                     opts: Optional[Options] = None) -> RefineResult:
    """src/posv_mixed.cc: the f32 Cholesky factor refined against the full
    Hermitian matrix."""
    from .chol import posv_array, potrf_array, potrs_array

    lo = _lo_dtype(a.dtype)
    f, _ = potrf_array(a.to(lo), uplo)
    a_full = symmetrize(a, uplo, conj=a.is_complex())
    x, iters, done = _refine_loop(a_full, b, lambda rhs: potrs_array(f, rhs.to(lo), uplo),
                                  get_option(opts, Option.MaxIterations, 30))
    info = torch.zeros((), dtype=torch.int32, device=a.device)
    if get_option(opts, Option.UseFallbackSolver, True):
        def full():
            xf, _, inf = posv_array(a, b, uplo)
            return xf, inf

        x, iters, info = _fallback(done, x, iters, full)
    return RefineResult(x, iters, done, info)


# ---------------------------------------------------------------------------
# GMRES-IR (src/gesv_mixed_gmres.cc, posv_mixed_gmres.cc)
# ---------------------------------------------------------------------------


def _lstsq_min_norm(h: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """min ||rhs - H y|| per batch entry by the SVD, with
    ``jnp.linalg.lstsq``'s cutoff (zero singular values and those below
    eps max(m, n) s_max count as zero): the minimum-norm answer also when H is
    rank-deficient after a breakdown, where a QR-based solve (what
    ``torch.linalg.lstsq`` has on the card) assumes full rank.  ``h`` is
    (k, m + 1, m), ``rhs`` (k, m + 1)."""
    u, s, vh = torch.linalg.svd(h, full_matrices=False)
    rcond = torch.finfo(s.dtype).eps * max(h.shape[-2:])
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1 / torch.where(keep, s, torch.ones_like(s)), 0).to(h.dtype)
    uhb = (u.conj().transpose(-1, -2) @ rhs[..., None])[..., 0]
    return (vh.conj().transpose(-1, -2) @ (s_inv * uhb)[..., None])[..., 0]


def _gmres(matvec: Callable[[torch.Tensor], torch.Tensor],
           precond: Callable[[torch.Tensor], torch.Tensor],
           b: torch.Tensor, x0: torch.Tensor, restart: int, tol: torch.Tensor,
           max_restarts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-preconditioned restarted GMRES on the columns of ``b`` (n, k),
    batched: ``matvec`` and ``precond`` take (n, k).  Each column stops at
    its own test ``rnorm <= tol`` (``tol`` (k,)) or after ``max_restarts``
    cycles and then keeps its x and rnorm, as ``slate_tpu``'s vmapped
    ``while_loop`` does.  Returns (x, rnorm (k,))."""
    n, k = b.shape
    m = restart
    dt = b.dtype
    dev = b.device
    x = x0.clone()
    rnorm = torch.full((k,), float("inf"), dtype=tol.dtype, device=dev)
    rows = torch.arange(m + 1, device=dev)
    for _ in range(max_restarts):
        active = rnorm > tol
        if not bool(active.any()):
            break
        r = precond(b - matvec(x))
        beta = torch.linalg.vector_norm(r, dim=0)
        v = torch.zeros((m + 1, n, k), dtype=dt, device=dev)
        v[0] = r / torch.where(beta == 0, 1, beta)
        h = torch.zeros((m + 1, m, k), dtype=dt, device=dev)
        for j in range(m):
            w = precond(matvec(v[j]))
            # modified Gram-Schmidt against all m + 1 rows (rows > j are zero)
            hj = torch.einsum("pnk,nk->pk", v.conj(), w) * (rows <= j).to(dt)[:, None]
            w = w - torch.einsum("pk,pnk->nk", hj, v)
            hn = torch.linalg.vector_norm(w, dim=0)
            h[:, j] = hj
            h[j + 1, j] = hn.to(dt)
            v[j + 1] = w / torch.where(hn == 0, 1, hn)
        e1 = torch.zeros((k, m + 1), dtype=dt, device=dev)
        e1[:, 0] = beta.to(dt)
        y = _lstsq_min_norm(h.permute(2, 0, 1), e1)  # (k, m)
        x_new = x + torch.einsum("kp,pnk->nk", y, v[:m])
        rn_new = torch.linalg.vector_norm(precond(b - matvec(x_new)), dim=0)
        x = torch.where(active[None, :], x_new, x)
        rnorm = torch.where(active, rn_new.to(rnorm.dtype), rnorm)
    return x, rnorm


def _gmres_multi_rhs(a: torch.Tensor, b: torch.Tensor, matvec, precond, restart: int,
                     max_restarts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """GMRES on every column of ``b`` with tolerance sqrt(n) eps ||b_j||;
    returns (x shaped like b, the worst column's residual norm)."""
    rdt = _real_dtype(a.dtype)
    scale = torch.sqrt(torch.tensor(float(a.shape[0]), dtype=rdt, device=b.device)) \
        * torch.finfo(rdt).eps
    bm = b[:, None] if b.dim() == 1 else b
    tol = (scale * torch.linalg.vector_norm(bm, dim=0)).to(rdt)
    x, rnorms = _gmres(matvec, precond, bm, torch.zeros_like(bm), restart, tol, max_restarts)
    if b.dim() == 1:
        return x[:, 0], rnorms[0]
    return x, rnorms.max()


def gesv_mixed_gmres_array(a: torch.Tensor, b: torch.Tensor, opts: Optional[Options] = None,
                           restart: int = 30) -> Tuple[torch.Tensor, torch.Tensor]:
    """GMRES-IR: the f32 LU as the preconditioner of GMRES in ``a.dtype``
    (src/gesv_mixed_gmres.cc).  b may be (n,) or (n, k).  Returns (x,
    the worst residual norm)."""
    from .lu import getrf_array, getrs_array

    lo = _lo_dtype(a.dtype)
    f = getrf_array(a.to(lo))
    return _gmres_multi_rhs(
        a, b, lambda v: matmul(a, v).to(a.dtype),
        lambda v: getrs_array(f, v.to(lo)).to(a.dtype),
        restart, get_option(opts, Option.MaxIterations, 30))


def posv_mixed_gmres_array(a: torch.Tensor, b: torch.Tensor, uplo: Uplo = Uplo.Lower,
                           opts: Optional[Options] = None, restart: int = 30
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """src/posv_mixed_gmres.cc: the f32 Cholesky factor as the
    preconditioner."""
    from .chol import potrf_array, potrs_array

    lo = _lo_dtype(a.dtype)
    a_full = symmetrize(a, uplo, conj=a.is_complex())
    f, _ = potrf_array(a.to(lo), uplo)
    return _gmres_multi_rhs(
        a, b, lambda v: matmul(a_full, v).to(a.dtype),
        lambda v: potrs_array(f, v.to(lo), uplo).to(a.dtype),
        restart, get_option(opts, Option.MaxIterations, 30))
