"""Numerics observability: the accuracy sibling of the flight recorder.

Counterpart of ``slate_tpu/obs/numerics.py``, with its names, thresholds,
environment variables and metric keys.  Where ``sched.*`` measures time
and ``mem.*`` space, ``num.*`` measures whether the answer is right: the
mesh k-loops carry running pivot-growth / diagonal-margin / orthogonality
gauges, the refinement loop keeps its (||r||, ||x||) trajectory, and the
Hager-Higham condition estimators run over the factored tiles.

- ``Option.NumMonitor`` resolution (``resolve_num_monitor`` /
  ``use_num_monitor`` / ``SLATE_TPU_NUM``): explicit > context > env >
  auto, auto = on iff the obs layer is enabled.  ``off`` runs exactly the
  unmonitored op sequence; ``on`` adds local reductions on the working
  tiles (no audited collective) and one host read at loop exit, and the
  factor stays bitwise the unmonitored one.
- the ``num.*`` metric surface: per-solve gauges and outcome counters in
  the metrics registry, ``num_counter_values()`` for the RunReport ``num``
  section (an all-zero section stays out of ``obs.report --check``), and
  the last-gauge store (``last_gauges``) the mixed ladder's health tier
  reads.
- alarm thresholds: ``GROWTH_THRESHOLD`` / ``CONDEST_THRESHOLD`` /
  ``ORTH_THRESHOLD`` (the f32-factor health bounds past which classic IR
  stalls, Carson & Higham 2018; the one-reorthogonalization trigger).

The gauges are functions of (matrix, schedule): bitwise the same across
lookahead depths and broadcast lowerings on one device.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, List, Optional

import torch

from .metrics import REGISTRY

NUM_MODES = ("off", "on", "auto")
NUM_ENV = "SLATE_TPU_NUM"
_NUM_DEFAULT: List[Optional[str]] = [None]

# f32-factor health bounds for the MixedPrecision=auto entry-tier choice
# (consulted only when monitoring is on).  GROWTH: element growth g of the
# working array makes the factor's backward error ~ eps32 * g; above ~2^20
# the f32 factor carries no usable digits and classic IR diverges.
# CONDEST: cond(A) above ~1/eps32 (~1e7) is the regime where IR on an f32
# factor stalls but GMRES-IR still converges (Carson & Higham 2018).
GROWTH_THRESHOLD = float(os.environ.get("SLATE_TPU_NUM_GROWTH_MAX", 2.0**20))
CONDEST_THRESHOLD = float(os.environ.get("SLATE_TPU_NUM_COND_MAX", 1e7))
# ORTH: the reflector/τ consistency loss of a monitored QR chain
# (num.qr_orth_margin / num.he2hb_orth_margin) is ~eps of the working
# dtype for healthy panels; past ~sqrt(eps64) half the digits of Q's
# orthogonality are gone — the classical one-reorthogonalization trigger
# (Giraud & Langou's "twice is enough" bound).  serve.Router's QR tier
# acts on it: one re-orthogonalization retry (``serve.retries``).
ORTH_THRESHOLD = float(os.environ.get("SLATE_TPU_NUM_ORTH_MAX", 1e-8))


class GrowthAbort(Exception):
    """Structured mid-k-loop escalation: a monitored no-pivot LU's in-carry
    running-growth gauge crossed ``GROWTH_THRESHOLD`` at a segment
    boundary, so the checkpointed driver STOPPED the k-loop instead of
    completing a garbage factor and discovering it at refinement time.
    The caller retries with a pivoted factorization (tntpiv/pp);
    ``serve.Router`` consumes it as exactly one retry
    (``serve.retries``)."""

    def __init__(self, op: str, growth: float, step: int, threshold: float):
        self.op = op
        self.growth = float(growth)
        self.step = int(step)
        self.threshold = float(threshold)
        super().__init__(
            f"num[{op}]: element growth {growth:.3g} crossed "
            f"GROWTH_THRESHOLD {threshold:.3g} at k-loop step {step} — "
            "factor aborted; retry with a pivoted method (tntpiv/pp)"
        )


def _tenant_tags() -> Dict[str, str]:
    """Per-tenant attribution on the num.* gauge/counter series: the ambient TraceContext's tenant when one is set,
    nothing otherwise.  Tenant only — per-request trace_ids would mint
    unbounded gauge series; numwatch and the un-served monitors run
    context-free and keep their exact historical series."""
    from . import context as _context

    return _context.tenant_tags()


def record_growth_abort(op: str, growth: float) -> None:
    """Count one mid-loop growth abort (an alarm that ACTED — distinct
    from ``num.growth_alarms``, which records post-hoc observations)."""
    REGISTRY.counter_add("num.growth_aborts", 1.0, op=op, **_tenant_tags())
    with _lock:
        _STATE["growth_aborts"] += 1
        _STATE["lu_growth_max"] = max(_STATE["lu_growth_max"], float(growth))


_lock = threading.Lock()
# last recorded gauges per op — the routing ladder's read side
_LAST: Dict[str, Dict[str, float]] = {}
# whether any monitored Cholesky recorded a margin this run (a genuine
# 0.0 margin — exact breakdown — must not read as "unset")
_MARGIN_SEEN = [False]
# last refinement trajectory per op: list of (rnorm, xnorm) per iteration
_LAST_HISTORY: Dict[str, List] = {}

# num section outcome totals (the mem._STATE pattern): worst-case gauges
# + counters accumulated this run, landed in every RunReport
_STATE = {
    "monitored": 0.0,          # monitored kernel executions
    "growth_alarms": 0.0,      # lu growth above GROWTH_THRESHOLD
    "growth_aborts": 0.0,      # mid-k-loop aborts acted on the alarm
    "condest_alarms": 0.0,     # condest above CONDEST_THRESHOLD
    "routed_gmres": 0.0,       # auto-ladder entries routed past IR
    "condest_solves": 0.0,     # distributed condition estimates run
    "lu_growth_max": 0.0,      # worst element growth seen this run
    "condest_max": 0.0,        # worst estimated condition number
    "chol_margin_min": 0.0,    # smallest Schur-diagonal margin seen
    "qr_orth_loss_max": 0.0,   # worst QR reflector/τ consistency loss
    "he2hb_orth_loss_max": 0.0,  # worst eig-chain (he2hb) panel loss
    "orth_alarms": 0.0,        # orth loss above ORTH_THRESHOLD
}


def reset() -> None:
    with _lock:
        _LAST.clear()
        _LAST_HISTORY.clear()
        _MARGIN_SEEN[0] = False
        for k in _STATE:
            _STATE[k] = 0.0


def num_counter_values() -> Dict[str, float]:
    """num.* outcome totals for the RunReport ``num`` section.  All-zero
    (no monitored kernels this run) stays out of the report comparison
    surface, exactly like the ft/ir/mem sections."""
    with _lock:
        return dict(_STATE)


# ---------------------------------------------------------------------------
# Option.NumMonitor resolution (the resolve_bcast_impl pattern)
# ---------------------------------------------------------------------------


def _check_mode(mode: str) -> str:
    if mode not in NUM_MODES:
        raise ValueError(
            f"unknown num-monitor mode {mode!r}; expected one of {NUM_MODES}"
        )
    return mode


def resolve_num_monitor(mode: Optional[str] = None) -> str:
    """Resolve an Option.NumMonitor value at driver level:
    explicit argument > ``use_num_monitor`` context > ``SLATE_TPU_NUM``
    environment > auto.  ``auto`` resolves here (not inside the kernel)
    to ``on`` iff the obs layer is enabled, so the returned "off"/"on"
    is what the drivers thread into their loops."""
    if mode is None:
        mode = _NUM_DEFAULT[-1]
    if mode is None:
        mode = os.environ.get(NUM_ENV) or "auto"
    mode = _check_mode(str(mode))
    if mode == "auto":
        from . import span as _span

        return "on" if _span.enabled() else "off"
    return mode


@contextlib.contextmanager
def use_num_monitor(mode: str):
    """Session-default monitoring mode for drivers called inside (tests /
    numwatch / CI sweeps); an explicit Option.NumMonitor still wins."""
    _NUM_DEFAULT.append(_check_mode(mode))
    try:
        yield
    finally:
        _NUM_DEFAULT.pop()


def monitor_from_opts(opts=None) -> Optional[str]:
    """Raw Option.NumMonitor value from a driver ``opts`` mapping (may be
    None — ``resolve_num_monitor`` is the single authority for the
    context/env/auto chain)."""
    from ..types import Option, get_option

    return get_option(opts, Option.NumMonitor)


# ---------------------------------------------------------------------------
# Recording (one host read per monitored run, at loop exit)
# ---------------------------------------------------------------------------


def _concrete(*vals):
    """Floats of the gauge scalars: the device values are stacked and read
    back in ONE host transfer (``tolist``), the counterpart of
    ``slate_tpu``'s one ``pmax`` at loop exit; never a read per step."""
    if not any(isinstance(v, torch.Tensor) for v in vals):
        return [float(v) for v in vals]
    dev = next(v.device for v in vals if isinstance(v, torch.Tensor))
    stacked = torch.stack([torch.as_tensor(v, device=dev).to(torch.float64).reshape(())
                           for v in vals])
    return [float(x) for x in stacked.tolist()]


def clear_last(op: str) -> None:
    """Drop the last-gauge entry for ``op`` — the routing ladder calls
    this before its f32 factor so ``last_gauges`` afterwards is
    fresh-from-THIS-factor or empty (a factor path that records no
    gauges, e.g. the ABFT kernels, must not inherit a previous solve's
    matrix health)."""
    with _lock:
        _LAST.pop(op, None)


def last_gauges(op: str) -> Dict[str, float]:
    """The most recent gauge set recorded for ``op`` (empty dict when the
    op has not run monitored) — the mixed ladder's routing read."""
    with _lock:
        return dict(_LAST.get(op, {}))


def orth_exceeded(op: str) -> bool:
    """Whether ``op``'s most recent monitored run recorded an
    orthogonality-loss gauge (``qr_orth_loss`` or ``he2hb_orth_loss``)
    past ORTH_THRESHOLD — serve.Router's re-orthogonalization retry
    trigger (the read side of ``num.qr_orth_margin`` /
    ``num.he2hb_orth_margin``)."""
    g = last_gauges(op)
    loss = max(g.get("qr_orth_loss", 0.0), g.get("he2hb_orth_loss", 0.0))
    return loss > ORTH_THRESHOLD


def last_history(op: str) -> List:
    """The most recent refinement trajectory for ``op``: a list of
    (rnorm, xnorm) pairs, initial solve first."""
    with _lock:
        return list(_LAST_HISTORY.get(op, []))


def _note(op: str, vals: Dict[str, float]) -> None:
    with _lock:
        _LAST.setdefault(op, {}).update(vals)
        _STATE["monitored"] += 1


def record_lu_growth(op: str, amax, gmax) -> None:
    """Record the element-growth gauges of one monitored LU run:
    ``amax`` = max|A| over the true extent, ``gmax`` = running max of the
    working array across the k-loop (the growth numerator).  The growth
    factor max|A^(k)|/max|A| is THE classic breakdown monitor for
    no-pivot and tournament LU (Wilkinson; 2^{n-1} worst case under
    partial pivoting)."""
    c = _concrete(amax, gmax)
    if c is None:
        return
    a, g = c
    growth = g / a if a > 0 else 0.0
    REGISTRY.gauge_set("num.lu_amax", a, op=op, **_tenant_tags())
    REGISTRY.gauge_set("num.lu_growth", growth, op=op, **_tenant_tags())
    _note(op, {"amax": a, "gmax": g, "growth": growth})
    with _lock:
        _STATE["lu_growth_max"] = max(_STATE["lu_growth_max"], growth)
        if growth > GROWTH_THRESHOLD:
            _STATE["growth_alarms"] += 1
            REGISTRY.counter_add("num.growth_alarms", 1.0, op=op, **_tenant_tags())


def record_chol_gauges(op: str, margin, lmin, lmax) -> None:
    """Record one monitored Cholesky run's diagonal gauges: ``margin`` =
    the smallest Schur-complement diagonal entry seen right before its
    panel factorization (<= 0 means breakdown — info != 0 — small
    positive means NEAR-breakdown the info code cannot see), ``lmin`` /
    ``lmax`` = min/max diagonal of the final factor (cond(L)^2 lower
    bound (lmax/lmin)^2)."""
    c = _concrete(margin, lmin, lmax)
    if c is None:
        return
    m, lo, hi = c
    REGISTRY.gauge_set("num.chol_margin", m, op=op, **_tenant_tags())
    REGISTRY.gauge_set("num.chol_diag_min", lo, op=op, **_tenant_tags())
    REGISTRY.gauge_set("num.chol_diag_max", hi, op=op, **_tenant_tags())
    _note(op, {"margin": m, "diag_min": lo, "diag_max": hi})
    with _lock:
        if not _MARGIN_SEEN[0]:
            _MARGIN_SEEN[0] = True
            _STATE["chol_margin_min"] = m
        else:
            _STATE["chol_margin_min"] = min(_STATE["chol_margin_min"], m)


def record_qr_orth(op: str, loss) -> None:
    """Record one monitored QR chain's orthogonality-loss proxy: the
    running max over panels of the reflector/τ consistency residual
    |T(VᴴV)Tᴴ − T − Tᴴ| / max|T| (``dist_qr._qr_orth_loss``) — ~eps for
    healthy panels, rising when cancellation degrades the implicit Q's
    orthogonality.  Surfaced as the ``num.qr_orth_margin`` gauge and the
    ``qr_orth_loss_max`` num-section total (lower is better)."""
    c = _concrete(loss)
    if c is None:
        return
    val = c[0]
    REGISTRY.gauge_set("num.qr_orth_margin", val, op=op, **_tenant_tags())
    _note(op, {"qr_orth_loss": val})
    with _lock:
        _STATE["qr_orth_loss_max"] = max(_STATE["qr_orth_loss_max"], val)
        if val > ORTH_THRESHOLD:
            _STATE["orth_alarms"] += 1
            REGISTRY.counter_add("num.orth_alarms", 1.0, op=op,
                                 **_tenant_tags())


def record_he2hb_orth(op: str, loss) -> None:
    """Record one monitored two-stage eig (he2hb) chain's
    orthogonality-loss proxy: the running max over panels of
    the reflector/τ consistency residual of the REPLICATED gathered-
    column panel QR (``dist_qr._qr_orth_loss`` — the identity holds for
    any compact-WY pair, so the gauge transfers to the band-reduction
    panels unchanged and is collective-free by replication).  Surfaced
    as the ``num.he2hb_orth_margin`` gauge and the
    ``he2hb_orth_loss_max`` num-section total (lower is better)."""
    c = _concrete(loss)
    if c is None:
        return
    val = c[0]
    REGISTRY.gauge_set("num.he2hb_orth_margin", val, op=op, **_tenant_tags())
    _note(op, {"he2hb_orth_loss": val})
    with _lock:
        _STATE["he2hb_orth_loss_max"] = max(_STATE["he2hb_orth_loss_max"],
                                            val)
        if val > ORTH_THRESHOLD:
            _STATE["orth_alarms"] += 1
            REGISTRY.counter_add("num.orth_alarms", 1.0, op=op,
                                 **_tenant_tags())


def record_condest(op: str, rcond) -> None:
    """Record one distributed condition estimate (reciprocal, the LAPACK
    convention) as the ``num.condest`` gauge (stored as the condition
    number 1/rcond — the directly alarmable quantity)."""
    c = _concrete(rcond)
    if c is None:
        return
    rc = c[0]
    cond = (1.0 / rc) if rc > 0 else float("inf")
    REGISTRY.gauge_set("num.condest", cond, op=op, **_tenant_tags())
    _note(op, {"rcond": rc, "cond": cond})
    with _lock:
        _STATE["condest_solves"] += 1
        if cond > _STATE["condest_max"] and cond != float("inf"):
            _STATE["condest_max"] = cond
        if cond > CONDEST_THRESHOLD:
            _STATE["condest_alarms"] += 1
            REGISTRY.counter_add("num.condest_alarms", 1.0, op=op, **_tenant_tags())


def record_routed_gmres(op: str) -> None:
    """The auto ladder skipped the IR tier on measured health (growth /
    condest alarm) and entered at GMRES-IR."""
    REGISTRY.counter_add("num.routed_gmres", 1.0, op=op, **_tenant_tags())
    with _lock:
        _STATE["routed_gmres"] += 1


def record_ir_history(op: str, hist, iters) -> None:
    """Record the refinement trajectory the fused while_loop carried:
    ``hist`` is the (max_iter+1, 2) on-device (||r||, ||x||) buffer (NaN
    rows never reached), ``iters`` the measured trip count.  One
    device->host read — the buffer the drivers return anyway.  Lands as
    the ``ir.residual_history`` gauge series (tagged by iteration) so
    a stalling-but-eventually-converging solve is distinguishable from a
    healthy one in any RunReport."""
    import numpy as np

    if isinstance(hist, torch.Tensor):
        hist = hist.to(torch.float64).cpu()
    h = np.asarray(hist, dtype=float).reshape(-1, 2)
    n_it = max(int(iters) + 1, 0)
    rows = [(float(h[i, 0]), float(h[i, 1]))
            for i in range(min(n_it, h.shape[0]))
            if np.isfinite(h[i]).all()]
    with _lock:
        _LAST_HISTORY[op] = rows
    for i, (rn, xn) in enumerate(rows):
        REGISTRY.gauge_set("ir.residual_history", rn, op=op, iter=i,
                           **_tenant_tags())
        REGISTRY.gauge_set("ir.xnorm_history", xn, op=op, iter=i,
                           **_tenant_tags())


def route_entry_tier(kind: str, gauges: Dict[str, float],
                     rcond: Optional[float]) -> bool:
    """The health-aware entry-tier decision for ``MixedPrecision=auto``:
    True = skip the IR tier and enter at GMRES-IR.  Consulted by
    ``dist_refine.mixed_mesh_route`` with the monitored f32-factor
    gauges and the (optional) distributed condition estimate."""
    growth = gauges.get("growth", 0.0)
    margin = gauges.get("margin")
    cond = (1.0 / rcond) if rcond and rcond > 0 else None
    if growth > GROWTH_THRESHOLD:
        return True
    if cond is not None and cond > CONDEST_THRESHOLD:
        return True
    # a vanishing Cholesky margin relative to the diagonal scale is the
    # SPD near-breakdown analogue of growth (the f32 factor kept ~no
    # digits of the small pivots)
    if margin is not None and margin > 0:
        scale = max(gauges.get("diag_max", 1.0) ** 2, 1e-300)
        if margin / scale < 1.0 / CONDEST_THRESHOLD:
            return True
    return False
