"""ServiceController: the SLA control loop over the batch-window queue.

Counterpart of ``slate_tpu/serve/controller.py``.  A periodic ``step()``
reads the SLA surface (``trace.sla_values``: per-(op, class) latency
quantiles and outcome rates) and the queue's depth, and moves the three
serving knobs those measurements are about:

- **(B, T) window shaping.**  Depth held over ``depth_hi`` widens the window
  (larger B, longer T: the backlog goes out in fewer, fuller programs);
  depth under ``depth_lo`` restores the baseline.
- **Latency guard.**  p95 over the SLO shrinks T toward its floor: the
  window wait is the one latency term the service layer adds itself.
- **Precision-tier entry point.**  A held failure tail (the non-served
  outcome rates) escalates ``Router.tier_map`` so friendly operators enter
  at the pp + GMRES-IR tier; a clean tail releases it.

Every latch is a ``Hysteresis`` pair (trip threshold above the release
threshold, arming streaks, cooldown ticks), so one noisy reading cannot
flap a knob.  Every actuation counts ``serve.controller_actuations``, sets
the ``serve.queue_window_*`` gauges and publishes a ``controller`` event on
the telemetry bus.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import obs
from ..obs import REGISTRY
from . import trace as rtrace
from .metrics import serve_count


class Hysteresis:
    """Two-threshold latch with arming streaks and a post-actuation cooldown.
    ``observe(value)`` returns "trip" on the tick the value has been >= ``hi``
    for ``arm`` ticks in a row (the latch closes), "release" likewise at
    <= ``lo``, else None.  While the latch is closed further highs return
    None, and ``cooldown`` ticks pass after any actuation before the next, so
    the loop cannot flap even on a square-wave input."""

    def __init__(self, hi: float, lo: float, arm: int = 2, cooldown: int = 3) -> None:
        if lo > hi:
            raise ValueError(f"hysteresis lo {lo} > hi {hi}")
        self.hi = float(hi)
        self.lo = float(lo)
        self.arm = int(arm)
        self.cooldown = int(cooldown)
        self.tripped = False
        self._hi_streak = 0
        self._lo_streak = 0
        self._cool = 0

    def observe(self, value: float) -> Optional[str]:
        if value >= self.hi:
            self._hi_streak += 1
            self._lo_streak = 0
        elif value <= self.lo:
            self._lo_streak += 1
            self._hi_streak = 0
        else:
            self._hi_streak = 0
            self._lo_streak = 0
        if self._cool > 0:
            self._cool -= 1
            return None
        if not self.tripped and self._hi_streak >= self.arm:
            self.tripped = True
            self._cool = self.cooldown
            self._hi_streak = 0
            return "trip"
        if self.tripped and self._lo_streak >= self.arm:
            self.tripped = False
            self._cool = self.cooldown
            self._lo_streak = 0
            return "release"
        return None


class ServiceController:
    """The control loop: call ``step()`` periodically (the service worker
    does; tests and the smoke drive it directly)."""

    def __init__(self, queue, *, slo_p95_s: float = 0.25, depth_hi: Optional[float] = None,
                 depth_lo: Optional[float] = None, failure_rate_hi: float = 0.05,
                 failure_rate_lo: float = 0.005, arm: int = 2, cooldown: int = 3,
                 widen_factor: float = 2.0, min_window_s: float = 0.001) -> None:
        self.queue = queue
        self.router = queue.router
        self.slo_p95_s = float(slo_p95_s)
        # the baseline (B, T) a release restores
        self._base_batch = int(queue.max_batch)
        self._base_window_s = float(queue.window_s)
        self.widen_factor = float(widen_factor)
        self.min_window_s = float(min_window_s)
        dhi = depth_hi if depth_hi is not None else 2.0 * queue.max_batch
        dlo = depth_lo if depth_lo is not None else 0.5 * queue.max_batch
        self.depth_latch = Hysteresis(dhi, dlo, arm=arm, cooldown=cooldown)
        # latency against the SLO: hi = a breach, lo = within 80% of it
        self.latency_latch = Hysteresis(self.slo_p95_s, 0.8 * self.slo_p95_s, arm=arm,
                                        cooldown=cooldown)
        self.failure_latch = Hysteresis(failure_rate_hi, failure_rate_lo, arm=arm,
                                        cooldown=cooldown)
        self.ticks = 0
        self.actuations: List[dict] = []

    # -- signal extraction -------------------------------------------------

    def signals(self) -> Dict[str, float]:
        """The three scalars the latches read: the worst p95 over the (op,
        class) cells (the SLO is one promise of the service), the sum of
        the non-served outcome rates, and the queue's depth."""
        sla = rtrace.sla_values()
        p95 = max((v for k, v in sla.items() if k.startswith("latency_p95_")), default=0.0)
        # every non-served outcome (rejects and failures alike) is tail
        fail = sum(v for k, v in sla.items()
                   if k.startswith("outcome_rate_") and not k.startswith("outcome_rate_served"))
        return {"depth": float(self.queue.depth()), "p95_s": p95, "failure_rate": fail}

    # -- the loop ----------------------------------------------------------

    def step(self) -> List[dict]:
        """One control tick: observe, latch, actuate.  Returns this tick's
        actuations (usually none)."""
        self.ticks += 1
        sig = self.signals()
        acted: List[dict] = []

        edge = self.depth_latch.observe(sig["depth"])
        if edge == "trip":
            acted.append(self._actuate("widen_window", sig,
                                       batch=int(self._base_batch * self.widen_factor),
                                       window_s=self._base_window_s * self.widen_factor))
        elif edge == "release":
            acted.append(self._actuate("restore_window", sig, batch=self._base_batch,
                                       window_s=self._base_window_s))

        edge = self.latency_latch.observe(sig["p95_s"])
        if edge == "trip":
            acted.append(self._actuate(
                "shrink_window", sig, batch=self.queue.max_batch,
                window_s=max(self.min_window_s, self._base_window_s / self.widen_factor)))
        elif edge == "release":
            acted.append(self._actuate("restore_window", sig, batch=self.queue.max_batch,
                                       window_s=self._base_window_s))

        edge = self.failure_latch.observe(sig["failure_rate"])
        if edge == "trip":
            acted.append(self._actuate("escalate_tier", sig, tier={"friendly": "hostile"}))
        elif edge == "release":
            acted.append(self._actuate("release_tier", sig, tier={}))
        return acted

    def _actuate(self, action: str, sig: Dict[str, float], *, batch: Optional[int] = None,
                 window_s: Optional[float] = None,
                 tier: Optional[Dict[str, str]] = None) -> dict:
        if batch is not None:
            self.queue.max_batch = int(batch)
        if window_s is not None:
            self.queue.window_s = float(window_s)
        if tier is not None:
            self.router.tier_map = dict(tier)
        serve_count("controller_actuations")
        rec = {"tick": self.ticks, "action": action, "batch": self.queue.max_batch,
               "window_s": self.queue.window_s, "tier_map": dict(self.router.tier_map),
               "signals": dict(sig)}
        self.actuations.append(rec)
        if obs.enabled():
            REGISTRY.gauge_set("serve.queue_window_batch", float(self.queue.max_batch),
                               queue=self.queue.name)
            REGISTRY.gauge_set("serve.queue_window_s", float(self.queue.window_s),
                               queue=self.queue.name)
        self._publish(rec)
        return rec

    def _publish(self, rec: dict) -> None:
        import sys as _sys

        _live = _sys.modules.get(__package__.rsplit(".", 1)[0] + ".obs.live")
        if _live is not None:
            _live.publish("controller", rec)
