"""Deterministic, seeded fault injection for the checksum-carrying kernels.

Counterpart of ``slate_tpu/ft/inject.py``, plain numpy, so a seed draws
the same fault in both packages bit for bit.  A ``Fault`` names one
perturbation: which op class, which k-step, which phase of that step,
which logical tile, which mesh coordinate, and how to corrupt it.  The
active plan is lowered to ``slate_tpu``'s two small spec arrays (ints +
values); the port's ``ft.abft`` loops run eagerly with the step k a
Python int, so each hook is a host-side test of the armed slots against
(k, phase) and touches one tile of the virtual mesh's stacks.

Phases (the three places a tile can silently rot in a distributed
right-looking step):

- ``panel``: the owner's STORED copy of a finalized panel tile is
  corrupted after the broadcast was issued (an HBM fault after the NIC
  read the data).  The clean broadcast copy fed every consumer, so the
  damage stays in one output tile — the exactly-correctable class.
- ``bcast``: the RECEIVED broadcast copy on one mesh coordinate is
  corrupted before that device's trailing update consumes it — live-data
  corruption that propagates; detectable, repaired by recompute.
- ``trailing``: one trailing-matrix tile is corrupted right after the
  step-k update lands — live for factorizations (propagates through
  later panels), final for GEMM's accumulator (exactly correctable).

``persist=False`` (default) models transient SDC: the fault fires on the
first kernel invocation that matches, then disarms — a recompute rerun
executes clean.  ``persist=True`` models a hard/recurring fault (stuck-at
memory): every rerun re-injects, so the recompute escalation re-detects
and the driver raises ``FtError`` — the graceful-degradation path.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# phase ids shared with the abft kernels
PH_NONE, PH_PANEL, PH_BCAST, PH_TRAIL = 0, 1, 2, 3
_PHASES = {"panel": PH_PANEL, "bcast": PH_BCAST, "trailing": PH_TRAIL}
# corruption modes
MODE_ZERO, MODE_SCALE, MODE_FLIP = 1, 2, 3

# fixed spec capacity: the spec always carries MAX_FAULTS slots (slate_tpu's
# compiled kernels take one fixed shape; the port keeps the same limit)
MAX_FAULTS = 2
# int spec columns: [active, k, phase, ti, tj, r, c, mode]
_ICOLS = 8


@dataclass
class Fault:
    op: str  # "gemm" | "potrf" | "getrf_nopiv" | "trsm" | "her2k"
    k: int  # loop step the fault fires at
    phase: str  # "panel" | "bcast" | "trailing"
    ti: int  # logical tile row of the target
    tj: int  # logical tile column (panel/bcast: the step's column/row)
    r: int  # target mesh row (bcast: the receiving device)
    c: int  # target mesh column
    mode: int = MODE_SCALE
    value: float = 3.0  # scale factor / flip addend
    persist: bool = False  # True = re-inject on every invocation

    def phase_id(self) -> int:
        return _PHASES[self.phase]


@dataclass
class KillFault:
    """Host-level preemption fault: the machine dies at k-loop step ``k``.

    Unlike ``Fault`` (a data corruption lowered into the kernel spec),
    a kill never enters a kernel — the checkpointed drivers
    (``ft/ckpt.py``) consult the active plan between
    segment dispatches and raise ``Preempted``, losing exactly the
    (unsnapshotted) steps a real preemption would.  ``persist=False`` models a one-shot
    preemption: the resumed run executes clean.  ``persist=True``
    re-kills on every resume — the give-up/graceful-rejection path.

    ``in_segment`` is the step-level arm: instead of dying at
    the segment boundary (the segment containing step ``k`` never
    dispatches), the driver dispatches a PARTIAL segment running the
    strict-schedule step helpers up to — but excluding — step ``k`` and
    dies there, exactly as a machine preempted mid-segment would: the
    partial work is real, then lost, and a resume re-executes only the
    steps since the last snapshot (``ft.ckpt_lost_steps``)."""

    op: str  # "potrf" | "getrf_nopiv" | "getrf_pp" | "geqrf" | "he2hb"
    k: int  # loop step the preemption lands on
    persist: bool = False
    in_segment: bool = False  # die mid-segment (partial dispatch) vs at entry


@dataclass
class FaultPlan:
    """An armed set of faults plus the one-shot bookkeeping."""

    faults: List = field(default_factory=list)  # Fault | KillFault
    _spent: set = field(default_factory=set)

    def armed(self, op: str) -> List[Fault]:
        """Armed DATA faults for ``op`` (the kernel-spec class only —
        kill faults never lower into a kernel spec)."""
        return [
            f
            for f in self.faults
            if isinstance(f, Fault)
            and f.op == op
            and (f.persist or id(f) not in self._spent)
        ]

    def armed_kills(self, op: str) -> List[KillFault]:
        """Armed preemption faults for ``op`` (consumed individually by
        the checkpointed driver when they fire, via ``consume_fault``)."""
        return [
            f
            for f in self.faults
            if isinstance(f, KillFault)
            and f.op == op
            and (f.persist or id(f) not in self._spent)
        ]

    def consume(self, op: str) -> None:
        """Mark this op's non-persistent DATA faults as delivered (called
        by the ft driver right after the kernel ran with them armed).
        Kill faults are consumed when they FIRE (``consume_fault``), not
        here: arming a kill next to a data fault must not disarm it just
        because the abft kernel ran first."""
        for f in self.faults:
            if isinstance(f, Fault) and f.op == op and not f.persist:
                self._spent.add(id(f))

    def consume_fault(self, f) -> None:
        """Mark ONE fault delivered (the kill-fault path: the ckpt
        driver consumes the exact kill that fired, so resume runs clean
        while other armed faults stay live)."""
        if not f.persist:
            self._spent.add(id(f))


_tls = threading.local()


def current_plan() -> Optional[FaultPlan]:
    return getattr(_tls, "plan", None)


@contextlib.contextmanager
def fault_scope(plan: Optional[FaultPlan]):
    """Activate ``plan`` for every ft driver call in the dynamic scope.
    Nesting replaces (does not merge) the active plan."""
    old = current_plan()
    _tls.plan = plan
    try:
        yield plan
    finally:
        _tls.plan = old


def spec_arrays(op: str, dtype=np.float64) -> Tuple[np.ndarray, np.ndarray]:
    """Lower the active plan to the kernel spec: ints (MAX_FAULTS, 7)
    int32 + values (MAX_FAULTS,) float.  Disarmed slots are all-zero
    (active=0) — the hooks skip them, exact no-ops."""
    ints = np.zeros((MAX_FAULTS, _ICOLS), np.int32)
    vals = np.zeros((MAX_FAULTS,), dtype)
    plan = current_plan()
    if plan is None:
        return ints, vals
    armed = plan.armed(op)
    if len(armed) > MAX_FAULTS:
        # never silently drop planned faults: the kernel spec has a fixed
        # capacity, and consume() would mark the dropped ones spent — a
        # test asserting n-fault behavior must fail loudly, not vacuously
        raise ValueError(
            f"FaultPlan arms {len(armed)} faults for {op!r}; the kernel "
            f"spec carries at most MAX_FAULTS={MAX_FAULTS}"
        )
    for s, f in enumerate(armed):
        ints[s] = (1, f.k, f.phase_id(), f.ti, f.tj, f.r, f.c, f.mode)
        vals[s] = f.value
    return ints, vals


def consume(op: str) -> None:
    plan = current_plan()
    if plan is not None:
        plan.consume(op)


def armed_kills(op: str) -> List[KillFault]:
    """Armed preemption faults for ``op`` in the active plan (empty when
    no plan is active — the common case: one thread-local read)."""
    plan = current_plan()
    return plan.armed_kills(op) if plan is not None else []


def seeded_kill(seed: int, op: str, nt: int, persist: bool = False,
                in_segment: bool = False) -> KillFault:
    """One deterministic preemption for ``op`` on an ``nt``-step loop:
    the kill step is drawn in [1, nt) so at least one step of work
    precedes it (a kill at step 0 is just 'never started').  Same seed →
    same step, so a kill/resume test is exactly reproducible.
    ``in_segment`` arms the step-level (mid-segment) form."""
    if nt < 2:
        raise ValueError(f"seeded_kill needs nt >= 2 (got {nt})")
    rng = np.random.default_rng(seed)
    return KillFault(op, int(rng.integers(1, nt)), persist, in_segment)


def seeded_fault(
    seed: int,
    op: str,
    nt: int,
    grid: Tuple[int, int],
    phase: Optional[str] = None,
    persist: bool = False,
) -> Fault:
    """One deterministic fault for ``op`` on an ``nt``-step loop over a
    (p, q) mesh.  The draw respects each phase's targeting contract:

    - panel: target a finalized panel-column tile (ti > k, tj = k), on
      the owner coordinate — the exactly-correctable store fault.
    - bcast: corrupt the received column-panel copy of tile row ti at
      step k on one (forced row, free column) coordinate.
    - trailing: a live trailing tile (ti, tj) strictly inside the
      not-yet-factored block (ti, tj >= k + 2, so no lookahead-narrow
      slot ambiguity), on its owner coordinate.
    """
    rng = np.random.default_rng(seed)
    p, q = grid
    if phase is None:
        # gemm has no stored panel: its phases are bcast / trailing
        phase = str(rng.choice(
            ["bcast", "trailing"] if op == "gemm" else list(_PHASES)
        ))
    if op == "gemm" and phase == "panel":
        raise ValueError("gemm has no panel-store phase; use bcast or trailing")
    if nt < 4:
        raise ValueError(f"seeded_fault needs nt >= 4 (got {nt})")
    mode = int(rng.choice([MODE_ZERO, MODE_SCALE, MODE_FLIP]))
    value = float(rng.choice([2.0, 3.0, 1e3]))
    if phase == "panel":
        k = int(rng.integers(0, nt - 1))
        ti = int(rng.integers(k + 1, nt))
        return Fault(op, k, phase, ti, k, ti % p, k % q, mode, value, persist)
    if phase == "bcast":
        k = int(rng.integers(0, nt - 1))
        ti = int(rng.integers(k + 1, nt))
        # receiving column: free for gemm (every column's C tiles consume
        # the panel); for factorizations pin the column that owns tile
        # (ti, ti) — elsewhere the trailing mask can swallow the corrupted
        # slot entirely, making the fault a (correctly undetected) no-op
        fc = int(rng.integers(0, q)) if op == "gemm" else ti % q
        return Fault(op, k, phase, ti, k, ti % p, fc, mode, value, persist)
    k = int(rng.integers(0, nt - 2))
    ti = int(rng.integers(k + 2, nt))
    tj = int(rng.integers(k + 2, nt))
    if op == "potrf" and ti < tj:
        ti, tj = tj, ti  # Cholesky's upper triangle is dead storage:
        # a fault there never reaches the factor (harmless, undetected)
    return Fault(op, k, "trailing", ti, tj, ti % p, tj % q, mode, value, persist)
