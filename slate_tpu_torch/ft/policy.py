"""Fault-tolerance policy, error type and counters.

Counterpart of ``slate_tpu/ft/policy.py``: the same policy values, error
type, report and ``ft.*`` counter keys, counted in the port's own
``obs.REGISTRY``.

``FtPolicy`` is the per-op knob (``Option.FaultTolerance``):

- ``off``: the plain kernels run untouched — bitwise-identical results.
- ``detect``: checksum-carrying kernels; a detected inconsistency is
  fail-stop (``FtError`` with the located damage).
- ``correct``: try the algebraic locate-and-correct first (exact for any
  single-tile fault in GEMM output and for faults in finalized factor
  tiles); escalate to one full recompute when the corruption fed later
  steps; ``FtError`` when the recompute also verifies dirty
  (multi-tile / persistent corruption).
- ``recompute``: skip the algebra — any detection triggers one full
  recompute, then ``FtError`` if still dirty.

Detections / corrections land in the obs metrics registry as ``ft.*``
counters (tagged with the op name) and the RunReport's ``ft`` section;
``python -m slate_tpu_torch.ft.smoke`` prints them in its JSON line and
writes its RunReport.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Optional

from ..types import Option, Options, SlateError, get_option


class FtPolicy(enum.Enum):
    Off = "off"
    Detect = "detect"
    Correct = "correct"
    Recompute = "recompute"


class FtError(SlateError):
    """Structured ABFT failure: corruption was detected but could not be
    (or per policy, was not to be) repaired.  Carries the located damage
    so callers can log / re-dispatch."""

    def __init__(self, op: str, reason: str, detections: Optional[List[dict]] = None):
        self.op = op
        self.reason = reason
        self.detections = list(detections or [])
        where = "; ".join(
            f"{d.get('kind', '?')}@{d.get('where', '?')}" for d in self.detections
        ) or "unlocated"
        super().__init__(f"ft[{op}]: {reason} ({where})")


@dataclass
class FtReport:
    """Per-call outcome the rich ft drivers return next to their result.

    ``action`` is one of ``clean | corrected | recomputed``; a run that
    raises ``FtError`` produces no report.  ``detections`` lists dicts
    with ``kind`` (row/col/tile), ``where`` (tile coordinates) and the
    discrepancy magnitude."""

    op: str
    action: str = "clean"
    detections: List[dict] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return self.action == "clean" and not self.detections


def resolve_policy(opts: Optional[Options]) -> FtPolicy:
    """``Option.FaultTolerance`` from an ``opts`` mapping.  Accepts the
    enum or its string value; absent / None means ``off`` (the plain
    kernels — FT is a strict opt-in, matching the reference's stance that
    resilience features never tax the default path)."""
    raw: Any = get_option(opts, Option.FaultTolerance, default=FtPolicy.Off)
    if raw is None:
        return FtPolicy.Off
    if isinstance(raw, FtPolicy):
        return raw
    try:
        return FtPolicy(str(raw))
    except ValueError:
        raise ValueError(
            f"Option.FaultTolerance must be one of "
            f"{[p.value for p in FtPolicy]}, got {raw!r}"
        ) from None


# -- counters ----------------------------------------------------------------

_COUNTERS = (
    "ft.detected", "ft.corrected", "ft.recomputed", "ft.uncorrectable",
    # the checkpoint/restart counters of ft/ckpt.py and ft/elastic.py
    "ft.ckpt_snapshots", "ft.ckpt_snapshot_bytes", "ft.ckpt_kills",
    "ft.ckpt_lost_steps", "ft.ckpt_resumes", "ft.ckpt_reshards",
    "ft.ckpt_redistribute_bytes", "ft.ckpt_resume_runtime_s",
    "ft.ckpt_async_snapshots", "ft.ckpt_async_overlap_s",
    "ft.ckpt_inseg_kills",
)


def _registry():
    from ..obs import REGISTRY

    return REGISTRY


def count(name: str, op: str, n: float = 1.0) -> None:
    """Bump one ``ft.*`` counter, tagged by op (always on: detection
    events are rare and load-bearing, unlike span timings)."""
    _registry().counter_add(name, n, op=op)


def ft_counter_values() -> dict:
    """Totals of every ``ft.*`` counter across op tags (the ``ft`` section
    of ``slate_tpu``'s RunReport)."""
    snap = _registry().snapshot()
    out = {name.split("ft.", 1)[1]: 0.0 for name in _COUNTERS}
    for entry in snap.get("counters", []):
        if entry["name"] in _COUNTERS:
            out[entry["name"].split("ft.", 1)[1]] += float(entry["value"])
    return out
