"""Static schedule model and critical-path / overlap analyses for the
flight recorder.

Counterpart of ``slate_tpu/obs/schedule.py`` (pure Python over records
and rows, the same code).  ``ScheduleModel`` is the static side: one run
of a mesh driver under ``parallel.comm.sched_audit`` yields every audited
verb of its schedule per phase (``panel`` / ``bcast`` / ``bulk``) with
its bytes -- per-hop link bytes for a rooted broadcast under the hop
lowerings, per-device payload under ``psum``.  The port records every
call (multiplicity 1, concrete step, the owner's pairs) where
``slate_tpu`` records once per traced loop body (the trip count as the
multiplicity), so the per-phase bytes, executions and hops per step are
the same numbers.

The analyses reduce a measured flight timeline (``obs.flight``):

- ``analyze``: exposed communication under the lookahead issue order
  (depth d's step-k broadcast may hide behind the deferred update work of
  steps k-d..k-1 issued after it), ``overlap_eff = 1 - exposed / total``
  (exactly 0 at depth 0) and the critical path ``compute + exposed``;
- ``calibrate``: achieved bytes/s over the ``bcast`` rows and flop/s over
  the rest, which turn the model into per-step predicted times;
- ``hop_latency``: the ring-vs-psum difference of the per-step ``bcast``
  time over the extra hops.

On one card a virtual-mesh broadcast is indexing: a ``bcast`` row's
fenced time is fence and host overhead, not wire time, and
``hop_latency`` is not a link latency.
"""

from __future__ import annotations

from typing import Dict, List, Optional

PHASES = ("panel", "bcast", "bulk")

# phases whose fenced duration is the comm lens; everything else is compute
_COMM_PHASES = ("bcast",)


class ScheduleModel:
    """Static per-step, per-phase communication schedule of one mesh
    kernel, built from ``sched_audit`` records
    ``(op, nbytes, mult, phase, step, pairs)``."""

    def __init__(self, op: str, nt: int, p: int, q: int, impl: str,
                 records: List[tuple]):
        self.op = op
        self.nt = int(nt)
        self.p, self.q = int(p), int(q)
        self.impl = impl
        self.records = list(records)
        self.phase_bytes: Dict[str, float] = {}
        self.phase_execs: Dict[str, float] = {}
        for rec_op, nbytes, mult, phase, _step, _pairs in self.records:
            ph = phase if phase in PHASES else "bcast"
            self.phase_bytes[ph] = (self.phase_bytes.get(ph, 0.0)
                                    + float(nbytes) * mult)
            self.phase_execs[ph] = self.phase_execs.get(ph, 0.0) + mult
        self.total_bytes = sum(self.phase_bytes.values())

    @property
    def hop_records(self) -> List[tuple]:
        """The ppermute hop records (pairs present): the per-hop LINK
        byte attribution the Perfetto exporter renders as flow events."""
        return [r for r in self.records if r[5]]

    def hops_per_step(self) -> float:
        """Mean number of point-to-point hop executions per k-step (ring:
        s-1 per rooted broadcast; psum lowering: one collective per
        broadcast, counted from its psum records)."""
        if self.nt <= 0:
            return 0.0
        total = 0.0
        for rec_op, _nb, mult, _ph, _st, pairs in self.records:
            if rec_op.startswith("ppermute") or rec_op.startswith("psum"):
                total += mult
        return total / self.nt

    def steps(self, calibration: Optional[dict] = None,
              flops_by_phase: Optional[Dict[str, float]] = None
              ) -> List[dict]:
        """Uniform per-step model rows: per-step bytes are total / nt (the
        mean over the steps; the bucketed windows shrink them).  With a calibration, each row gains
        ``predicted_s`` = bytes/B + flops/F."""
        if self.nt <= 0:
            return []
        rows = []
        bps = (calibration or {}).get("bytes_per_s") or 0.0
        fps = (calibration or {}).get("flops_per_s") or 0.0
        for k in range(self.nt):
            for ph in PHASES:
                nbytes = self.phase_bytes.get(ph, 0.0) / self.nt
                flops = (flops_by_phase or {}).get(ph, 0.0) / self.nt
                row = {"k": k, "phase": ph, "bytes": nbytes, "flops": flops}
                pred = 0.0
                if bps > 0:
                    pred += nbytes / bps
                if fps > 0:
                    pred += flops / fps
                row["predicted_s"] = pred
                rows.append(row)
        return rows


# ---------------------------------------------------------------------------
# Measured-timeline reductions
# ---------------------------------------------------------------------------


def rows_from_events(events) -> List[dict]:
    """Collapse per-device StepEvents to one row per fenced dispatch:
    group by (op, k, phase, t0) — the host fence stamps every device of
    one dispatch identically — summing the per-device byte/flop shares
    back to phase totals.  Rows come out in dispatch (issue) order."""
    groups: Dict[tuple, dict] = {}
    order: List[tuple] = []
    for e in events:
        key = (e.op, e.k, e.phase, e.t0)
        g = groups.get(key)
        if g is None:
            g = groups[key] = {"op": e.op, "k": e.k, "phase": e.phase,
                               "t0": e.t0, "t1": e.t1, "dur": e.t1 - e.t0,
                               "bytes": 0.0, "flops": 0.0}
            order.append(key)
        g["bytes"] += e.bytes
        g["flops"] += e.flops
    return [groups[k] for k in order]


def phase_flops(rows) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in rows:
        out[r["phase"]] = out.get(r["phase"], 0.0) + r["flops"]
    return out


def calibrate(rows) -> Dict[str, float]:
    """Measured roofline constants from a flight timeline: achieved
    bytes/s over the bcast phases, achieved flop/s over the compute
    phases (panel + bulk).  Zero when the timeline carries no bytes or
    flops (e.g. a 1-device mesh)."""
    comm_t = comm_b = comp_t = comp_f = 0.0
    for r in rows:
        if r["phase"] in _COMM_PHASES:
            comm_t += r["dur"]
            comm_b += r["bytes"]
        else:
            comp_t += r["dur"]
            comp_f += r["flops"]
    return {
        "bytes_per_s": comm_b / comm_t if comm_t > 0 and comm_b > 0 else 0.0,
        "flops_per_s": comp_f / comp_t if comp_t > 0 and comp_f > 0 else 0.0,
    }


def analyze(rows, depth: int) -> Dict[str, float]:
    """Critical-path / overlap reduction of one measured timeline.

    Exposed communication: a step-k broadcast issued with lookahead
    depth d can hide behind exactly the update work dispatched AFTER its
    issue that belongs to steps [k-d, k) — the deferred bulk of the
    pipeline slot it was issued into.  Depth 0 exposes every broadcast
    by definition (the strict schedule has nothing independent in
    flight), so ``overlap_eff`` is exactly 0 there; depth >= 1 yields
    ``1 - exposed/total_comm`` in (0, 1] whenever the hidden-behind bulk
    work is nonzero.  ``critical_path_s`` = total compute + exposed
    comm: compute is always on the dense schedule's critical path, and
    communication contributes only its exposed part."""
    d = max(0, int(depth))
    bcast_rows = [r for r in rows if r["phase"] in _COMM_PHASES]
    comp_rows = [r for r in rows if r["phase"] not in _COMM_PHASES]
    total_comm = sum(r["dur"] for r in bcast_rows)
    total_compute = sum(r["dur"] for r in comp_rows)
    # each second of bulk work can hide at most one second of broadcast:
    # consume per-row capacity in issue order so overlapping hide windows
    # at depth >= 2 (bcast k and k+1 both spanning bulk k-1) never credit
    # the same update twice
    bulk_rows = [r for r in comp_rows if r["phase"] == "bulk"]
    capacity = [r["dur"] for r in bulk_rows]
    exposed = 0.0
    for br in sorted(bcast_rows, key=lambda r: (r["t0"], r["k"])):
        k = br["k"]
        if d == 0:
            exposed += br["dur"]
            continue
        need = br["dur"]
        for i, r in enumerate(bulk_rows):
            if need <= 0.0:
                break
            if k - d <= r["k"] < k and r["t0"] >= br["t0"] and capacity[i] > 0:
                take = min(capacity[i], need)
                capacity[i] -= take
                need -= take
        exposed += max(0.0, need)
    overlap = 0.0
    if total_comm > 0:
        overlap = min(1.0, max(0.0, 1.0 - exposed / total_comm))
    t0 = min((r["t0"] for r in rows), default=0.0)
    t1 = max((r["t1"] for r in rows), default=0.0)
    nt = 1 + max((r["k"] for r in rows), default=0)
    return {
        "critical_path_s": total_compute + exposed,
        "overlap_eff": overlap,
        "exposed_comm_s": exposed,
        "total_comm_s": total_comm,
        "total_compute_s": total_compute,
        "wall_s": t1 - t0,
        "measured_bytes": sum(r["bytes"] for r in rows),
        "steps": nt,
        "depth": d,
    }


def hop_latency(rows_ring, rows_psum, model_ring: ScheduleModel,
                model_psum: Optional[ScheduleModel] = None
                ) -> Optional[float]:
    """Per-hop latency estimate from the ring-vs-psum delta.

    Both lowerings move the same panels per step; the ring pipeline pays
    (s-1) sequential point-to-point launches where the all-reduce pays
    ~one collective launch per broadcast.  The per-step mean bcast-time
    difference divided by the extra hop count estimates per-hop
    launch+wire latency.  Returns None when the delta is not resolvable
    (fewer ring hops than psum collectives, or no bcast rows)."""

    nt = max(1, model_ring.nt)

    def per_step(rows):
        durs = [r["dur"] for r in rows if r["phase"] in _COMM_PHASES]
        return sum(durs) / nt if durs else None

    ring_t, psum_t = per_step(rows_ring), per_step(rows_psum)
    if ring_t is None or psum_t is None:
        return None
    hops_ring = model_ring.hops_per_step()
    # without a psum model, assume one collective launch per rooted
    # broadcast — two broadcasts per k-step in every routed kernel
    hops_psum = (model_psum.hops_per_step() if model_psum is not None
                 else 2.0)
    extra = hops_ring - hops_psum
    if extra <= 0:
        return None
    return max(0.0, (ring_t - psum_t) / extra)
