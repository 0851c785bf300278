"""Chrome-trace-event / Perfetto JSON export.

Counterpart of ``slate_tpu/obs/perfetto.py`` over the port's two
streams: the span stream (``obs.span.FINISHED``, with each span's absorbed
hop records as instant events and a running link-byte counter) and a
flight timeline (one track
per mesh coordinate, one complete event per row, flow arrows from each
broadcast's owner to its hop destinations).  The output loads in
ui.perfetto.dev or chrome://tracing; ``validate_chrome_trace`` checks the
subset of the format written here.  The memory counter tracks and the
serving tracks come with their slices.

On one card the hop events are the audited schedule of a real p x q mesh:
the virtual-mesh broadcast itself is indexing.
"""

from __future__ import annotations

import json
from typing import Iterable, List, Optional

from . import span as _span

PID = 1
_US = 1e6


def chrome_trace_events(spans: Optional[Iterable[dict]] = None,
                        base: Optional[float] = None) -> List[dict]:
    """Build the traceEvents list of a span stream (default: the finished
    spans), timestamps rebased to ``base`` (default: the first span)."""
    spans = list(_span.FINISHED) if spans is None else list(spans)
    evs: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
         "args": {"name": "slate_tpu"}},
    ]
    if base is None:
        base = min((s["t0"] for s in spans), default=0.0)
    link_total = 0.0
    for s in spans:
        args = dict(s.get("tags", {}))
        args.update({k: v for k, v in s.get("metrics", {}).items()})
        if s.get("parent"):
            args["parent"] = s["parent"]
        evs.append(
            {
                "name": s["name"],
                "cat": "driver",
                "ph": "X",
                "pid": PID,
                "tid": 0,
                "ts": (s["t0"] - base) * _US,
                "dur": max(0.0, (s["t1"] - s["t0"]) * _US),
                "args": args,
            }
        )
        # per-hop LINK byte records absorbed by the span (the comm-audit
        # ppermute hop schedule): one instant per pair with src→dst
        # device args plus a running link-byte counter — instead of
        # silently dropping them from traces.  bytes is the PAIR's share
        # of the hop-set's LINK bytes; pairs_root0 flags in-loop
        # broadcasts (traced owner) whose pairs are the root-0 schedule
        # shape, not owner-resolved devices (the flight exporter rotates
        # them; a span trace has no per-step owner to rotate by).
        for hop in s.get("hops", ()):
            pairs = hop.get("pairs", ())
            per_pair = float(hop.get("bytes", 0)) / max(1, len(pairs))
            root0 = hop.get("step") is None
            for src, dst in pairs:
                evs.append(
                    {
                        "name": hop.get("op", "ppermute"),
                        "cat": "comm",
                        "ph": "i",
                        "s": "t",
                        "pid": PID,
                        "tid": 0,
                        "ts": (s["t0"] - base) * _US,
                        "args": {"src": src, "dst": dst,
                                 "bytes": per_pair,
                                 "mult": hop.get("mult", 1),
                                 "pairs_root0": root0,
                                 "span": s["name"]},
                    }
                )
            link_total += float(hop.get("bytes", 0)) * hop.get("mult", 1)
            evs.append(
                {
                    "name": "ppermute_link_bytes",
                    "cat": "comm",
                    "ph": "C",
                    "pid": PID,
                    "tid": 0,
                    "ts": (s["t1"] - base) * _US,
                    "args": {"bytes": link_total},
                }
            )
    return evs


def chrome_trace(spans: Optional[Iterable[dict]] = None) -> dict:
    return {
        "traceEvents": chrome_trace_events(spans),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "slate_tpu.obs"},
    }


def write_chrome_trace(path: str, spans: Optional[Iterable[dict]] = None) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(spans), f, indent=1)
    return path


def flight_trace_events(events: Iterable[dict],
                        hop_events: Optional[Iterable[dict]] = None,
                        grid: Optional[tuple] = None) -> List[dict]:
    """Per-device Gantt of a flight timeline (obs.flight): one track per
    mesh coordinate, one complete event per fenced phase dispatch, and
    flow arrows (``ph: s``/``f``) from the broadcast owner to each hop
    destination for every recorded hop schedule.

    ``events`` are FlightReport event rows ({op, k, phase, device,
    t0_s, t1_s, bytes, flops}); ``hop_events`` the report's hop_events
    ({op, k, root_k, phase, t0_s, t1_s, hops: [{op, bytes, pairs}]}).
    Axis hop pairs are mesh-axis indices of the root-0 schedule; they are
    rotated by the step's logical broadcast owner (root_k mod axis size —
    root_k == k except for backward solves) and fanned across the OTHER
    axis, so the arrows show the true source→destination devices."""
    events = list(events)
    p, q = grid if grid is not None else (
        1 + max((e["device"][0] for e in events), default=0),
        1 + max((e["device"][1] for e in events), default=0),
    )

    def tid(r, c):
        return 200 + r * q + c

    evs: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
         "args": {"name": "slate_tpu.flight"}},
    ]
    for r in range(p):
        for c in range(q):
            evs.append(
                {"name": "thread_name", "ph": "M", "pid": PID,
                 "tid": tid(r, c), "args": {"name": f"mesh({r},{c})"}}
            )
    for e in events:
        r, c = e["device"]
        evs.append(
            {
                "name": f"{e['phase']} k={e['k']}",
                "cat": "flight",
                "ph": "X",
                "pid": PID,
                "tid": tid(int(r), int(c)),
                "ts": e["t0_s"] * _US,
                "dur": max(0.0, (e["t1_s"] - e["t0_s"]) * _US),
                "args": {"op": e["op"], "k": e["k"], "phase": e["phase"],
                         "bytes": e.get("bytes", 0),
                         "flops": e.get("flops", 0)},
            }
        )
    flow_id = 0
    for he in hop_events or ():
        ts = he["t0_s"] * _US
        te = max(ts, he["t1_s"] * _US)
        for hop in he.get("hops", ()):
            axis = "p" if "[p]" in hop.get("op", "") else "q"
            size = p if axis == "p" else q
            # rotate the root-0 hop schedule by the step's logical
            # broadcast owner (root_k != k only for backward solves)
            rot = he.get("root_k", he["k"]) % size
            for src, dst in hop.get("pairs", ()):
                s_ax, d_ax = (src + rot) % size, (dst + rot) % size
                # fan the axis hop across the other mesh axis (every
                # row/col runs the same rooted schedule)
                other = range(q) if axis == "p" else range(p)
                for o in other:
                    s_rc = (s_ax, o) if axis == "p" else (o, s_ax)
                    d_rc = (d_ax, o) if axis == "p" else (o, d_ax)
                    flow_id += 1
                    common = {"cat": "comm", "name": hop.get("op", "hop"),
                              "pid": PID, "id": flow_id}
                    evs.append(dict(common, ph="s", tid=tid(*s_rc), ts=ts,
                                    args={"src": list(s_rc),
                                          "dst": list(d_rc),
                                          "bytes": hop.get("bytes", 0),
                                          "k": he["k"]}))
                    evs.append(dict(common, ph="f", bp="e", tid=tid(*d_rc),
                                    ts=te, args={}))
    return evs


def flight_chrome_trace(events, hop_events=None, grid=None) -> dict:
    return {
        "traceEvents": flight_trace_events(events, hop_events, grid),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "slate_tpu.obs.flight"},
    }


def validate_chrome_trace(obj) -> List[str]:
    """Schema check for the subset of the trace-event format we emit
    (and that Perfetto requires to load).  Returns a list of problems —
    empty means valid."""
    errs: List[str] = []
    if not isinstance(obj, dict):
        return ["top level must be an object"]
    evs = obj.get("traceEvents")
    if not isinstance(evs, list):
        return ["missing traceEvents list"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(e.get("name"), str) or not e.get("name"):
            errs.append(f"{where}: missing name")
        ph = e.get("ph")
        if ph not in ("X", "B", "E", "M", "i", "C", "s", "f", "t"):
            errs.append(f"{where}: bad ph {ph!r}")
        if ph in ("X", "B", "E", "s", "f", "t"):
            ts = e.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                errs.append(f"{where}: bad ts {ts!r}")
        if ph in ("s", "f", "t") and not isinstance(e.get("id"), (int, str)):
            errs.append(f"{where}: flow event missing id")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: bad dur {dur!r}")
        for k in ("pid", "tid"):
            if ph != "M" and not isinstance(e.get(k), int):
                errs.append(f"{where}: bad {k} {e.get(k)!r}")
    return errs
