"""Chrome-trace-event / Perfetto JSON export.

Counterpart of ``slate_tpu/obs/perfetto.py`` over the port's two
streams: the span stream (``obs.span.FINISHED``, with each span's absorbed
hop records as instant events and a running link-byte counter) and a
flight timeline (one track
per mesh coordinate, one complete event per row, flow arrows from each
broadcast's owner to its hop destinations).  The output loads in
ui.perfetto.dev or chrome://tracing; ``validate_chrome_trace`` checks the
subset of the format written here.  The ``obs.memory`` samples render as
counter tracks (``memory_counter_events``) beside both the span Gantt and a
flight Gantt, and a refinement trajectory as the ``num.ir_rnorm`` /
``num.ir_xnorm`` counter tracks (``numerics_counter_events``), and the
serving layer's finished request traces as one track per accuracy class
(``request_trace_events``), alone or on one timebase with the spans, the
memory track and a flight Gantt (``unified_trace_events``).

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
    # the obs.memory samples taken at top-level span exits, as counter
    # tracks beside the span Gantt (a sys.modules probe: a run that never
    # sampled never imports the memory layer)
    import sys as _sys

    _mem = _sys.modules.get(__package__ + ".memory")
    if _mem is not None and _mem.SAMPLES:
        mbase = base if spans else min(s["t"] for s in _mem.SAMPLES)
        evs.extend(memory_counter_events(_mem.SAMPLES, mbase))
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


def memory_counter_events(samples: Iterable[dict], base: float = 0.0,
                          tid: int = 0, time_key: str = "t") -> List[dict]:
    """Counter events (``ph: "C"``) from obs.memory samples: one
    ``mem.live_bytes`` series plus one ``mem.bytes_in_use[<device>]``
    series per device that reports allocator stats and one
    ``mem.live_bytes[<device>]`` per device of the live walk.
    ``time_key`` selects absolute perf_counter stamps (``"t"``, rebased by
    ``base``) or already-relative seconds (``"t_s"``, flight reports)."""
    evs: List[dict] = []
    for s in samples:
        t = s.get(time_key)
        if t is None:
            continue
        ts = max(0.0, (float(t) - (base if time_key == "t" else 0.0))) * _US
        attr = {k: s[k] for k in ("trace_id", "tenant") if s.get(k)}
        evs.append({"name": "mem.live_bytes", "cat": "mem", "ph": "C", "pid": PID, "tid": tid,
                    "ts": ts, "args": {"bytes": s.get("live_bytes", 0.0), **attr}})
        for dev, b in sorted((s.get("bytes_in_use") or {}).items()):
            evs.append({"name": f"mem.bytes_in_use[{dev}]", "cat": "mem", "ph": "C", "pid": PID,
                        "tid": tid, "ts": ts, "args": {"bytes": b, **attr}})
        for dev, b in sorted((s.get("live_per_device") or {}).items()):
            evs.append({"name": f"mem.live_bytes[{dev}]", "cat": "mem", "ph": "C", "pid": PID,
                        "tid": tid, "ts": ts, "args": {"bytes": b, **attr}})
    return evs


def numerics_counter_events(history, op: str = "", tid: int = 0,
                            t0: float = 0.0, dt: float = 1e-3) -> List[dict]:
    """Counter events (``ph: "C"``) of a refinement trajectory
    (``obs.numerics.last_history``): one ``num.ir_rnorm[op]`` and one
    ``num.ir_xnorm[op]`` series, one sample per iteration, ``dt`` seconds
    apart from ``t0`` (the trajectory is ordinal, the spacing
    presentational)."""
    evs: List[dict] = []
    suffix = f"[{op}]" if op else ""
    for i, (rn, xn) in enumerate(history):
        ts = (t0 + i * dt) * _US
        evs.append({"name": f"num.ir_rnorm{suffix}", "cat": "num", "ph": "C", "pid": PID,
                    "tid": tid, "ts": ts, "args": {"rnorm": rn}})
        evs.append({"name": f"num.ir_xnorm{suffix}", "cat": "num", "ph": "C", "pid": PID,
                    "tid": tid, "ts": ts, "args": {"xnorm": xn}})
    return evs


def flight_trace_events(events: Iterable[dict],
                        hop_events: Optional[Iterable[dict]] = None,
                        grid: Optional[tuple] = None,
                        mem_samples: Optional[Iterable[dict]] = None) -> List[dict]:
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
    # the memory counter track beside the Gantt: the flight's samples carry
    # report-relative t_s stamps
    if mem_samples:
        evs.extend(memory_counter_events(mem_samples, tid=199, time_key="t_s"))
    return evs


def flight_chrome_trace(events, hop_events=None, grid=None, mem_samples=None) -> dict:
    return {
        "traceEvents": flight_trace_events(events, hop_events, grid, mem_samples),
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


def request_trace_events(traces, base: Optional[float] = None) -> List[dict]:
    """Per-request serving timelines: one track per ACCURACY
    CLASS (the condest-keyed friendly/hostile partition is the SLA
    partition, so a class's track is its latency story at a glance), one
    complete event per request phase (admission → classify →
    cache_lookup → factor → solve plus the degradation phases), and flow
    arrows chaining retry → resume → the final phase of every request
    that consumed the degradation ladder.

    ``traces`` are finished ``serve.trace.RequestTrace`` objects; phase
    timestamps are perf_counter absolutes rebased to the earliest
    request start (or to ``base`` when given — the unified export passes
    a timebase shared with the span/mem tracks)."""
    traces = [t for t in traces if t is not None]
    classes = sorted({t.klass or "friendly" for t in traces})
    tid_of = {kl: 300 + i for i, kl in enumerate(classes)}
    evs: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
         "args": {"name": "slate_tpu.serve"}},
    ]
    for kl in classes:
        evs.append(
            {"name": "thread_name", "ph": "M", "pid": PID,
             "tid": tid_of[kl], "args": {"name": f"serve[{kl}]"}}
        )
    if base is None:
        base = min((t.t0 for t in traces), default=0.0)
    flow_id = 50_000
    for t in traces:
        tid = tid_of[t.klass or "friendly"]
        phases = sorted(t.phases, key=lambda ph: (ph["t0"], -ph["t1"]))
        for ph in phases:
            args = {"rid": t.rid, "op": t.op, "n": t.n,
                    "outcome": t.outcome, "phase": ph["name"],
                    "depth": ph["depth"],
                    "trace_id": getattr(t, "trace_id", "")}
            if getattr(t, "tenant", None):
                args["tenant"] = t.tenant
            if ph["parent"]:
                args["parent"] = ph["parent"]
            args.update({k: str(v) for k, v in ph.get("meta", {}).items()})
            evs.append(
                {
                    "name": f"{t.op}#{t.rid} {ph['name']}",
                    "cat": "serve",
                    "ph": "X",
                    "pid": PID,
                    "tid": tid,
                    "ts": (ph["t0"] - base) * _US,
                    "dur": max(0.0, (ph["t1"] - ph["t0"]) * _US),
                    "args": args,
                }
            )
        # flow arrows retry -> resume -> final: chain every top-level
        # degradation phase to the next, ending at the phase that
        # finished last (the terminal dispatch the ladder carried the
        # request to)
        degr = sorted((ph for ph in t.phases
                       if ph["name"] in ("retry", "resume")),
                      key=lambda ph: ph["t0"])
        rest = [ph for ph in t.phases if ph not in degr]
        if degr and rest:
            # the final dispatch the ladder carried the request to: the
            # last-closing non-ladder phase (typically its solve)
            final = max(rest, key=lambda ph: ph["t1"])
            chain = degr + [final]
            for a, b in zip(chain, chain[1:]):
                flow_id += 1
                common = {"cat": "serve", "pid": PID, "id": flow_id,
                          "name": f"{t.op}#{t.rid} ladder"}
                evs.append(dict(common, ph="s", tid=tid,
                                ts=(a["t0"] - base) * _US,
                                args={"from": a["name"], "to": b["name"],
                                      "rid": t.rid}))
                evs.append(dict(common, ph="f", bp="e", tid=tid,
                                ts=(b["t0"] - base) * _US, args={}))
    return evs


def request_chrome_trace(traces) -> dict:
    return {
        "traceEvents": request_trace_events(traces),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "slate_tpu.serve.trace"},
    }


def write_request_trace(path: str, traces) -> str:
    with open(path, "w") as f:
        json.dump(request_chrome_trace(traces), f, indent=1)
    return path


def unified_trace_events(
    traces,
    spans: Optional[Iterable[dict]] = None,
    flight_events: Optional[Iterable[dict]] = None,
    flight_hop_events: Optional[Iterable[dict]] = None,
    grid: Optional[tuple] = None,
) -> List[dict]:
    """ONE trace per serving run: the request track
    (tid 300+), the driver-span Gantt + absorbed hop instants (tid 0),
    the memory counter track, and optionally a flight-recorder Gantt
    (tid 200+) — all on one shared perf_counter timebase, with
    ``trace_id`` flow arrows tying each request's track event to every
    driver span it dispatched.  Request phases, spans and mem samples
    all stamp perf_counter absolutes, so the shared base is just their
    minimum; flight events carry report-relative stamps and keep their
    own zero (their correlation is the trace_id in the args, not the
    clock).

    ``traces`` are finished RequestTrace objects; ``spans`` defaults to
    the finished span stream (whose tags already carry trace_id/tenant
    when recorded under a request's TraceContext — obs/span.py)."""
    import sys as _sys

    traces = [t for t in traces if t is not None]
    spans = list(_span.FINISHED) if spans is None else list(spans)
    _mem = _sys.modules.get(__package__ + ".memory")
    mem_samples = list(_mem.SAMPLES) if _mem is not None else []
    bases = ([t.t0 for t in traces] + [s["t0"] for s in spans]
             + [float(s["t"]) for s in mem_samples if s.get("t") is not None])
    base = min(bases, default=0.0)

    evs: List[dict] = list(request_trace_events(traces, base=base))
    # the span/mem half: chrome_trace_events appends the mem counter
    # track itself (same sys.modules probe), on the same shared base
    evs.extend(e for e in chrome_trace_events(spans, base=base)
               if e.get("ph") != "M" or e.get("name") != "process_name")
    if flight_events:
        evs.extend(e for e in flight_trace_events(
            flight_events, flight_hop_events, grid)
            if e.get("ph") != "M" or e.get("name") != "process_name")
    # trace_id flow arrows: one arrow per (request, dispatched span) —
    # ph "s" anchored at the request's first phase on its class track,
    # ph "f" at the span on the driver track.  This is the correlation
    # the UI renders; the args carry the id for machine consumers.
    tid_of = {e["args"]["name"]: e["tid"] for e in evs
              if e.get("ph") == "M" and e.get("name") == "thread_name"}
    span_evs = [e for e in evs
                if e.get("cat") == "driver" and e.get("ph") == "X"
                and (e.get("args") or {}).get("trace_id")]
    flow_id = 90_000
    for t in traces:
        tr_id = getattr(t, "trace_id", "")
        if not tr_id or not t.phases:
            continue
        klass = t.klass or "friendly"
        rtid = tid_of.get(f"serve[{klass}]", 300)
        ts0 = (min(ph["t0"] for ph in t.phases) - base) * _US
        for se in span_evs:
            if se["args"].get("trace_id") != tr_id:
                continue
            flow_id += 1
            common = {"cat": "traceflow", "pid": PID, "id": flow_id,
                      "name": f"trace:{tr_id[:8]}"}
            evs.append(dict(common, ph="s", tid=rtid, ts=max(0.0, ts0),
                            args={"trace_id": tr_id, "rid": t.rid,
                                  "span": se["name"]}))
            evs.append(dict(common, ph="f", bp="e", tid=se["tid"],
                            ts=se["ts"], args={"trace_id": tr_id}))
    evs.insert(0, {"name": "process_name", "ph": "M", "pid": PID, "tid": 0,
                   "args": {"name": "slate_tpu.unified"}})
    return evs


def unified_chrome_trace(traces, spans=None, flight_events=None,
                         flight_hop_events=None, grid=None) -> dict:
    return {
        "traceEvents": unified_trace_events(traces, spans, flight_events,
                                            flight_hop_events, grid),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "slate_tpu.obs.unified"},
    }


def write_unified_trace(path: str, traces, spans=None, flight_events=None,
                        flight_hop_events=None, grid=None) -> str:
    with open(path, "w") as f:
        json.dump(unified_chrome_trace(traces, spans, flight_events,
                                       flight_hop_events, grid), f, indent=1)
    return path
