"""The live telemetry bus, the scrape endpoint and the RunReport ledger.

Counterpart of ``slate_tpu/obs/live.py``, with its names, event kinds,
endpoints, Prometheus families and ledger file names:

- **TelemetryBus** -- a bounded ring buffer of telemetry events.  Spans
  (``obs.span``), finished requests (``serve.trace``), memory samples
  (``obs.memory``), window closes (``serve.queue``) and controller
  actuations (``serve.controller``) publish to it through a ``sys.modules``
  probe, so a process that never imports this module pays nothing.
- **Scrape endpoint** -- ``python -m slate_tpu_torch.obs.live`` serves the
  live registry over stdlib http on ``127.0.0.1``: ``/metrics``
  (Prometheus exposition text), ``/snapshot.json``, ``/events.json`` (the
  bus ring, ``?since=SEQ`` to tail), ``/queue.json`` (the batch-window
  queues' live stats) and ``/healthz`` (with the queues' liveness when the
  service layer is loaded).  The Prometheus formatter here is the only one:
  ``serve.stats`` delegates to it.
- **RunReport ledger** -- ``ledger_append`` writes reports into a rotating
  directory (``artifacts/obs_torch/ledger/``, the oldest pruned past the
  cap), each stamped with the emitting trace_id; ``obs.report --trend``
  reads it with ``ledger_load``.
- **``--ci``** -- the acceptance run: the endpoint on an ephemeral port, a
  small two-tenant Router workload (meshless, plus one checkpointed and
  monitored gesv on the virtual 2 x 4 mesh), one scrape that must be
  validator-clean and carry the ``serve`` / ``sched`` / ``mem`` / ``num``
  families, the unified Perfetto trace (>= 3 track kinds correlated by one
  request's trace_id) and a fresh ledger entry.

The device defaults to the card (``--device cuda``); on the CPU pass
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .metrics import REGISTRY

_PREFIX = "slate_tpu_serve"

# metric-name prefixes one scrape surfaces: latency, schedule, residency and
# health in one exposition
_SCRAPE_PREFIXES = ("serve.", "sched.", "num.", "ir.", "mem.")


def sanitize_key(name: str) -> str:
    """Report- and Prometheus-safe metric-name fragment: the one naming rule
    of every exposition (the live scrape, ``serve.stats``, the flat report
    keys)."""
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


# ---------------------------------------------------------------------------
# the bus
# ---------------------------------------------------------------------------


class TelemetryBus:
    """Bounded ring buffer of telemetry events.  Thread-safe; a producer
    never blocks and never fails: when the ring is full the oldest event
    falls off (``dropped`` counts them)."""

    def __init__(self, cap: int = 4096) -> None:
        self.cap = int(cap)
        self._ring: deque = deque(maxlen=self.cap)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0

    def publish(self, kind: str, data: dict) -> int:
        """Append one event; returns its sequence number (monotonic over the
        bus's life, so a consumer tails with ``since``)."""
        with self._lock:
            self._seq += 1
            if len(self._ring) == self.cap:
                self.dropped += 1
            self._ring.append({"seq": self._seq, "t": time.time(), "kind": kind, "data": data})
            return self._seq

    def events(self, since: int = 0, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            evs = [e for e in self._ring if e["seq"] > since]
        return evs[-limit:] if limit else evs

    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


BUS = TelemetryBus()


def publish(kind: str, data: dict) -> int:
    """The hook the producers call through their ``sys.modules`` probe."""
    return BUS.publish(kind, data)


# ---------------------------------------------------------------------------
# snapshot and Prometheus exposition (serve.stats delegates here)
# ---------------------------------------------------------------------------


def stats_snapshot() -> dict:
    """JSON-able snapshot of the live telemetry surface: the flat serve
    counters with the SLA reduction merged in, the ``num`` and ``mem``
    totals, and every scrape-prefixed series of the shared registry."""
    from ..serve import trace as _trace
    from ..serve.metrics import serve_counter_values
    from . import numerics as _numerics
    from .memory import mem_counter_values

    snap = REGISTRY.snapshot()
    scrape_metrics = {
        kind: [e for e in entries if str(e.get("name", "")).startswith(_SCRAPE_PREFIXES)]
        for kind, entries in snap.items()
    }
    # all-zero sections (nothing monitored or sampled) stay out, as in the
    # RunReport
    num = _numerics.num_counter_values()
    mem = mem_counter_values()
    return {
        "serve": serve_counter_values(),
        "sla": _trace.sla_values(),
        "num": (num if any(num.values()) else {}),
        "mem": (mem if any(mem.values()) else {}),
        "finished_requests": len(_trace.finished_traces()),
        "bus": {"events": len(BUS), "last_seq": BUS.last_seq(), "dropped": BUS.dropped},
        "metrics": scrape_metrics,
    }


def _fmt_tags(tags: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    items = dict(tags or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{sanitize_key(k)}="{v}"' for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(snapshot: Optional[dict] = None) -> str:
    """Prometheus exposition text of a ``stats_snapshot()`` (taken live when
    not given).  Rows are grouped per metric name under exactly one
    ``# TYPE`` header: the tag sets of one metric are one family, and a
    repeated TYPE line is a parse error."""
    snap = snapshot if snapshot is not None else stats_snapshot()
    # family name -> (kind, [sample rows]), in insertion order
    families: Dict[str, tuple] = {}

    def emit(name: str, kind: str, rows) -> None:
        families.setdefault(name, (kind, []))[1].extend(rows)

    # the flat serve counters and SLA keys: the RunReport's serve section
    for key, val in sorted((snap.get("serve") or {}).items()):
        name = f"{_PREFIX}_{sanitize_key(key)}"
        emit(name, "gauge" if "latency" in key or "rate" in key else "counter",
             [f"{name} {val:.10g}"])
    # the num totals: worst-case gauges are gauges, event totals counters
    for key, val in sorted((snap.get("num") or {}).items()):
        name = f"slate_tpu_num_{sanitize_key(key)}"
        kind = ("gauge" if any(t in key for t in ("_max", "_min", "margin", "cond", "_s"))
                else "counter")
        emit(name, kind, [f"{name} {val:.10g}"])
    # the mem totals: sampled maxima are gauges, event totals counters
    for key, val in sorted((snap.get("mem") or {}).items()):
        name = f"slate_tpu_mem_{sanitize_key(key)}"
        kind = "gauge" if ("_max" in key or "bytes" in key) else "counter"
        emit(name, kind, [f"{name} {val:.10g}"])
    # flat sched.* keys (a formatted FlightReport's values; a live registry
    # carries its sched series below instead)
    for key, val in sorted((snap.get("sched") or {}).items()):
        name = f"slate_tpu_{sanitize_key(key)}"
        emit(name, "gauge", [f"{name} {val:.10g}"])
    # the registry's tagged series
    m = snap.get("metrics") or {}
    for e in m.get("counters", []):
        name = f"slate_tpu_{sanitize_key(e['name'])}_total"
        emit(name, "counter", [f"{name}{_fmt_tags(e.get('tags'))} {e['value']:.10g}"])
    for e in m.get("gauges", []):
        name = f"slate_tpu_{sanitize_key(e['name'])}"
        emit(name, "gauge", [f"{name}{_fmt_tags(e.get('tags'))} {e['value']:.10g}"])
    for e in m.get("histograms", []):
        name = f"slate_tpu_{sanitize_key(e['name'])}"
        rows = [f"{name}_count{_fmt_tags(e.get('tags'))} {e['count']}",
                f"{name}_sum{_fmt_tags(e.get('tags'))} {e['sum']:.10g}"]
        for label, qkey in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            qv = e.get(qkey)
            if qv is not None:
                rows.append(f"{name}{_fmt_tags(e.get('tags'), {'quantile': label})} {qv:.10g}")
        emit(name, "summary", rows)
    lines: List[str] = []
    for name, (kind, rows) in families.items():
        lines.append(f"# TYPE {name} {kind}")
        lines.extend(rows)
    return "\n".join(lines) + "\n"


def snapshot_from_report(rep: dict) -> dict:
    """The stats surface of a RunReport or FlightReport (the offline twin of
    the live snapshot): the serve section, the num / mem sections and any
    ``num.*`` / ``sched.*`` headline values."""
    metrics = rep.get("metrics") or {}
    values = rep.get("values") or {}
    num = dict(rep.get("num") or {})
    num.update({k[len("num."):]: v for k, v in values.items()
                if isinstance(v, (int, float)) and k.startswith("num.")})
    sched = {k: v for k, v in values.items()
             if isinstance(v, (int, float)) and k.startswith("sched.")}
    return {
        "serve": dict(rep.get("serve") or {}),
        "sla": {k: v for k, v in (rep.get("serve") or {}).items()
                if k.startswith(("latency_", "outcome_"))},
        "num": num,
        "mem": dict(rep.get("mem") or {}),
        "sched": sched,
        "finished_requests": None,
        "metrics": {
            kind: [e for e in metrics.get(kind, [])
                   if str(e.get("name", "")).startswith(_SCRAPE_PREFIXES)]
            for kind in ("counters", "gauges", "histograms")
        },
    }


# the subset of the exposition format emitted here (and that a scraper
# requires): one family a line group, samples after their family's TYPE
# header, no repeated TYPE
_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{[^}]*\})? [0-9eE+.i-]+(nf|an)?$")
_TYPE_RE = re.compile(r"^# TYPE ([A-Za-z_:][A-Za-z0-9_:]*) (counter|gauge|summary|histogram)$")


def validate_prometheus_text(text: str) -> List[str]:
    """Schema check of the emitted exposition text: the list of problems
    (empty means valid)."""
    errs: List[str] = []
    typed: Dict[str, str] = {}
    for i, line in enumerate(text.splitlines()):
        where = f"line {i + 1}"
        if not line:
            continue
        if line.startswith("#"):
            m = _TYPE_RE.match(line)
            if m is None:
                errs.append(f"{where}: bad comment/TYPE line {line!r}")
                continue
            name = m.group(1)
            if name in typed:
                errs.append(f"{where}: repeated TYPE for family {name}")
            typed[name] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            errs.append(f"{where}: unparsable sample {line!r}")
            continue
        name = m.group(1)
        base = name
        for suffix in ("_count", "_sum", "_total", "_bucket"):
            if name.endswith(suffix) and name[: -len(suffix)] in typed:
                base = name[: -len(suffix)]
                break
        if base not in typed and name not in typed:
            errs.append(f"{where}: sample {name} precedes its TYPE header")
    return errs


# ---------------------------------------------------------------------------
# the RunReport ledger
# ---------------------------------------------------------------------------

LEDGER_DIR = os.path.join("artifacts", "obs_torch", "ledger")
LEDGER_CAP = 32


def ledger_paths(ledger_dir: str) -> List[str]:
    """Ledger entries oldest first (file names sort by their millisecond
    timestamp prefix)."""
    try:
        names = [n for n in os.listdir(ledger_dir) if n.endswith(".json")]
    except OSError:
        return []
    return [os.path.join(ledger_dir, n) for n in sorted(names)]


def ledger_append(report: dict, ledger_dir: str = LEDGER_DIR, cap: int = LEDGER_CAP) -> str:
    """Write ``report`` as the newest ledger entry and prune past the cap.
    The entry is stamped with the emitting trace_id (``config.trace_id``:
    the ambient TraceContext's, else a fresh id), so ledger entries join
    request traces and the bus."""
    from . import context as _context

    os.makedirs(ledger_dir, exist_ok=True)
    cfg = report.setdefault("config", {})
    if not cfg.get("trace_id"):
        ctx = _context.current()
        cfg["trace_id"] = ctx.trace_id if ctx is not None else _context.new_trace_id()
    ts_ms = int(float(report.get("created_unix", time.time())) * 1000)
    name = sanitize_key(str(report.get("name", "report")))[:48]
    path = os.path.join(ledger_dir, f"{ts_ms:013d}-{name}-{cfg['trace_id'][:8]}.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    paths = ledger_paths(ledger_dir)
    for old in paths[: max(0, len(paths) - cap)]:
        try:
            os.remove(old)
        except OSError:
            pass
    return path


def ledger_load(ledger_dir: str, last: Optional[int] = None) -> List[dict]:
    """The ledger's reports oldest first (the newest ``last`` when given),
    each with its ``_ledger_path``; unreadable entries are skipped."""
    docs: List[dict] = []
    paths = ledger_paths(ledger_dir)
    if last:
        paths = paths[-last:]
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if isinstance(doc, dict):
            doc["_ledger_path"] = p
            docs.append(doc)
    return docs


# ---------------------------------------------------------------------------
# the scrape endpoint
# ---------------------------------------------------------------------------


def queue_snapshot() -> dict:
    """The batch-window queues' live stats (the ``/queue.json`` body),
    through a ``sys.modules`` probe: a process that never imports the
    service layer scrapes an empty surface."""
    q = sys.modules.get(__package__.rsplit(".", 1)[0] + ".serve.queue")
    if q is None:
        return {"queues": {}}
    return q.queue_stats()


def healthz_text() -> str:
    """The ``/healthz`` body: "ok", then the queues' liveness line."""
    qs = queue_snapshot()["queues"]
    return "ok\nqueues {} depth {} open_windows {}\n".format(
        len(qs), sum(s.get("depth", 0) for s in qs.values()),
        sum(s.get("open_windows", 0) for s in qs.values()))


def _make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet: scraped in a loop
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server API)
            from urllib.parse import parse_qs, urlparse

            url = urlparse(self.path)
            try:
                if url.path in ("/metrics", "/"):
                    self._send(200, "text/plain; version=0.0.4", prometheus_text().encode())
                elif url.path == "/snapshot.json":
                    self._send(200, "application/json", json.dumps(stats_snapshot()).encode())
                elif url.path == "/events.json":
                    since = int(parse_qs(url.query).get("since", ["0"])[0])
                    body = json.dumps({"events": BUS.events(since=since),
                                       "last_seq": BUS.last_seq(), "dropped": BUS.dropped},
                                      default=str).encode()
                    self._send(200, "application/json", body)
                elif url.path == "/queue.json":
                    self._send(200, "application/json",
                               json.dumps(queue_snapshot(), default=str).encode())
                elif url.path == "/healthz":
                    self._send(200, "text/plain", healthz_text().encode())
                else:
                    self._send(404, "text/plain", b"not found\n")
            except Exception as e:  # a broken scrape must not kill the server
                try:
                    self._send(500, "text/plain", f"error: {e}\n".encode())
                except Exception:
                    pass

    return Handler


def start_server(port: int = 0, host: str = "127.0.0.1"):
    """Start the scrape endpoint on a daemon thread; returns ``(server,
    thread, port)`` (the bound port: pass 0 for an ephemeral one).
    ``server.shutdown(); server.server_close()`` stops it."""
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer((host, port), _make_handler())
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, name="slate-obs-live", daemon=True)
    th.start()
    return srv, th, srv.server_address[1]


# ---------------------------------------------------------------------------
# the --ci acceptance run
# ---------------------------------------------------------------------------


def _run_workload(mesh_round: bool = True, device="cuda") -> List:
    """The two-tenant Router workload the ``--ci`` scrape observes:
    meshless posv / gesv under two tenants (serve, mem and the condest
    families), then, with ``mesh_round``, one checkpointed and monitored
    gesv on the virtual 2 x 4 mesh (the sched link / coll bytes and the
    in-carry num gauges).  The operands come from ``slate_tpu``'s numpy
    stream (seed 7).  Returns the finished request traces."""
    import numpy as np
    import torch

    from ..serve import trace as serve_trace
    from ..serve.router import Router
    from . import memory

    device = torch.device(device)
    rng = np.random.default_rng(7)
    n = 32
    before = len(serve_trace.finished_traces())

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def spd(sz):
        g = rng.standard_normal((sz, sz))
        return dev(g @ g.T / sz + 2 * np.eye(sz))

    b = dev(rng.standard_normal((n, 2)))
    router = Router(bins=(n,), hbm_budget=1 << 30, device=device)
    with memory.force_sampling(True):
        for tenant in ("acme", "zeta"):
            router.solve("posv", spd(n), b, tenant=tenant)
            good = dev(rng.standard_normal((n, n)) + n * np.eye(n))
            router.solve("gesv", good, b, tenant=tenant)
        if mesh_round:
            from ..parallel.mesh import make_mesh
            from ..types import Option

            mesh = make_mesh(2, 4, device=device)
            # the card's budget by default; the host has none of its own
            mrouter = Router(mesh=mesh, nb=8, bins=(64,),
                             hbm_budget=None if device.type == "cuda" else 1 << 30,
                             opts={Option.Checkpoint: 3, Option.NumMonitor: "on"})
            g = rng.standard_normal((64, 64)) + 64 * np.eye(64)
            mb = rng.standard_normal((64, 2))
            mrouter.solve("gesv", dev(g), dev(mb), tenant="acme")
    return serve_trace.finished_traces()[before:]


def _check_unified_trace(doc: dict, trace_id: str) -> List[str]:
    """The acceptance predicate: validator-clean and >= 3 track kinds
    correlated by one request's trace_id."""
    from . import perfetto

    errs = list(perfetto.validate_chrome_trace(doc))
    kinds = {e.get("cat") for e in doc.get("traceEvents", [])
             if (e.get("args") or {}).get("trace_id") == trace_id}
    kinds.discard(None)
    if len(kinds) < 3:
        errs.append(f"only {sorted(kinds)} track types correlated by trace_id {trace_id} "
                    "(need >= 3 of request/span/mem/flight)")
    return errs


def run_ci(out_dir: str, mesh_round: bool = True, ledger_seed: Optional[str] = None,
           device="cuda") -> int:
    """The acceptance run (see the module docstring); returns an exit code.
    Its artifacts land under ``out_dir``."""
    import urllib.request

    from . import perfetto, report, span as _span

    failures: List[str] = []
    os.makedirs(out_dir, exist_ok=True)
    _span.enable()
    srv = None
    try:
        srv, _th, port = start_server(0)
        traces = _run_workload(mesh_round=mesh_round, device=device)
        if not traces:
            failures.append("workload produced no finished traces")
        # one scrape over HTTP while the workload's process lives
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            text = r.read().decode()
        with open(os.path.join(out_dir, "scrape.prom"), "w") as f:
            f.write(text)
        errs = validate_prometheus_text(text)
        if errs:
            failures.append(f"prometheus text invalid: {errs[:3]}")
        families = ["slate_tpu_serve_", "slate_tpu_mem_"]
        if mesh_round:
            # the sched / num families come from the monitored mesh solve
            # (audited bytes, in-carry gauges); a meshless run has neither
            families += ["slate_tpu_sched_", "slate_tpu_num_"]
        for family in families:
            if family not in text:
                failures.append(f"family {family}* missing from the scrape")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/snapshot.json", timeout=30) as r:
            snap = json.loads(r.read().decode())
        if not snap.get("finished_requests"):
            failures.append("snapshot.json reports no finished requests")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/events.json", timeout=30) as r:
            evdoc = json.loads(r.read().decode())
        kinds = {e["kind"] for e in evdoc.get("events", [])}
        for want in ("span", "request", "mem"):
            if want not in kinds:
                failures.append(f"bus carried no {want!r} events")
        # the unified Perfetto export: request track, driver spans and mem
        # counters tied by one request's trace_id
        target = traces[-1] if traces else None
        trace_path = os.path.join(out_dir, "unified.trace.json")
        perfetto.write_unified_trace(trace_path, traces)
        with open(trace_path) as f:
            doc = json.load(f)
        if target is not None:
            errs = _check_unified_trace(doc, target.trace_id)
            if errs:
                failures.append(f"unified trace: {errs[:3]}")
        # a fresh ledger entry, seeded from an existing ledger when given so
        # --trend has history
        ledger_dir = os.path.join(out_dir, "ledger")
        if ledger_seed and os.path.isdir(ledger_seed):
            import shutil

            os.makedirs(ledger_dir, exist_ok=True)
            for p in ledger_paths(ledger_seed):
                shutil.copy(p, ledger_dir)
        rep = report.make_report(
            "obs_live_ci",
            config={"workload": "router_two_tenant", "mesh_round": bool(mesh_round),
                    "device": str(device)},
            values={"live.finished_requests": float(len(traces)),
                    "live.bus_events": float(len(BUS))})
        ledger_append(rep, ledger_dir)
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
    if failures:
        print("obs.live --ci FAILURES:")
        for msg in failures:
            print(f"  {msg}")
        return 1
    print(f"obs.live --ci OK -- scrape + unified trace + ledger under {out_dir}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.obs.live", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, default=9464,
                    help="scrape port (default 9464; 0 = ephemeral)")
    ap.add_argument("--demo", action="store_true",
                    help="drive the two-tenant Router workload before serving, so a bare run "
                         "shows a populated surface")
    ap.add_argument("--no-mesh", action="store_true",
                    help="skip the workload's checkpointed mesh round (faster; no sched family)")
    ap.add_argument("--ci", action="store_true",
                    help="acceptance run: serve on an ephemeral port, drive the workload, "
                         "scrape and validate, export the unified trace, append a ledger "
                         "entry, exit nonzero on any failure")
    ap.add_argument("--out", default=os.path.join("artifacts", "obs_live_torch"),
                    help="--ci artifact directory")
    ap.add_argument("--ledger-seed", default=LEDGER_DIR,
                    help="ledger to seed the --ci ledger from (default: the port's own)")
    ap.add_argument("--device", default="cuda",
                    help="device of the workload (default cuda; cpu on the host)")
    args = ap.parse_args(argv)

    if args.ci:
        return run_ci(args.out, mesh_round=not args.no_mesh, ledger_seed=args.ledger_seed,
                      device=args.device)

    from . import span as _span

    _span.enable()
    if args.demo:
        _run_workload(mesh_round=not args.no_mesh, device=args.device)
    srv, th, port = start_server(args.port)
    print(f"slate_tpu_torch.obs.live: serving /metrics /snapshot.json /events.json "
          f"/queue.json /healthz on http://127.0.0.1:{port}", file=sys.stderr)
    try:
        th.join()
    except KeyboardInterrupt:
        srv.shutdown()
        srv.server_close()
    return 0


if __name__ == "__main__":
    # run as ``__main__``: the producers' sys.modules probe (and the BUS they
    # publish to) key on the package's module name, so re-enter through the
    # real import and let that instance own the bus and the server
    from slate_tpu_torch.obs import live as _canonical

    sys.exit(_canonical.main())
