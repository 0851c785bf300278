"""The serving front door: ``python -m slate_tpu_torch.serve.service``.

Counterpart of ``slate_tpu/serve/service.py``.  One long-running process:

- a **Router** (admission, accuracy class, cached stacked dispatch),
- a **BatchQueue** in front of it (batch windows, per-tenant budgets,
  weighted DRR dequeue: ``serve.queue``), pumped by a worker thread on the
  wall clock,
- a **ServiceController** stepping the SLA control loop
  (``serve.controller``) between pumps,
- a stdlib-http front end: ``POST /solve`` submits one request (JSON
  ``{"op", "a", "b", "tenant"}``; the operands become float64 tensors on the
  router's device) and parks its connection thread on the ticket, so
  concurrent callers' requests share batch windows; ``GET /queue.json``,
  ``/healthz`` and ``/metrics`` answer from the ``obs.live`` surface.

Stdlib only (``http.server``, like ``obs.live``): everything below the HTTP
skin (queue, ledger, controller) is transport-agnostic.  The worker and the
connection threads launch work on the card, all on the default stream.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import traceback
from typing import Dict, Optional

from ..types import SlateError
from .budget import BudgetLedger
from .controller import ServiceController
from .metrics import serve_count
from .queue import BatchQueue
from .router import Router


class Service:
    """Queue + worker + controller around one Router (by default a meshless
    Router on the card)."""

    def __init__(self, router: Optional[Router] = None, *, max_batch: int = 8,
                 window_s: float = 0.005, budgets: Optional[Dict[str, int]] = None,
                 weights: Optional[Dict[str, float]] = None, dispatch: str = "stacked",
                 controller_every: int = 8, request_timeout_s: float = 60.0,
                 name: str = "service", **controller_kw) -> None:
        self.router = router if router is not None else Router()
        self.queue = BatchQueue(
            self.router, max_batch=max_batch, window_s=window_s,
            ledger=BudgetLedger(budgets, weights, default_budget=self.router._budget),
            dispatch=dispatch, name=name)
        self.controller = ServiceController(self.queue, **controller_kw)
        self.request_timeout_s = float(request_timeout_s)
        self._controller_every = int(controller_every)
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._run, name="slate-serve-worker", daemon=True)
        self._worker.start()

    def stop(self) -> None:
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None
        self.queue.drain()
        self.queue.close()

    def _run(self) -> None:
        ticks = 0
        while not self._stop.is_set():
            try:
                self.queue.pump()
            except SlateError:
                # a failed window has settled its tickets and traces: the
                # worker outlives any one bad operand
                pass
            except Exception:
                # any other escape must not kill the worker either: a dead
                # pump hangs every queued and later request until its ticket
                # times out
                serve_count("queue_pump_errors")
                traceback.print_exc(file=sys.stderr)
            ticks += 1
            if ticks % self._controller_every == 0:
                try:
                    self.controller.step()
                except Exception:
                    serve_count("queue_pump_errors")
                    traceback.print_exc(file=sys.stderr)
            # park a fraction of the window, so T-expiry is seen promptly
            # without spinning
            self._stop.wait(min(self.queue.window_s / 4.0, 0.002))

    # -- request entry -----------------------------------------------------

    def solve(self, op: str, a, b, tenant: Optional[str] = None):
        """Submit one request and block until its window dispatched (the
        per-connection path; concurrent callers share windows)."""
        ticket = self.queue.submit(op, a, b, tenant=tenant)
        return ticket.wait(timeout=self.request_timeout_s)


# ---------------------------------------------------------------------------
# the HTTP skin
# ---------------------------------------------------------------------------


def _make_handler(service: Service):
    from http.server import BaseHTTPRequestHandler

    import torch

    from ..obs import live as _live

    device = service.router.device

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, doc: dict) -> None:
            self._send(code, "application/json", json.dumps(doc, default=str).encode())

        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path == "/queue.json":
                self._send_json(200, _live.queue_snapshot())
            elif self.path == "/healthz":
                self._send(200, "text/plain", _live.healthz_text().encode())
            elif self.path in ("/metrics", "/"):
                self._send(200, "text/plain; version=0.0.4", _live.prometheus_text().encode())
            else:
                self._send(404, "text/plain", b"not found\n")

        def do_POST(self):  # noqa: N802 (http.server API)
            if self.path != "/solve":
                self._send(404, "text/plain", b"not found\n")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                doc = json.loads(self.rfile.read(length).decode())
                op = doc["op"]
                a = torch.tensor(doc["a"], dtype=torch.float64, device=device)
                b = torch.tensor(doc["b"], dtype=torch.float64, device=device)
                tenant = doc.get("tenant")
            except (KeyError, ValueError, TypeError, RuntimeError) as e:
                # json.JSONDecodeError is a ValueError; torch.tensor raises
                # ValueError / TypeError / RuntimeError on a malformed list
                self._send_json(400, {"error": f"bad request: {e}"})
                return
            try:
                x = service.solve(op, a, b, tenant=tenant)
            except SlateError as e:
                # a budget refusal is the retry-later class; the rest of the
                # SlateError taxonomy is the caller's operand
                self._send_json(429 if "budget" in str(e) else 422, {"error": str(e)})
                return
            except TimeoutError as e:
                self._send_json(504, {"error": str(e)})
                return
            self._send_json(200, {"x": x.cpu().tolist(), "tenant": tenant})

    return Handler


def start_http(service: Service, port: int = 0, host: str = "127.0.0.1"):
    """Serve the front end on a daemon thread; returns ``(server, thread,
    port)`` (the ``obs.live.start_server`` contract)."""
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer((host, port), _make_handler(service))
    srv.daemon_threads = True
    th = threading.Thread(target=srv.serve_forever, name="slate-serve-http", daemon=True)
    th.start()
    return srv, th, srv.server_address[1]


def _parse_kv(pairs, cast):
    out = {}
    for item in pairs or ():
        name, _, val = item.partition("=")
        if not name or not val:
            raise SystemExit(f"expected TENANT=VALUE, got {item!r}")
        out[name] = cast(val)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.serve.service",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, default=9465,
                    help="front-end port (default 9465; 0 = ephemeral)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="batch-window fill target B (default 8)")
    ap.add_argument("--window-ms", type=float, default=5.0,
                    help="batch-window deadline T in ms (default 5)")
    ap.add_argument("--budget", action="append", metavar="TENANT=BYTES",
                    help="per-tenant device-memory budget (repeatable)")
    ap.add_argument("--weight", action="append", metavar="TENANT=W",
                    help="per-tenant DRR weight (repeatable)")
    ap.add_argument("--dispatch", choices=("stacked", "packed"), default="stacked")
    ap.add_argument("--device", default="cuda",
                    help="the router's device (default cuda; on cpu set SLATE_TPU_HBM_BYTES)")
    args = ap.parse_args(argv)

    from .. import obs
    from ..obs import span as _span

    obs.enable()
    _span.enable()
    try:
        service = Service(Router(device=args.device), max_batch=args.max_batch,
                          window_s=args.window_ms / 1000.0,
                          budgets=_parse_kv(args.budget, int),
                          weights=_parse_kv(args.weight, float), dispatch=args.dispatch)
    except ValueError as e:   # e.g. --weight t=0, or no budget on the host
        raise SystemExit(str(e))
    service.start()
    srv, th, port = start_http(service, args.port)
    print(f"slate_tpu_torch.serve.service: POST /solve, GET /queue.json /healthz /metrics on "
          f"http://127.0.0.1:{port} (B={args.max_batch}, T={args.window_ms}ms, "
          f"device {service.router.device})", file=sys.stderr)
    try:
        th.join()
    except KeyboardInterrupt:
        srv.shutdown()
        srv.server_close()
        service.stop()
    return 0


if __name__ == "__main__":
    # run as ``__main__``: re-enter through the package import, so the queue
    # registry and the bus (keyed on module names) see one instance
    from slate_tpu_torch.serve import service as _canonical

    sys.exit(_canonical.main())
