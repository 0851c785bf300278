"""The metrics export surface: Prometheus text and JSON snapshots of the
serving registry.

Counterpart of ``slate_tpu/serve/stats.py``: this module keeps the import
path and the CLI and delegates to ``slate_tpu_torch.obs.live``, which holds
the one Prometheus formatter and the one family-naming rule, shared with the
live scrape endpoint (``python -m slate_tpu_torch.obs.live``).

The CLI::

    python -m slate_tpu_torch.serve.stats [REPORT.json] [--json OUT] [--demo] [--device cpu|cuda]

- with a RunReport argument it formats that report's ``serve`` section and
  metric series (the offline view of an artifact);
- without one it snapshots the live registry of this process (``--demo``
  first drives a small Router workload on ``--device``, default the card,
  so a bare run shows a populated surface);
- ``--json`` also writes the machine-readable snapshot.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs.live import (  # noqa: F401
    _PREFIX,
    _SCRAPE_PREFIXES,
    _fmt_tags,
    prometheus_text,
    sanitize_key as _sanitize_key,
    snapshot_from_report,
    stats_snapshot,
    validate_prometheus_text,
)


def _run_demo(device="cuda") -> None:
    """A small meshless Router workload (n = 32: the point is the export
    format, not the solve), on ``slate_tpu``'s numpy stream (seed 0)."""
    import numpy as np
    import torch

    from .. import obs
    from .router import Router

    obs.enable()
    rng = np.random.default_rng(0)
    router = Router(bins=(32,), hbm_budget=1 << 30, device=device)
    n = 32
    for _ in range(3):
        g = rng.standard_normal((n, n))
        a = torch.from_numpy(g @ g.T / n + 2 * np.eye(n)).to(device)
        b = torch.from_numpy(rng.standard_normal((n, 2))).to(device)
        router.solve("posv", a, b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m slate_tpu_torch.serve.stats",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("report", nargs="?",
                    help="RunReport JSON to format instead of the live registry")
    ap.add_argument("--json", metavar="PATH", help="also write the JSON snapshot to PATH")
    ap.add_argument("--demo", action="store_true",
                    help="drive a small Router workload first (live mode)")
    ap.add_argument("--device", default="cuda",
                    help="device of the --demo workload (default cuda; cpu on the host)")
    args = ap.parse_args(argv)

    if args.report:
        try:
            with open(args.report) as f:
                rep = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"serve.stats: cannot read report: {e}", file=sys.stderr)
            return 2
        snap = snapshot_from_report(rep)
    else:
        if args.demo:
            _run_demo(args.device)
        snap = stats_snapshot()

    sys.stdout.write(prometheus_text(snap))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(snap, f, indent=1)
        print(f"# snapshot written to {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
