"""serve.* counters: the serving layer's observability surface.

Counterpart of ``slate_tpu/serve/metrics.py``.  The flat counters
(``requests``, ``batches``, ``cache_hits``, ``traces``, ...: the names and
meanings of ``slate_tpu``) live in ``obs.metrics``, so that the mesh caches
that bump them need not import this package; this module adds the
request-level SLA reduction of ``serve.trace`` and is what the RunReport's
``serve`` section reads (``obs.report``).  Every value is a deterministic
count under a fixed workload except the latency quantiles
(``latency_*_s``), which the report gate ignores as wall-clock keys.
"""

from __future__ import annotations

import re
from typing import Dict

from ..obs.metrics import serve_count, serve_counts, serve_reset

__all__ = ["serve_count", "serve_counts", "serve_counter_values", "reset"]


def _sanitize_key(name: str) -> str:
    """Report- and Prometheus-safe metric-name fragment (tag values such
    as dtype names can carry characters the flat key space cannot)."""
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


def serve_counter_values() -> Dict[str, float]:
    """The RunReport ``serve`` section: the flat counters plus the SLA
    reduction of the finished request traces (per-(op, class) latency
    quantiles and counts, outcome totals and rates).  A run in which no
    request terminated adds nothing beyond the counter zeros."""
    from . import trace as _trace

    out = serve_counts()
    out.update(_trace.sla_values())
    return out


def reset() -> None:
    """Zero the flat counters and drop the finished request traces."""
    from . import trace as _trace

    serve_reset()
    _trace.reset()
