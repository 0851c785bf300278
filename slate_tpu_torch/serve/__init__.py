"""Serving runtime: batched small-problem drivers, an executable cache, the
tuned schedule table and the service layer over them.

Counterpart of ``slate_tpu/serve``.  The serving workload is floods of
256-4096-sized solves:

- ``batch``: stacked drivers (a loop over the single verbs, each row bitwise
  its single solve) and block-diagonal packing of ragged sizes for the
  mesh path;
- ``cache``: the executable cache keyed on (op, shape, dtype, batch, mesh,
  resolved Options), with warm-up / pin and build counts (steady-state
  traffic builds nothing);
- ``table`` / ``tune``: the tuned schedule table (explicit > context > env >
  tuned > auto) and the flight-recorder sweep that writes one;
- ``router``: admission on the memory model, the condest accuracy classes,
  cached stacked dispatch, the resilient mesh path and the gels tier;
- ``trace`` / ``metrics`` / ``stats``: request-level traces, the ``serve.*``
  counters and SLA keys of the RunReport's ``serve`` section, and their
  Prometheus export (a delegate of ``obs.live``);
- ``queue`` / ``budget`` / ``controller`` / ``service``: the service layer.
  ``BatchQueue`` coalesces a concurrent request stream into batch windows
  (B requests or T seconds, keyed on the cache-key identity) over
  per-tenant budget accounts (``BudgetLedger``, ``reject_budget``) with
  weighted deficit-round-robin dequeue; ``ServiceController`` closes the
  SLA loop (hysteresis latches moving (B, T) and the precision-tier entry
  point off the p95 / outcome-rate surface); ``python -m
  slate_tpu_torch.serve.service`` is the stdlib-http front door;
- ``python -m slate_tpu_torch.serve.smoke`` and ``python -m
  slate_tpu_torch.serve.queue_smoke`` are the acceptance runs.
"""

from .batch import (  # noqa: F401
    gemm_batched,
    gesv_batched,
    pack_block_diag,
    pad_to_bin,
    posv_batched,
    potrf_batched,
    unpack_block_diag,
)
from .budget import BudgetLedger, request_cost  # noqa: F401
from .cache import CacheKey, ExecutableCache, executable_cache  # noqa: F401
from .controller import Hysteresis, ServiceController  # noqa: F401
from .metrics import serve_counter_values  # noqa: F401
from .queue import BatchQueue, ManualClock, queue_stats  # noqa: F401
from .router import Router  # noqa: F401
from .trace import RequestTrace, finished_traces  # noqa: F401
from .table import (  # noqa: F401
    load_tuned_table,
    resolve_request_options,
    use_tuned_table,
)

__all__ = [
    "BatchQueue",
    "BudgetLedger",
    "CacheKey",
    "ExecutableCache",
    "executable_cache",
    "Hysteresis",
    "ManualClock",
    "Router",
    "ServiceController",
    "queue_stats",
    "request_cost",
    "gemm_batched",
    "gesv_batched",
    "posv_batched",
    "potrf_batched",
    "pack_block_diag",
    "pad_to_bin",
    "unpack_block_diag",
    "serve_counter_values",
    "RequestTrace",
    "finished_traces",
    "load_tuned_table",
    "resolve_request_options",
    "use_tuned_table",
]
