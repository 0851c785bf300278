"""Serving runtime: batched small-problem drivers, an executable cache and
the tuned schedule table.

Counterpart of ``slate_tpu/serve`` (its serving core; the service layer --
``BatchQueue``, ``ManualClock``, ``queue_stats``, ``Hysteresis``,
``ServiceController``, ``serve.stats`` -- comes with slice 11b).  The
serving workload is floods of 256-4096-sized solves:

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
- ``trace`` / ``metrics``: request-level traces and the ``serve.*`` counters
  and SLA keys of the RunReport's ``serve`` section;
- ``budget``: per-tenant budgets (``BudgetLedger``, ``request_cost``);
- ``python -m slate_tpu_torch.serve.smoke`` is the acceptance run.
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
from .metrics import serve_counter_values  # noqa: F401
from .router import Router  # noqa: F401
from .trace import RequestTrace, finished_traces  # noqa: F401
from .table import (  # noqa: F401
    load_tuned_table,
    resolve_request_options,
    use_tuned_table,
)

__all__ = [
    "BudgetLedger",
    "CacheKey",
    "ExecutableCache",
    "executable_cache",
    "Router",
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
