"""Observability of the port: metrics, spans, RunReports, Perfetto export
and the step-level flight recorder.

Counterpart of ``slate_tpu/obs`` (its core; the memory and numerics
layers come with their slice):

- ``enable()`` / ``SLATE_TPU_OBS=1`` lights up every instrumented driver
  (``instrument``): nested spans with wall seconds (the card fenced at both
  ends), the comm bytes each call moves (absorbed from the
  ``parallel.comm`` audit) and its per-hop schedule;
- ``report`` holds the versioned RunReport schema and the ``python -m
  slate_tpu_torch.obs.report`` CLI with ``--check`` regression gating;
- ``perfetto.write_chrome_trace`` exports spans and flight timelines for
  ui.perfetto.dev; span names also reach ``torch.profiler`` traces
  (``torch.profiler.record_function``);
- ``flight`` is the step-level flight recorder over the six mesh k-loops
  (``flight_scope`` / ``SLATE_TPU_OBS_DEEP=1``), ``schedule`` its static
  model and critical-path analyses;
- ``python -m slate_tpu_torch.obs.smoke`` is the acceptance run.
"""

# perfetto / report / flight are not imported here, so that
# ``python -m slate_tpu_torch.obs.report`` (and .flight) run without
# runpy's found-in-sys.modules warning: import them as submodules
from .context import (  # noqa: F401
    TraceContext,
    current as current_context,
    new_trace_id,
    use_context,
)
from .metrics import REGISTRY, MetricsRegistry, flatten_snapshot  # noqa: F401
from .span import (  # noqa: F401
    FINISHED,
    Span,
    current_span,
    disable,
    driver_span,
    enable,
    enabled,
    force_enabled,
    instrument,
    measure,
    reset,
)

__all__ = [
    "TraceContext",
    "current_context",
    "new_trace_id",
    "use_context",
    "REGISTRY",
    "MetricsRegistry",
    "flatten_snapshot",
    "FINISHED",
    "Span",
    "current_span",
    "disable",
    "driver_span",
    "enable",
    "enabled",
    "force_enabled",
    "instrument",
    "measure",
    "reset",
    # forwarded from obs.flight on first use (see __getattr__)
    "flight_scope",
    "no_flight",
    "step_dispatch_active",
    "FlightRecorder",
]

_FLIGHT_NAMES = frozenset({"flight_scope", "no_flight", "step_dispatch_active", "FlightRecorder"})


def __getattr__(name):
    if name in _FLIGHT_NAMES:
        from . import flight

        return getattr(flight, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
