"""Observability of the port: the metrics registry the ``ft`` layer counts in.

Counterpart of the part of ``slate_tpu/obs`` that ``slate_tpu/ft`` reads:
``MetricsRegistry`` and the process-wide ``REGISTRY``.  Spans, the
``instrument`` decorator, Perfetto export and RunReports come with the
observability slice.
"""

from .metrics import REGISTRY, MetricsRegistry  # noqa: F401

__all__ = ["REGISTRY", "MetricsRegistry", "reset"]


def reset() -> None:
    """Clear every counter and gauge of ``REGISTRY``."""
    REGISTRY.reset()
