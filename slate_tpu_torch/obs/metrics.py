"""Tagged metrics registry: counters and gauges.

Counterpart of ``MetricsRegistry`` in ``slate_tpu/obs/metrics.py``, cut to
what the ``ft`` layer reads: a metric is (name, frozen tag set) -> scalar,
counters accumulate, gauges overwrite, and a snapshot is a plain JSON-able
dict with ``slate_tpu``'s layout.  Histograms come with the observability
slice.

The flat ``serve.*`` counters of ``slate_tpu/serve/metrics.py`` that the
port's code bumps so far live here too (:func:`serve_count`): the Ozaki
digit-plane cache's ``ozaki_presplits`` and ``ozaki_presplit_hits``, and
the mesh condest memo's ``condest_cache_hits``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, tags: Dict[str, object]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in tags.items()))


class MetricsRegistry:
    """Counters accumulate, gauges overwrite.  Tags are free-form key=value
    pairs; a distinct tag set is a distinct series.  Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}

    def counter_add(self, name: str, value: float = 1.0, **tags) -> None:
        k = _key(name, tags)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge_set(self, name: str, value: float, **tags) -> None:
        with self._lock:
            self._gauges[_key(name, tags)] = float(value)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()

    def counter_value(self, name: str, **tags) -> float:
        return self._counters.get(_key(name, tags), 0.0)

    def gauge_value(self, name: str, **tags):
        """The last value set for one gauge series, or None."""
        return self._gauges.get(_key(name, tags))

    def snapshot(self) -> Dict[str, List[dict]]:
        """JSON-able dump: ``{"counters": [...], "gauges": [...]}``, each
        entry ``{"name", "tags", "value"}``, sorted by series."""
        with self._lock:
            return {
                "counters": [{"name": n, "tags": dict(t), "value": v}
                             for (n, t), v in sorted(self._counters.items())],
                "gauges": [{"name": n, "tags": dict(t), "value": v}
                           for (n, t), v in sorted(self._gauges.items())],
            }


REGISTRY = MetricsRegistry()


# flat serve.* counters (slate_tpu/serve/metrics.py names); the rest of the
# serving layer comes with its slice
_SERVE_COUNTS: Dict[str, float] = {"ozaki_presplits": 0.0, "ozaki_presplit_hits": 0.0,
                                   "condest_cache_hits": 0.0}


def serve_count(name: str, n: float = 1.0) -> None:
    """Bump one flat serve counter (an unknown name raises, as in
    ``slate_tpu``)."""
    if name not in _SERVE_COUNTS:
        raise KeyError(f"unknown serve counter {name!r}")
    _SERVE_COUNTS[name] += n


def serve_counts() -> Dict[str, float]:
    """Snapshot of the flat serve counters."""
    return dict(_SERVE_COUNTS)
