"""Tagged metrics registry: counters, gauges, histograms.

Counterpart of ``slate_tpu/obs/metrics.py``: the one sink every source of
the port's observability feeds -- driver spans (``obs.span``), the
comm-byte audit they absorb, the ``ft.*`` and ``ir.*`` counters.  A metric
is (name, frozen tag set) -> scalar state, counters accumulate, gauges
overwrite, histograms observe (exact running count / sum / min / max plus a
bounded, deterministically seeded sample reservoir), and a snapshot is a
plain JSON-able dict with ``slate_tpu``'s layout (the RunReport ``metrics``
section).  Nothing here imports torch.

The flat ``serve.*`` counters of ``slate_tpu/serve/metrics.py`` that the
port's code bumps so far live here too (:func:`serve_count`): the Ozaki
digit-plane cache's ``ozaki_presplits`` and ``ozaki_presplit_hits``, and
the mesh condest memo's ``condest_cache_hits``.
"""

from __future__ import annotations

import math
import random
import threading
import zlib
from typing import Dict, List, Optional, Tuple

# histograms keep a bounded sample reservoir next to exact running stats
_HIST_SAMPLE_CAP = 512

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, tags: Dict[str, object]) -> _Key:
    return name, tuple(sorted((k, str(v)) for k, v in tags.items()))


def quantile_of(samples: List[float], q: float,
                vmin: Optional[float] = None,
                vmax: Optional[float] = None) -> Optional[float]:
    """Linear-interpolated quantile of a sample list, clamped to the exact
    running [vmin, vmax] when given (a reservoir can have dropped the true
    extremes).  None for an empty list."""
    if not samples:
        return None
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    s = sorted(samples)
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    val = s[lo] + (s[hi] - s[lo]) * (pos - lo)
    if vmin is not None:
        val = max(val, vmin)
    if vmax is not None:
        val = min(val, vmax)
    return val


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "samples", "_rng")

    def __init__(self, seed: int = 0) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []
        # Vitter's algorithm R, seeded from the series key (not the
        # process): a fixed workload keeps the same sample set run to run
        self._rng = random.Random(seed)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)
        if len(self.samples) < _HIST_SAMPLE_CAP:
            self.samples.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < _HIST_SAMPLE_CAP:
                self.samples[j] = v

    def quantile(self, q: float) -> Optional[float]:
        """Exact while count <= the reservoir cap, a reservoir estimate
        clamped to the running min / max beyond it; None when empty."""
        if self.count == 0:
            return None
        return quantile_of(self.samples, q, self.vmin, self.vmax)


class MetricsRegistry:
    """Counters accumulate, gauges overwrite, histograms observe.  Tags are
    free-form key=value pairs; a distinct tag set is a distinct series.
    Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, _Hist] = {}

    # -- write side ---------------------------------------------------
    def counter_add(self, name: str, value: float = 1.0, **tags) -> None:
        k = _key(name, tags)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge_set(self, name: str, value: float, **tags) -> None:
        with self._lock:
            self._gauges[_key(name, tags)] = float(value)

    def observe(self, name: str, value: float, **tags) -> None:
        k = _key(name, tags)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Hist(zlib.crc32(repr(k).encode()))
            h.observe(float(value))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()

    # -- read side ----------------------------------------------------
    def counter_value(self, name: str, **tags) -> float:
        return self._counters.get(_key(name, tags), 0.0)

    def gauge_value(self, name: str, **tags):
        """The last value set for one gauge series, or None."""
        return self._gauges.get(_key(name, tags))

    def quantile(self, name: str, q: float, **tags) -> Optional[float]:
        """Quantile of one histogram series (None when it never observed)."""
        with self._lock:
            h = self._hists.get(_key(name, tags))
            return h.quantile(q) if h is not None else None

    def histogram_series(self, name: str) -> List[dict]:
        """All series of one histogram name: [{tags, count, sum, min, max,
        samples}]."""
        with self._lock:
            return [
                {"tags": dict(tags), "count": h.count, "sum": h.total,
                 "min": h.vmin, "max": h.vmax, "samples": list(h.samples)}
                for (n, tags), h in sorted(self._hists.items()) if n == name
            ]

    def snapshot(self) -> Dict[str, List[dict]]:
        """JSON-able dump, sorted by series: ``{"counters", "gauges",
        "histograms"}`` (the RunReport ``metrics`` section)."""
        with self._lock:
            out: Dict[str, List[dict]] = {"counters": [], "gauges": [], "histograms": []}
            for (name, tags), v in sorted(self._counters.items()):
                out["counters"].append({"name": name, "tags": dict(tags), "value": v})
            for (name, tags), v in sorted(self._gauges.items()):
                out["gauges"].append({"name": name, "tags": dict(tags), "value": v})
            for (name, tags), h in sorted(self._hists.items()):
                out["histograms"].append({
                    "name": name,
                    "tags": dict(tags),
                    "count": h.count,
                    "sum": h.total,
                    "min": h.vmin if h.count else None,
                    "max": h.vmax if h.count else None,
                    "p50": h.quantile(0.5),
                    "p95": h.quantile(0.95),
                    "p99": h.quantile(0.99),
                })
            return out


REGISTRY = MetricsRegistry()


def flatten_snapshot(snap: Dict[str, List[dict]], sep: str = "|") -> Dict[str, float]:
    """A snapshot() as scalar {series_name: value} for report comparison:
    counters and gauges by value, histograms by their sum."""
    flat: Dict[str, float] = {}

    def series(entry: dict) -> str:
        tags = entry.get("tags") or {}
        if not tags:
            return entry["name"]
        tagstr = ",".join(f"{k}={v}" for k, v in sorted(tags.items()))
        return f"{entry['name']}{sep}{tagstr}"

    for entry in snap.get("counters", []) + snap.get("gauges", []):
        flat[series(entry)] = float(entry["value"])
    for entry in snap.get("histograms", []):
        flat[series(entry)] = float(entry["sum"])
    return flat


# flat serve.* counters (slate_tpu/serve/metrics.py names); the rest of the
# serving layer comes with its slice
_SERVE_NAMES = ("ozaki_presplits", "ozaki_presplit_hits", "condest_cache_hits")
_SERVE_COUNTS: Dict[str, float] = dict.fromkeys(_SERVE_NAMES, 0.0)


def serve_count(name: str, n: float = 1.0) -> None:
    """Bump one flat serve counter (an unknown name raises, as in
    ``slate_tpu``)."""
    if name not in _SERVE_COUNTS:
        raise KeyError(f"unknown serve counter {name!r}")
    _SERVE_COUNTS[name] += n


def serve_counts() -> Dict[str, float]:
    """Snapshot of the flat serve counters (the RunReport ``serve``
    section)."""
    return dict(_SERVE_COUNTS)


def serve_reset() -> None:
    """Zero the flat serve counters (``obs.reset``'s run boundary)."""
    _SERVE_COUNTS.update(dict.fromkeys(_SERVE_NAMES, 0.0))
