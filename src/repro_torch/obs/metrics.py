"""Deterministic metrics: counters, gauges, and fixed-bucket histograms
with exact quantiles.

This is the ONE implementation of percentile/quantile math in the repo —
the fleet's TTFT/e2e p50/p99, the chaos router's slowest-quantile hedging
threshold, and the runtime's staleness statistics all go through
:class:`Histogram`, replacing the ad-hoc ``np.percentile``/``np.quantile``
call sites that had drifted across modules. Quantiles are **exact** (linear
interpolation over the full retained sample, numerically identical to
``np.percentile``'s default method — the retained-sample sizes here are
simulation-scale, thousands not billions); the fixed buckets exist for the
exported distribution shape, not as an approximation of the quantiles.

Everything is a pure function of the observation stream, so a registry
export for a seeded run is bit-identical across reruns — metrics files are
CI-gateable artifacts exactly like traces and SLO reports.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.obs.fsio import atomic_write_text

METRICS_SCHEMA_VERSION = 1

# bounded per-gauge history retained for windowed alert rules (min/max over
# the last N sets). 64 samples cover every default rule window with room to
# spare while keeping the per-gauge footprint constant.
GAUGE_WINDOW = 64

Number = Union[int, float]

# default fixed bucket upper bounds for latency-like values (ms): roughly
# log-spaced, wide enough for both decode-tick costs and e2e latencies
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, 10000.0)


class Counter:
    """Monotonically accumulating value (int-exact when fed ints)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Number = 0

    def inc(self, amount: Number = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter increment {amount} is negative")
        self.value += amount

    def to_dict(self) -> Number:
        return self.value


class Gauge:
    """Last-set value, plus a bounded window of recent sets.

    The export (``to_dict``) is still just the last value — the gated
    metrics artifacts did not move — but alert rules windowing over a
    gauge (burn-rate, drift) need more than the final sample, so the last
    ``GAUGE_WINDOW`` sets are retained deterministically.
    """

    __slots__ = ("value", "_hist")

    def __init__(self) -> None:
        self.value: Number = 0
        self._hist: Deque[float] = deque(maxlen=GAUGE_WINDOW)

    def set(self, value: Number) -> None:
        self.value = value
        self._hist.append(float(value))

    def window(self, n: int = GAUGE_WINDOW) -> List[float]:
        """The last ``min(n, GAUGE_WINDOW)`` set values, oldest first."""
        if n <= 0:
            raise ValueError(f"gauge window size {n} must be positive")
        return list(self._hist)[-n:]

    def window_min(self, n: int = GAUGE_WINDOW) -> float:
        w = self.window(n)
        return min(w) if w else 0.0

    def window_max(self, n: int = GAUGE_WINDOW) -> float:
        w = self.window(n)
        return max(w) if w else 0.0

    def to_dict(self) -> Number:
        return self.value


class Histogram:
    """Fixed-bucket histogram that also retains the exact sample.

    ``percentile(q)`` (q in [0, 100]) and ``quantile(q)`` (q in [0, 1])
    reproduce ``np.percentile`` / ``np.quantile`` bit-for-bit on the
    observation stream — the call sites this class replaced used those
    directly, and the bit-identical CI gates (SLO reports, bench rows)
    must not move.
    """

    __slots__ = ("buckets", "bucket_counts", "values", "_sum", "name")

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                 name: str = ""):
        if list(buckets) != sorted(buckets):
            raise ValueError(f"bucket bounds must be sorted: {buckets}")
        self.buckets = tuple(float(b) for b in buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +overflow
        self.values: List[float] = []
        self._sum = 0.0
        self.name = name

    def observe(self, value: Number) -> None:
        v = float(value)
        self.values.append(v)
        self._sum += v
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.bucket_counts[i] += 1
                return
        self.bucket_counts[-1] += 1

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def sum(self) -> float:
        return self._sum

    def _require_samples(self, what: str) -> None:
        if not self.values:
            label = self.name or "histogram"
            raise ValueError(
                f"{what} of empty histogram {label!r}: no observations were "
                f"recorded — guard the call with `if h.count` or observe a "
                f"sample first")

    def percentile(self, q: float) -> float:
        """Exact percentile (q in [0, 100]); raises a ``ValueError`` naming
        the metric on an empty histogram (a quantile of nothing is a bug at
        the call site, not a zero)."""
        self._require_samples(f"percentile({q:g})")
        return float(np.percentile(np.asarray(self.values), q))

    def quantile(self, q: float) -> float:
        """Exact quantile (q in [0, 1]) over the float64 sample — the
        hedging-threshold convention it replaced. Raises ``ValueError``
        naming the metric when empty."""
        self._require_samples(f"quantile({q:g})")
        return float(np.quantile(np.asarray(self.values, np.float64), q))

    def to_dict(self) -> Dict:
        empty = not self.values
        d: Dict = {
            "count": self.count,
            "sum": self._sum,
            "min": min(self.values) if self.values else 0.0,
            "max": max(self.values) if self.values else 0.0,
            "p50": 0.0 if empty else self.percentile(50),
            "p90": 0.0 if empty else self.percentile(90),
            "p99": 0.0 if empty else self.percentile(99),
            "buckets": {},
        }
        for i, b in enumerate(self.buckets):
            d["buckets"][f"le_{b:g}"] = self.bucket_counts[i]
        d["buckets"]["le_inf"] = self.bucket_counts[-1]
        return d


class MetricsRegistry:
    """Named counters/gauges/histograms with a deterministic export.

    Get-or-create accessors: ``registry.counter("fleet/decode_tokens")``
    returns the same object every call. Names are free-form; the repo's
    convention is ``<subsystem>/<metric>`` (docs/observability.md lists
    what each subsystem emits).
    """

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        if name not in self._counters:
            self._counters[name] = Counter()
        return self._counters[name]

    def gauge(self, name: str) -> Gauge:
        if name not in self._gauges:
            self._gauges[name] = Gauge()
        return self._gauges[name]

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        if name not in self._histograms:
            self._histograms[name] = Histogram(buckets or DEFAULT_BUCKETS,
                                               name=name)
        return self._histograms[name]

    def peek(self, name: str):
        """Non-creating lookup: the named counter/gauge/histogram, or
        ``None``. Alert rules use this so watching a metric that a run
        never emits does not materialize an empty stream in the export."""
        if name in self._counters:
            return self._counters[name]
        if name in self._gauges:
            return self._gauges[name]
        if name in self._histograms:
            return self._histograms[name]
        return None

    def to_dict(self) -> Dict:
        return {
            "schema_version": METRICS_SCHEMA_VERSION,
            "counters": {k: c.to_dict()
                         for k, c in sorted(self._counters.items())},
            "gauges": {k: g.to_dict()
                       for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._histograms.items())},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=1)

    def save(self, path: str) -> None:
        atomic_write_text(path, self.to_json() + "\n")
