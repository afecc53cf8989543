"""Exact-percentile histogram (the part of the reference's ``obs/metrics.py``
the fleet report and the router's hedging threshold use).

``percentile(q)`` and ``quantile(q)`` reproduce ``np.percentile`` /
``np.quantile`` on the retained sample bit-for-bit, as the reference's
``Histogram`` does, so the port's report quantiles and hedging decisions
equal the reference's for the same observations.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np

Number = Union[int, float]


class Histogram:
    __slots__ = ("values", "name")

    def __init__(self, name: str = ""):
        self.values: List[float] = []
        self.name = name

    def observe(self, value: Number) -> None:
        self.values.append(float(value))

    @property
    def count(self) -> int:
        return len(self.values)

    def percentile(self, q: float) -> float:
        """Exact percentile (q in [0, 100]); raises on an empty histogram."""
        if not self.values:
            raise ValueError(f"percentile({q:g}) of empty histogram "
                             f"{self.name or 'histogram'!r}")
        return float(np.percentile(np.asarray(self.values), q))

    def quantile(self, q: float) -> float:
        """Exact quantile (q in [0, 1]) over the float64 sample."""
        if not self.values:
            raise ValueError(f"quantile({q:g}) of empty histogram "
                             f"{self.name or 'histogram'!r}")
        return float(np.quantile(np.asarray(self.values, np.float64), q))
