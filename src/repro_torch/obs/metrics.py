"""Counters, gauges, and histograms behind a pluggable registry.

Dependency-free (stdlib only) so hot paths can emit telemetry without
importing jax or numpy; `percentile` reimplements numpy's default linear
interpolation exactly (unit-tested against ``np.percentile``), so summaries
derived from a `Histogram` match the numpy math they replaced bit-for-bit.

The registry is deliberately dumb: a flat name -> metric map with
get-or-create accessors.  Both `ServeMetrics.to_registry()` and the cluster
orchestrator re-back their summaries onto one of these, so every quantity a
report prints is also available as a typed, exportable metric.

Not thread-safe by design — the serving/cluster tick loops are
single-threaded, and a lock per counter bump would cost more than the bump.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Union

Number = Union[int, float]


def percentile(values: Sequence[Number], q: float) -> float:
    """``np.percentile(values, q)`` (linear interpolation) in pure python."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of empty sequence")
    if len(xs) == 1:
        return xs[0]
    rank = (len(xs) - 1) * (q / 100.0)
    lo = math.floor(rank)
    if lo + 1 >= len(xs):
        return xs[-1]
    frac = rank - lo
    return xs[lo] + (xs[lo + 1] - xs[lo]) * frac


class Counter:
    """Monotonic (by convention) accumulator."""

    kind = "counter"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Number = 0

    def inc(self, n: Number = 1) -> Number:
        self.value += n
        return self.value


class Gauge:
    """Last-value-wins instantaneous reading."""

    kind = "gauge"
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: Optional[Number] = None

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Raw-sample histogram: keeps every observation so percentiles are
    exact (the tick counts here are thousands, not billions — exactness
    beats bucketing while attribution claims ride on p50/p95 numbers)."""

    kind = "histogram"
    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: Number) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    @property
    def total(self) -> float:
        return sum(self.values)

    @property
    def mean(self) -> Optional[float]:
        return self.total / len(self.values) if self.values else None

    def percentile(self, q: float) -> Optional[float]:
        return percentile(self.values, q) if self.values else None

    def summary(self, percentiles: Iterable[float] = (50, 95)
                ) -> Dict[str, Optional[float]]:
        out: Dict[str, Optional[float]] = {
            "count": self.count,
            "total": self.total,
            "mean": self.mean,
            "min": min(self.values) if self.values else None,
            "max": max(self.values) if self.values else None,
        }
        for q in percentiles:
            key = f"p{int(q) if float(q).is_integer() else q}"
            out[key] = self.percentile(q)
        return out


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Flat get-or-create store; re-registering a name as a different
    metric kind is a bug and raises immediately."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view: counters/gauges as scalars, histograms as their
        summary dict."""
        out: Dict[str, object] = {}
        for name in self.names():
            m = self._metrics[name]
            out[name] = (m.summary() if isinstance(m, Histogram)
                         else m.value)
        return out
