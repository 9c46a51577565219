"""Counter / gauge / histogram primitives and a flat-named registry.

Subsumes the ad-hoc stats scattered through the runtime: ``StorageIOQueue``
depth and per-op read/write latency, ``HostCache`` hit/miss/eviction/bytes,
``BufferPool`` occupancy, ``EmbeddingServer`` lookup latency (which used to
keep its own sliding window of raw samples). Everything lives under one
:class:`MetricsRegistry` (reached as ``Counters.metrics``), snapshots to a
flat ``{name: value-or-dict}`` dict, and dumps as JSON.

Histograms use exponential buckets (growth 1.2 by default, ~10 buckets per
decade) so quantile estimates via geometric within-bucket interpolation stay
within ±10% of the true value — comfortably inside the ±20% consistency
budget the serving benchmark asserts against the old sliding-window numbers.
``observe`` is O(log #buckets) with one small lock; gauges may wrap a
callback so hot paths pay nothing until a snapshot polls them.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Callable, Dict, Optional


class Counter:
    """Monotonic accumulator (float-valued so byte/second totals fit)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def snapshot(self):
        return self._value


class Gauge:
    """Last-written value, or — with ``fn`` — a callback polled only at
    snapshot time (zero hot-path cost for queue depth / cache bytes)."""

    __slots__ = ("name", "_value", "_fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        self._value = value

    @property
    def value(self) -> float:
        return self.snapshot()

    def reset(self) -> None:
        if self._fn is None:
            self._value = 0.0

    def snapshot(self):
        if self._fn is not None:
            try:
                return self._fn()
            except Exception:
                return float("nan")
        return self._value


class Histogram:
    """Exponential-bucket latency histogram with interpolated quantiles.

    Bucket ``i`` counts observations in ``(bounds[i-1], bounds[i]]`` where
    ``bounds[i] = start * growth**i``; one overflow bucket catches the tail.
    Exact ``min``/``max``/``sum``/``count`` ride along, and quantiles clamp
    to the observed min/max so a single-sample histogram reports that sample
    exactly.
    """

    __slots__ = ("name", "_bounds", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, start: float = 1e-6, growth: float = 1.2,
                 n_buckets: int = 96):
        if growth <= 1.0:
            raise ValueError("growth must be > 1")
        self.name = name
        self._bounds = [start * growth ** i for i in range(n_buckets)]
        self._counts = [0] * (n_buckets + 1)   # +1 overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += value
            if value < self._min:
                self._min = value
            if value > self._max:
                self._max = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-th percentile (``0 <= q <= 100``) by walking
        cumulative bucket counts and interpolating geometrically inside the
        target bucket, clamped to the observed min/max."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            counts = list(self._counts)
            lo, hi = self._min, self._max
        rank = max(0.0, min(100.0, q)) / 100.0 * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                frac = min(1.0, max(0.0, (rank - cum) / c))
                b_hi = self._bounds[i] if i < len(self._bounds) else hi
                b_lo = self._bounds[i - 1] if i > 0 else min(lo, b_hi)
                b_lo = max(b_lo, 1e-12)
                b_hi = max(b_hi, b_lo)
                est = b_lo * (b_hi / b_lo) ** frac
                return min(max(est, lo), hi)
            cum += c
        return hi

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def snapshot(self):
        with self._lock:
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0, "p50": 0.0, "p99": 0.0}
            count, s = self._count, self._sum
            mn, mx = self._min, self._max
        return {
            "count": count,
            "sum": s,
            "mean": s / count,
            "min": mn,
            "max": mx,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Name → instrument map shared by every component that holds the same
    :class:`~repro_torch.core.counters.Counters`.

    ``counter``/``gauge``/``histogram`` are get-or-create: re-registering a
    name returns the existing instrument of that kind (so a component may be
    rebuilt against the same counters), but a fresh ``fn`` on a gauge
    rebinds the callback — last registration wins, which matters when e.g.
    two ``StorageIOQueue`` instances share one registry.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}"
                )
            return m

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, Counter, lambda: Counter(name))

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get_or_create(name, Gauge, lambda: Gauge(name, fn))
        if fn is not None:
            g._fn = fn
        return g

    def histogram(self, name: str, start: float = 1e-6, growth: float = 1.2,
                  n_buckets: int = 96) -> Histogram:
        return self._get_or_create(
            name, Histogram,
            lambda: Histogram(name, start=start, growth=growth,
                              n_buckets=n_buckets),
        )

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        """Flat ``{name: scalar-or-dict}`` of every registered instrument;
        histogram entries are dicts with count/sum/mean/min/max/p50/p99."""
        with self._lock:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in sorted(items)}

    def dump_json(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True,
                      default=float)
        return path

    def reset(self) -> None:
        """Zero counters/histograms and non-callback gauges (callback
        gauges re-poll live state, so there is nothing to clear)."""
        with self._lock:
            items = list(self._metrics.values())
        for m in items:
            m.reset()
