"""Process-wide metrics registry: counters, gauges and histograms over fixed
log-scale buckets, keyed by label values. Stdlib only.

The families and names mirror the reference miner's so that a later
exposition layer can render both alike; this copy keeps the values and a
JSON snapshot, which is all the mining path needs.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Iterable

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "TIME_BUCKETS",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
]

# half-decade steps from 100 us to ~316 s
TIME_BUCKETS: tuple[float, ...] = tuple(round(10.0 ** (e / 2.0), 10) for e in range(-8, 7))


class _Family:
    mtype = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str,
                 labelnames: tuple[str, ...]):
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple, float] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got {tuple(labels)}"
            )
        return tuple(str(labels[ln]) for ln in self.labelnames)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _snapshot_locked(self) -> dict:
        return {"type": self.mtype, "values": {",".join(k): v for k, v in self._values.items()}}


class Counter(_Family):
    mtype = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Family):
    mtype = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)


class Histogram(_Family):
    """Per label set: ``[bucket counts..., +Inf count, sum, count]``."""

    mtype = "histogram"

    def __init__(self, registry, name, help, labelnames, buckets: Iterable[float] | None = None):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in (buckets or TIME_BUCKETS)))
        self._series: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = [0] * (len(self.buckets) + 1) + [0.0, 0]
            series[bisect_left(self.buckets, value)] += 1
            series[-2] += float(value)
            series[-1] += 1

    def _snapshot_locked(self) -> dict:
        return {
            "type": self.mtype,
            "values": {
                ",".join(k): {"sum": s[-2], "count": s[-1]} for k, s in self._series.items()
            },
        }


class MetricsRegistry:
    """All metric families behind one lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(self, name, help, tuple(labelnames), **kw)
            elif type(fam) is not cls or fam.labelnames != tuple(labelnames):
                raise ValueError(f"metric {name!r} re-registered with different type/labels")
            return fam

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help, labelnames=(), buckets=None) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames, buckets=buckets)

    def snapshot(self) -> dict:
        with self._lock:
            return {n: f._snapshot_locked() for n, f in sorted(self._families.items())}


REGISTRY = MetricsRegistry()
counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
