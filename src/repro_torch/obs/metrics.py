"""Typed metrics registry: counters, gauges, and log-spaced histograms.

Port of `repro.obs.metrics` (stdlib only, so it is the reference's code):
Prometheus-shaped instruments, thread-safe under one registry lock, cheap
enough to stay on unconditionally — unlike spans, metric increments carry
no payload and need no off-switch.

Instruments are label-aware: ``counter("x", labels=("site",)).inc(site="a")``
keeps one series per label-value tuple, exactly the Prometheus data model
`export.prometheus_text` renders.  Histograms use a FIXED log-spaced bucket
ladder (1us .. ~2min, base 2) so latency distributions from different runs
(and from the two packages) are always bucket-compatible and diffable.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS_S",
    "Registry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "reset",
    "snapshot",
]

# 1us -> ~134s in 28 base-2 rungs: wide enough for a plan dispatch and a
# full drain, fixed so every exported histogram is cross-run comparable.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(1e-6 * (2.0 ** i) for i in range(28))


def _label_key(labelnames: Tuple[str, ...], labels: Dict[str, Any]) -> Tuple[str, ...]:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared {sorted(labelnames)}"
        )
    return tuple(str(labels[n]) for n in labelnames)


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock

    def _check_compatible(self, kind: str, labelnames: Sequence[str]) -> None:
        if kind != self.kind or tuple(labelnames) != self.labelnames:
            raise TypeError(
                f"metric {self.name!r} already registered as {self.kind}"
                f"{self.labelnames}, requested {kind}{tuple(labelnames)}"
            )


class Counter(_Instrument):
    """Monotonic float counter; one series per label-value tuple."""

    kind = "counter"

    def __init__(self, name, help, labelnames, lock):
        super().__init__(name, help, labelnames, lock)
        self._series: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease ({amount})")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)


class Gauge(_Instrument):
    """Last-write-wins float; `inc` allows signed adjustments."""

    kind = "gauge"

    def __init__(self, name, help, labelnames, lock):
        super().__init__(name, help, labelnames, lock)
        self._series: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels: Any) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels: Any) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._series.get(key, 0.0)

    def series(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._series)


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative counts in exposition, per-bucket
    internally).  `quantile` interpolates within the winning bucket — good
    enough for p50/p99 reporting, exact enough to rank plans."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(name, help, labelnames, lock)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b
        # per series: [counts per bucket] + [overflow], sum, count
        self._series: Dict[Tuple[str, ...], List[Any]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(self.labelnames, labels)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = [[0] * (len(self.buckets) + 1), 0.0, 0]
            s[0][idx] += 1
            s[1] += value
            s[2] += 1

    def count(self, **labels: Any) -> int:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            return int(s[2]) if s else 0

    def sum(self, **labels: Any) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            return float(s[1]) if s else 0.0

    def quantile(self, q: float, **labels: Any) -> Optional[float]:
        """Approximate q-quantile (0..1) or None for an empty series."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            s = self._series.get(key)
            if s is None or s[2] == 0:
                return None
            counts, total = list(s[0]), s[2]
        rank = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            seen += c
            if seen >= rank and c:
                hi = self.buckets[i] if i < len(self.buckets) else self.buckets[-1]
                lo = self.buckets[i - 1] if 0 < i <= len(self.buckets) else 0.0
                frac = (rank - (seen - c)) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
        return self.buckets[-1]

    def series(self) -> Dict[Tuple[str, ...], Dict[str, Any]]:
        with self._lock:
            return {
                k: {"buckets": list(s[0]), "sum": s[1], "count": s[2]}
                for k, s in self._series.items()
            }


class Registry:
    """Get-or-create instrument registry (idempotent; kind-checked)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        with self._lock:
            got = self._metrics.get(name)
        if got is not None:
            got._check_compatible(cls.kind, labels)
            return got
        inst = cls(name, help, tuple(labels), self._lock, **kw)
        with self._lock:
            # lost a race: keep the first registration
            return self._metrics.setdefault(name, inst)

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def metrics(self) -> List[_Instrument]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """JSON-able view: {name: {kind, labels, series}} with label tuples
        flattened to 'k=v,k=v' strings."""
        out: Dict[str, Dict[str, Any]] = {}
        for m in self.metrics():
            series = {
                ",".join(f"{n}={v}" for n, v in zip(m.labelnames, key)): val
                for key, val in m.series().items()
            }
            out[m.name] = {
                "kind": m.kind,
                "help": m.help,
                "labels": list(m.labelnames),
                "series": series,
            }
        return out

    def reset(self) -> None:
        """Test hook: drop every instrument."""
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
