"""Zero-dependency metrics registry: counters, gauges, histograms.

The registry is the runtime bookkeeping layer ProTrain's profiler feeds
(§3.2's "precise estimates" need a measured counterpart): plain Python,
thread-safe, and cheap enough to leave on in serving hot loops — one dict
lookup plus a float add per operation, with the labeled-series handle
cacheable by the instrumented call site.

Series are identified by ``(name, sorted(labels))``. Three kinds:

  * ``Counter``   — monotone accumulator (``inc``), e.g. ticks, h2d bytes;
  * ``Gauge``     — last-write-wins level (``set``), e.g. pool occupancy,
    per-step wire-byte inventory, device-memory watermark (``set_max``);
  * ``Histogram`` — raw-sample series (``observe``) with nearest-rank
    quantiles, e.g. step wall time, inter-token latency.

``MetricsRegistry.snapshot()`` renders everything to one plain dict (JSON-
ready); ``NULL_REGISTRY`` is the shared no-op twin instrumented code uses
when telemetry is off, so call sites never branch.

Metric names used by the port's instrumentation are enumerated in
``DOCUMENTED_METRICS``.
"""
from __future__ import annotations

import math
import threading


def quantile(values, q: float) -> float:
    """Nearest-rank quantile over an unsorted sequence.

    Edge cases are pinned (and unit-tested) because serving reports lean on
    them: an empty series returns 0.0 ("no data", NOT "zero latency" — the
    caller sees n == 0 in the same snapshot and must disambiguate there); a
    1-sample series returns that sample for every q in [0, 1]; q <= 0 is the
    minimum and q >= 1 the maximum.
    """
    xs = sorted(values)
    if not xs:
        return 0.0
    idx = min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))
    return xs[idx]


class Counter:
    """Monotone accumulator. ``inc`` with a negative amount raises."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name, self.labels = name, labels
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        self.value += amount


class Gauge:
    """Last-write-wins level; ``set_max`` keeps a high-watermark."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: tuple):
        self.name, self.labels = name, labels
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def set_max(self, value: float) -> None:
        if value > self.value:
            self.value = float(value)


class Histogram:
    """Raw-sample series with nearest-rank quantiles.

    Samples are retained verbatim up to ``max_samples`` (default 1 << 16),
    then reservoir-free head truncation stops growth: the summary keeps
    count/sum exact and quantiles become the tail window's. Training and
    serving runs here are far below the cap; the cap only bounds memory on
    very long residencies.
    """

    __slots__ = ("name", "labels", "samples", "count", "total", "max_samples")

    def __init__(self, name: str, labels: tuple, max_samples: int = 1 << 16):
        self.name, self.labels = name, labels
        self.samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.max_samples = max_samples

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        self.samples.append(float(value))
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def q(self, qq: float) -> float:
        return quantile(self.samples, qq)


def _series_key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


class MetricsRegistry:
    """Labeled-series store. Handle creation is locked; the handles
    themselves are single-writer by convention (one engine/loop thread), and
    float ops on them are GIL-atomic enough for the cross-thread readers the
    snapshot path serves."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[tuple, Counter | Gauge | Histogram] = {}

    def _get(self, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        got = self._series.get(key)
        if got is None:
            with self._lock:
                got = self._series.setdefault(key, cls(name, key[1]))
        if not isinstance(got, cls):
            raise TypeError(f"metric {name}{labels} already registered as "
                            f"{type(got).__name__}, requested {cls.__name__}")
        return got

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def names(self) -> set[str]:
        with self._lock:
            return {name for name, _ in self._series}

    def snapshot(self) -> dict:
        """One JSON-ready dict: ``{name{label=v,...}: summary}``. Counters
        and gauges render their value; histograms a count/sum/quantile
        summary."""
        out: dict[str, dict] = {}
        with self._lock:
            series = list(self._series.values())
        for s in series:
            lbl = ",".join(f"{k}={v}" for k, v in s.labels)
            key = f"{s.name}{{{lbl}}}" if lbl else s.name
            if isinstance(s, Counter):
                out[key] = {"type": "counter", "value": s.value}
            elif isinstance(s, Gauge):
                out[key] = {"type": "gauge", "value": s.value}
            else:
                out[key] = {
                    "type": "histogram", "count": s.count, "sum": s.total,
                    "mean": s.mean,
                    "p50": s.q(0.50), "p99": s.q(0.99), "max": s.q(1.0),
                }
        return out


class _NullSeries:
    """Shared no-op handle: every mutator is a pass, so disabled-telemetry
    call sites pay one attribute lookup and a no-op call."""

    __slots__ = ()
    name = "null"
    labels = ()
    value = 0.0
    count = 0
    total = 0.0
    mean = 0.0
    samples: list[float] = []

    def inc(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def set_max(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    def q(self, qq: float) -> float:
        return 0.0


_NULL_SERIES = _NullSeries()


class NullRegistry(MetricsRegistry):
    """Disabled registry: hands out the shared no-op series and snapshots
    empty. Instrumented code never branches on enablement."""

    def __init__(self):
        super().__init__()

    def counter(self, name: str, **labels):
        return _NULL_SERIES

    gauge = counter
    histogram = counter

    def snapshot(self) -> dict:
        return {}


NULL_REGISTRY = NullRegistry()


# Metric names the port's instrumentation emits (serve/engine.py and
# serve/scheduler.py); the JAX package's table is docs/observability.md.
DOCUMENTED_METRICS = (
    "serve.ticks",
    "serve.generated_tokens",
    "serve.admitted",
    "serve.evictions",
    "serve.rejected",
    "serve.truncated",
    "serve.finished",
    "serve.h2d_bytes",
    "serve.pagepool_free",
    "serve.pagepool_occupancy",
    "serve.itl_s",
)
