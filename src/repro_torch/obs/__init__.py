"""Runtime telemetry of the port: metrics registry, span tracer, logger.

Port of ``src/repro/obs/__init__.py``: the registry, the span tracer, the
structured logger (``obs.logging``), the device-memory watermark
(``obs.mem``) and the cost-model drift monitor (``obs.drift``).
``Telemetry`` bundles one registry, one tracer and one logger;
``current_telemetry()`` returns the shared no-op ``NULL_TELEMETRY`` unless
a caller installed one.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.logging import StructuredLogger, as_logger
from repro_torch.obs.mem import device_memory_watermark
from repro_torch.obs.metrics import (
    DOCUMENTED_METRICS,
    NULL_REGISTRY,
    MetricsRegistry,
    quantile,
)
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer


class Telemetry:
    """One registry + tracer + logger. ``Telemetry(trace=False)`` keeps the
    (cheap) registry and drops span retention -- the decode engine's
    default."""

    def __init__(self, *, metrics: bool = True, trace: bool = True,
                 logger: StructuredLogger | None = None, name: str = "repro"):
        self.registry: MetricsRegistry = MetricsRegistry() if metrics else NULL_REGISTRY
        self.tracer: Tracer = Tracer(enabled=trace)
        self.log: StructuredLogger = logger if logger is not None else StructuredLogger(name)
        self.enabled = metrics or trace


class _NullTelemetry(Telemetry):
    def __init__(self):
        self.registry = NULL_REGISTRY
        self.tracer = NULL_TRACER
        self.log = StructuredLogger("null", sink=None, min_level="error", max_records=0)
        self.enabled = False


NULL_TELEMETRY = _NullTelemetry()

_default: Telemetry | None = None


def set_default_telemetry(tel: Telemetry | None) -> None:
    global _default
    _default = tel


def current_telemetry() -> Telemetry:
    return _default if _default is not None else NULL_TELEMETRY


@contextlib.contextmanager
def use_telemetry(tel: Telemetry):
    """Scoped ``set_default_telemetry`` (restores the previous handle)."""
    global _default
    prev = _default
    _default = tel
    try:
        yield tel
    finally:
        _default = prev


__all__ = [
    "DOCUMENTED_METRICS", "DriftMonitor", "MetricsRegistry", "NULL_REGISTRY", "NULL_TELEMETRY",
    "NULL_TRACER", "Span", "StructuredLogger", "Telemetry", "Tracer", "as_logger",
    "current_telemetry", "device_memory_watermark", "quantile", "set_default_telemetry",
    "use_telemetry",
]
