"""Runtime telemetry of the port: metrics registry and span tracer.

Port of ``src/repro/obs/__init__.py`` without the structured logger: the
registry, the span tracer, the device-memory watermark (``obs.mem``) and the
cost-model drift monitor (``obs.drift``).
``Telemetry`` bundles one registry and one tracer; ``current_telemetry()``
returns the shared no-op ``NULL_TELEMETRY`` unless a caller installed one.
"""
from __future__ import annotations

import contextlib

from repro_torch.obs.drift import DriftMonitor
from repro_torch.obs.mem import device_memory_watermark
from repro_torch.obs.metrics import (
    DOCUMENTED_METRICS,
    NULL_REGISTRY,
    MetricsRegistry,
    quantile,
)
from repro_torch.obs.trace import NULL_TRACER, Span, Tracer


class Telemetry:
    """One registry + tracer. ``Telemetry(trace=False)`` keeps the (cheap)
    registry and drops span retention -- the decode engine's default."""

    def __init__(self, *, metrics: bool = True, trace: bool = True):
        self.registry: MetricsRegistry = MetricsRegistry() if metrics else NULL_REGISTRY
        self.tracer: Tracer = Tracer(enabled=trace)
        self.enabled = metrics or trace


class _NullTelemetry(Telemetry):
    def __init__(self):
        self.registry = NULL_REGISTRY
        self.tracer = NULL_TRACER
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
    "NULL_TRACER", "Span", "Telemetry", "Tracer", "current_telemetry", "device_memory_watermark", "quantile",
    "set_default_telemetry", "use_telemetry",
]
