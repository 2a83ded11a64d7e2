"""Online cost-model drift monitor: measured-vs-modeled, per step, in situ.

Port of ``src/repro/obs/drift.py``. Construct it with the step's
``Workload`` and ``MemoryPlan`` (it prices the plan once through
``core/cost_model``'s ``estimate_runtime`` / ``estimate_memory``), feed it
each step's wall time and the device-memory watermark (``obs.mem``), and it
keeps rolling predicted-over-measured ratios. On the card this is the check
the paper claims for its cost models.

Ratio orientation: ``predicted / measured``, so a ratio above 1 means the
model over-prices. ``band`` is the symmetric [1/T, T] acceptance band
(default 3.0). ``report()`` carries the per-term modeled decomposition
(t_fwd / t_bwd / optimizer; states / activations / workspace) next to the
end-to-end ratios, so a drifting total can be attributed to the term whose
share the model got wrong.
"""
from __future__ import annotations

import json
import os
from collections import deque

from repro_torch.obs.metrics import NULL_REGISTRY, MetricsRegistry, quantile

SCHEMA_VERSION = 1


class DriftMonitor:
    """Rolling measured-vs-modeled ratios for one (workload, plan) pair.

    ``window`` bounds the rolling step-time median (old steps age out, so a
    mid-run slowdown shows up instead of averaging away). ``registry``
    (optional) receives live ``drift.runtime_ratio`` / ``drift.memory_ratio``
    gauges on every observation.
    """

    def __init__(self, workload, plan, *, window: int = 50, band: float = 3.0,
                 registry: MetricsRegistry | None = None):
        from repro_torch.core.cost_model import estimate_memory, estimate_runtime

        self.runtime = estimate_runtime(workload, plan)
        self.memory = estimate_memory(workload, plan)
        self.plan_desc = plan.describe()
        self.band = float(band)
        self.steps = 0
        self._times: deque[float] = deque(maxlen=window)
        self._mem_peak = 0
        self._mem_source = "none"
        self._reg = registry if registry is not None else NULL_REGISTRY

    # -- observations ---------------------------------------------------------
    def observe_step(self, wall_s: float,
                     device_mem_bytes: int | None = None,
                     mem_source: str = "reported") -> None:
        """One training step: wall time plus (optionally) the device-memory
        watermark measured around it (obs.mem.device_memory_watermark)."""
        self.steps += 1
        self._times.append(float(wall_s))
        if device_mem_bytes is not None and device_mem_bytes > self._mem_peak:
            self._mem_peak = int(device_mem_bytes)
            self._mem_source = mem_source
        self._reg.gauge("drift.runtime_ratio").set(self.runtime_ratio or 0.0)
        self._reg.gauge("drift.memory_ratio").set(self.memory_ratio or 0.0)

    # -- rolling ratios -------------------------------------------------------
    @property
    def measured_step_s(self) -> float | None:
        """Rolling median step time (the straggler-robust center)."""
        if not self._times:
            return None
        return quantile(self._times, 0.5)

    @property
    def runtime_ratio(self) -> float | None:
        m = self.measured_step_s
        if m is None or m <= 0:
            return None
        return self.runtime.t_iteration / m

    @property
    def memory_ratio(self) -> float | None:
        if self._mem_peak <= 0:
            return None
        return self.memory.peak / self._mem_peak

    def in_band(self, ratio: float | None) -> bool | None:
        if ratio is None:
            return None
        return 1.0 / self.band <= ratio <= self.band

    @property
    def ok(self) -> bool:
        """True when every *measured* ratio sits inside the band (an
        unmeasured dimension is not a failure — it is reported as null)."""
        verdicts = [self.in_band(self.runtime_ratio),
                    self.in_band(self.memory_ratio)]
        return all(v is not False for v in verdicts)

    # -- machine-readable report ---------------------------------------------
    def report(self) -> dict:
        rt_ratio = self.runtime_ratio
        mem_ratio = self.memory_ratio
        return {
            "schema": SCHEMA_VERSION,
            "kind": "drift_report",
            "plan": self.plan_desc,
            "band": self.band,
            "steps": self.steps,
            "ok": self.ok,
            "runtime": {
                "predicted_s": self.runtime.t_iteration,
                "measured_median_s": self.measured_step_s,
                "window": len(self._times),
                "ratio": rt_ratio,
                "in_band": self.in_band(rt_ratio),
                # modeled decomposition: where a drifting total should be
                # attributed (shares, not independently measured here)
                "terms": self.runtime.row(),
            },
            "memory": {
                "predicted_bytes": self.memory.peak,
                "measured_peak_bytes": self._mem_peak or None,
                "measured_source": self._mem_source,
                "ratio": mem_ratio,
                "in_band": self.in_band(mem_ratio),
                "terms": self.memory.row(),
            },
        }

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)
            f.write("\n")
        return path
