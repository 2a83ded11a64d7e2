"""Device-memory watermark.

Port of ``src/repro/obs/mem.py``. On CUDA the allocator's high-water mark,
``torch.cuda.max_memory_allocated`` (the peak ``estimate_memory`` predicts;
the caller resets it with ``torch.cuda.reset_peak_memory_stats``). A CPU
device keeps no such count: the watermark is 0 with the source ``"none"``,
so a report never passes a CPU figure off as a device one.
"""
from __future__ import annotations

import torch

from repro_torch.compat import resolve_device


def device_memory_watermark(device=None) -> tuple[int, str]:
    """(bytes, source) of ``device`` (default: CUDA, which raises without a
    card): ``"max_memory_allocated"`` on CUDA, ``(0, "none")`` on the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device)), "max_memory_allocated"
    return 0, "none"
