"""Serving memory planning: the page geometry a serve plan encodes.

Port of ``src/repro/core/serve_plan.py:43-101``: the module page size,
``default_paging_spec`` and ``paging_from_plan`` (a serve plan's ``n_host``
counts cold KV-cache pages). The planner search (``serve_plan``) comes with
the planner slice.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.models import kvcache as KV
from repro_torch.serve.paging import PagingSpec, choose_paging

# Default page size (tokens).
PAGE_SIZE = 256


def default_paging_spec(cfg: ModelConfig, shape: ShapeConfig,
                        n_hot: int | None = None) -> PagingSpec:
    """PagingSpec for this (cfg, shape) at the module page size; ``n_hot``
    None means fully hot (no cold pages)."""
    s_kv = KV.cache_len(cfg, shape.seq_len)
    # resolve the page geometry first (the page size may shrink to a divisor
    # of s_kv), then clamp the hot request against it
    base = choose_paging(s_kv, PAGE_SIZE, 1)
    return choose_paging(s_kv, base.page_size,
                         base.n_pages if n_hot is None else n_hot)


def paging_from_plan(cfg: ModelConfig, shape: ShapeConfig, plan: MemoryPlan):
    """The PagingSpec a serve plan's ``n_host`` (cold pages) encodes; None for
    resident plans. A hand-written ``n_host`` whose complement does not
    divide the page count is clamped (``choose_paging``)."""
    if plan.cold_kv_pages <= 0:
        return None
    full = default_paging_spec(cfg, shape)
    n_hot = max(1, full.n_pages - plan.cold_kv_pages)
    return choose_paging(full.cache_len, full.page_size, n_hot)
