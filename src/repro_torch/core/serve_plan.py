"""Serving (prefill/decode) memory planning.

Port of ``src/repro/core/serve_plan.py``. Serving has no gradients or
optimizer states, so chunk management degenerates to persist-vs-gather for
weights, plus a second memory tier for the *cache*: ``MemoryPlan.n_host``
on a serve plan counts KV-cache pages offloaded to host memory (cold
pages). ``serve_plan``:

  1. keeps everything resident when weights + cache fit inside
     ``hw.serve_resident_headroom`` of the budget (``hw.capacity_bytes()``);
  2. otherwise, while the weight stack alone still fits, pages the KV
     cache: the largest hot window that fits and whose cold-page fetches
     drain inside the decode compute window (``page_fetch_feasible``), else
     the largest that fits, else the one-page window;
  3. only when the weights themselves overflow does it ZeRO-shard the
     weight stack.

``paging_from_plan`` is the inverse mapping the step builder uses: a serve
plan's ``n_host`` back to a ``serve.paging.PagingSpec``.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.chunks import chunk_inventory
from repro_torch.core.hardware import HardwareSpec, MeshSpec
from repro_torch.core.plan import MemoryPlan
from repro_torch.models import kvcache as KV
from repro_torch.models.model import num_repeats
from repro_torch.serve.paging import PagingSpec, cache_partition_bytes, choose_paging

# Default page size (tokens): a page's host-to-device transfer is
# bandwidth-bound, and the hot-window search keeps resolution at long contexts.
PAGE_SIZE = 256


def cache_bytes_per_device(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec) -> float:
    specs = KV.cache_specs(cfg, shape.global_batch, shape.seq_len)
    total = 0
    for entry in specs.values():
        for shp, dt in entry.values():
            n = dt.itemsize
            for d in shp:
                n *= d
            total += n
    # batch over ZeRO axes; seq (attention) / heads over TP
    return total / (mesh.zero_degree * mesh.tp_degree)


def _paged_parts_per_device(cfg, shape, mesh: MeshSpec, spec) -> dict[str, float]:
    """serve.paging.cache_partition_bytes scaled to per-device shards."""
    parts = cache_partition_bytes(cfg, shape.global_batch, shape.seq_len, spec)
    scale = mesh.zero_degree * mesh.tp_degree
    return {k: v / scale for k, v in parts.items()}


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


def serve_plan(cfg: ModelConfig, shape: ShapeConfig, mesh: MeshSpec, hw: HardwareSpec) -> MemoryPlan:
    from repro_torch.core.cost_model import page_fetch_feasible

    chunks = chunk_inventory(cfg)
    nc, nb = len(chunks), num_repeats(cfg)
    weights_dev = sum(c.param_bytes for c in chunks) / mesh.tp_degree
    cache_dev = cache_bytes_per_device(cfg, shape, mesh)
    budget = hw.capacity_bytes()
    if weights_dev + cache_dev < hw.serve_resident_headroom * budget:
        return MemoryPlan(n_chunks=nc, n_blocks=nb, n_persist=nc)

    # page the cache: the cache is the overflowing tenant whenever the
    # weight stack alone still fits — prefer host pages over weight
    # sharding then. Candidate hot windows are scanned largest-first (most
    # HBM use -> least host traffic); the first fetch-feasible one wins,
    # else the largest that fits at all (a slow link beats an OOM), else
    # the minimum-HBM one-page window.
    if shape.mode == "decode" and not cfg.attention_free:
        full = default_paging_spec(cfg, shape)
        fitting: list = []
        for n_hot in range(full.n_pages - 1, 0, -1):
            if full.n_pages % n_hot:
                continue  # hot window must tile the page ring
            spec = default_paging_spec(cfg, shape, n_hot)
            parts = _paged_parts_per_device(cfg, shape, mesh, spec)
            dev_cache = parts["hbm"] + parts["transient"]
            if weights_dev + dev_cache < hw.serve_resident_headroom * budget:
                fitting.append(spec)
        chosen = None
        for spec in fitting:
            if page_fetch_feasible(cfg, shape, mesh, hw, spec):
                chosen = spec
                break
        if chosen is None and fitting:
            chosen = fitting[0]
        if chosen is None and full.n_pages > 1 and (
                weights_dev < hw.serve_resident_headroom * budget):
            chosen = default_paging_spec(cfg, shape, 1)
        if chosen is not None:
            return MemoryPlan(n_chunks=nc, n_blocks=nb, n_persist=nc,
                              n_host=chosen.n_cold)

    # weights are the overflowing tenant (or paging cannot apply): ZeRO-shard
    # the stack and gather per layer. Combining sharded weights with paged
    # caches in one plan is future work — n_host on a non-all-persistent plan
    # still means host-resident weight chunks (training semantics).
    return MemoryPlan(n_chunks=nc, n_blocks=nb, n_persist=0)


def serve_memory_estimate(cfg, shape, mesh: MeshSpec, plan: MemoryPlan) -> dict:
    """Per-device memory picture of a serve plan.

    Keys: ``weights_gb``, ``cache_gb`` (device-resident cache: the full
    cache for resident plans, hot rings + one layer's gathered transient for
    paged ones), ``host_cache_gb`` (cold pages), ``peak_gb`` (device).
    """
    chunks = chunk_inventory(cfg)
    weights = sum(c.param_bytes for c in chunks)
    if plan.n_persist == plan.n_chunks:
        w_dev = weights / mesh.tp_degree
    else:
        blk = max((c.param_bytes for c in chunks if c.is_block), default=0)
        w_dev = weights / (mesh.tp_degree * mesh.zero_degree) + 2 * blk / mesh.tp_degree
    spec = paging_from_plan(cfg, shape, plan)
    if spec is None:
        cache = cache_bytes_per_device(cfg, shape, mesh)
        host_cache = 0.0
    else:
        parts = _paged_parts_per_device(cfg, shape, mesh, spec)
        cache = parts["hbm"] + parts["transient"]
        host_cache = parts["host"]
    return {
        "weights_gb": w_dev / 1e9,
        "cache_gb": cache / 1e9,
        "host_cache_gb": host_cache / 1e9,
        "peak_gb": (w_dev + cache) / 1e9,
    }
