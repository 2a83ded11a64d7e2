"""Serving subsystem of the port: paged KV cache, chunked prefill, the
continuous-batching scheduler and the decode engine."""
from repro_torch.serve.engine import DecodeEngine, EngineReport, TokenEvent
from repro_torch.serve.paging import (
    PagedKV,
    PagingSpec,
    cache_partition_bytes,
    choose_paging,
    init_paged_cache,
    paged_cache_specs,
    paged_to_resident,
)
from repro_torch.serve.prefill import prefill_chunk
from repro_torch.serve.scheduler import ContinuousScheduler, PagePool, Request

__all__ = [
    "ContinuousScheduler", "DecodeEngine", "EngineReport", "PagePool", "PagedKV",
    "PagingSpec", "Request", "TokenEvent", "cache_partition_bytes", "choose_paging",
    "init_paged_cache", "paged_cache_specs", "paged_to_resident", "prefill_chunk",
]
