"""Baseline planners emulating the frameworks the paper compares against.

The paper benchmarks ProTrain vs DeepSpeed (ZeRO-3 + offload, threshold
tuning), Colossal-AI (Gemini chunk manager, static placement), and FSDP
(flat-param ZeRO-3, all-or-nothing checkpointing). We reproduce each as a
*fixed policy* in our plan space so the benchmark harness can compare them
through the same cost models — the apples-to-apples adaptation of the paper's
framework comparison (the mechanisms, not the marketing).
"""
from __future__ import annotations

from repro_torch.core.cost_model import Workload, estimate_memory
from repro_torch.core.plan import MemoryPlan


def fsdp_plan(w: Workload, capacity: float, offload: bool = False) -> MemoryPlan:
    """FSDP: everything sharded, no persistence/buffering, checkpointing is
    all-or-nothing, optional uniform CPU offload."""
    nc, nb = w.n_chunks, w.n_blocks
    for ckpt_all in (False, True):
        for host in ([0] if not offload else [0, nc]):
            plan = MemoryPlan(nc, nb, n_checkpoint=nb if ckpt_all else 0, n_host=host)
            if estimate_memory(w, plan).peak < capacity:
                return plan
    return MemoryPlan(nc, nb, n_checkpoint=nb, n_host=nc if offload else 0)


def deepspeed_plan(w: Workload, capacity: float) -> MemoryPlan:
    """DeepSpeed ZeRO-3 + offload: params/optimizer offloaded wholesale,
    checkpointing all blocks, a threshold-style live-parameter window (we
    model it as a small fixed buffer count — the paper's critique is exactly
    that these thresholds are static)."""
    nc, nb = w.n_chunks, w.n_blocks
    plan = MemoryPlan(nc, nb, n_checkpoint=nb, n_host=nc, n_buffer=0)
    return plan


def colossal_plan(w: Workload, capacity: float) -> MemoryPlan:
    """Colossal-AI Gemini: chunk-based ZeRO-3, static placement — as many
    chunk shards kept in device memory as fit (no execution-order awareness,
    no buffering), checkpointing all blocks."""
    nc, nb = w.n_chunks, w.n_blocks
    # static placement: fill device with persistent chunks from the *front in
    # declaration order* (== execution order here), remainder to host
    lo, hi = 0, nc
    best = MemoryPlan(nc, nb, n_checkpoint=nb, n_host=nc)
    while lo <= hi:
        mid = (lo + hi) // 2
        plan = MemoryPlan(nc, nb, n_persist=0, n_host=nc - mid, n_checkpoint=nb)
        if estimate_memory(w, plan).peak < capacity:
            best = plan
            lo = mid + 1
        else:
            hi = mid - 1
    return best


BASELINES = {
    "fsdp": lambda w, cap: fsdp_plan(w, cap),
    "fsdp_offload": lambda w, cap: fsdp_plan(w, cap, offload=True),
    "deepspeed": deepspeed_plan,
    "colossalai": colossal_plan,
}
