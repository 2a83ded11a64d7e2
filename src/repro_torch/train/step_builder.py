"""Serving step builders: one decode step and one chunked-prefill step.

Port of the serving builders of ``src/repro/train/step_builder.py``
(``build_decode_step(per_slot_pos=True)`` and ``build_prefill_step(chunk=C)``,
``:756-923``) for one device and an all-persistent weight placement. Each
builder returns a ``StepArtifacts`` whose ``fn(state, batch)`` runs the step
under ``torch.inference_mode`` and returns ``(state, next_tok)``, the greedy
argmax taken on the device. ``state`` is ``{"params", "cache"}``; the cache
is written in place; the step runs where the state's tensors lie. The
training builders come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.serve_plan import paging_from_plan
from repro_torch.models import kvcache as KV
from repro_torch.serve.paging import PagedKV, PagingSpec


@dataclasses.dataclass
class StepArtifacts:
    fn: Callable[[dict, dict], tuple[dict, torch.Tensor]]
    paging: PagingSpec | None
    kv_io: Any  # the cache hook the step threads through decode_step


def _serve_layout(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig,
                  paging: PagingSpec | None) -> tuple[PagingSpec | None, Any]:
    if plan.n_persist != plan.n_chunks:
        raise NotImplementedError(
            f"serving plan {plan.describe()}: only an all-persistent weight placement "
            "runs on one device (ROADMAP.md, the planner and distributed slices)")
    if paging is None:
        paging = paging_from_plan(cfg, shape, plan)
    kv_io = KV.RESIDENT_KV if paging is None else PagedKV(paging)
    return paging, kv_io


def build_decode_step(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig,
                      *, paging: PagingSpec | None = None,
                      per_slot_pos: bool = True) -> StepArtifacts:
    """Decode step. batch: ``tokens`` (B, 1) on the device, ``pos`` () or
    (B,) on the host (per slot with ``per_slot_pos``), optional ``active``
    (B,) host bool masking cache writes of slots sitting the step out."""
    paging, kv_io = _serve_layout(cfg, plan, shape, paging)

    def step_fn(state: dict, batch: dict):
        pos = batch["pos"]
        if per_slot_pos != (torch.as_tensor(pos).ndim == 1):
            raise ValueError(f"pos shape {tuple(torch.as_tensor(pos).shape)} does not "
                             f"match per_slot_pos={per_slot_pos}")
        with torch.inference_mode():
            logits, _ = KV.decode_step(state["params"], state["cache"], batch["tokens"],
                                       pos, cfg, kv_io=kv_io, active=batch.get("active"))
            next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return state, next_tok

    return StepArtifacts(fn=step_fn, paging=paging, kv_io=kv_io)


def build_prefill_step(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig,
                       *, chunk: int, paging: PagingSpec | None = None) -> StepArtifacts:
    """Chunked prefill (serve/prefill.py). batch: ``tokens`` (B, C) on the
    device, ``pos`` and ``n_tok`` (B,) on the host. The full-sequence
    stateless prefill (``chunk=None`` in the JAX package) comes with the
    training slice's parallel forward."""
    from repro_torch.serve.prefill import prefill_chunk

    paging, kv_io = _serve_layout(cfg, plan, shape, paging)

    def step_fn(state: dict, batch: dict):
        if batch["tokens"].shape[1] != chunk:
            raise ValueError(f"prefill block {tuple(batch['tokens'].shape)} != chunk {chunk}")
        with torch.inference_mode():
            last, _ = prefill_chunk(state["params"], state["cache"], batch["tokens"],
                                    batch["pos"], batch["n_tok"], cfg, kv_io=kv_io)
            next_tok = torch.argmax(last, dim=-1).to(torch.int32)
        return state, next_tok

    return StepArtifacts(fn=step_fn, paging=paging, kv_io=kv_io)
