"""Chunked prefill: ingest up to ``C`` prompt tokens per slot in one call.

Port of ``src/repro/serve/prefill.py``. A loop of ``C`` single-token decode
steps over a (B, C) token block -- per-slot start positions, per-slot token
counts. Each step is *the* decode step (``models.kvcache.decode_step``) with
an ``active = t < n_tok`` slot mask, so the ops run for active slots are
exactly those of token-by-token teacher-forced replay. Steps past the
longest slot's count write nothing and select nothing, so the loop stops
there.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache as KV
from repro_torch.models.layers import torch_dtype


def prefill_chunk(params: dict, cache: dict, tokens: torch.Tensor, pos, n_tok,
                  cfg: ModelConfig, *, kv_io=None):
    """Feed ``tokens[b, :n_tok[b]]`` into slot b's cache from ``pos[b]`` on.

    tokens: (B, C) on the model's device; pos, n_tok: (B,) ints, read on the
    host. Returns ``(last_logits, cache)``: ``last_logits[b]`` are the logits
    of slot b's final fed token (zeros where ``n_tok == 0``); the cache is
    written in place.
    """
    b, c = tokens.shape
    pos = KV.host_positions(pos)
    n_tok = KV.host_positions(n_tok)
    last = torch.zeros((b, cfg.vocab_size), dtype=torch_dtype(cfg.dtype), device=tokens.device)
    steps = min(c, int(n_tok.max())) if b else 0
    for t in range(steps):
        active = t < n_tok
        logits, cache = KV.decode_step(params, cache, tokens[:, t:t + 1], pos + t, cfg,
                                       kv_io=kv_io, active=active)
        take = (t == n_tok - 1).to(tokens.device)
        last = torch.where(take[:, None], logits, last)
    return last, cache
