"""Chunked cross-entropy that never builds the (B, S, V) logits.

Port of ``src/repro/train/losses.py``. The forward walks the sequence in
chunks of ``ce_chunk`` positions, keeping live logits at (B, c, V) and the
per-position log-sum-exp; the backward recomputes each chunk's logits from
it and accumulates the head-weight gradient in fp32, as ``_ce_bwd`` does.
One difference: torch has no fp32-output product of bf16 inputs here, so
each chunk's bf16 ``h^T . dlogits`` is rounded to bf16 before it is added
to the fp32 accumulator (JAX rounds once, at the end); fp32 models are
unaffected.
"""
from __future__ import annotations

import torch


def _chunks(x: torch.Tensor, c: int) -> list[torch.Tensor]:
    return list(x.split(c, dim=1))


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, c: int):
        b, s, _ = h.shape
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for hh, ll in zip(_chunks(h, c), _chunks(labels, c)):
            logits = (hh @ w).float()  # (B, c, V)
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(logits, -1, ll[..., None].long())[..., 0]
            total = total + (lse - picked).sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, labels, torch.cat(lses, dim=1))
        ctx.c = c
        return total / (b * s)

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lses = ctx.saved_tensors
        b, s, d = h.shape
        scale = g / (b * s)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dhs = []
        for hh, ll, lse in zip(_chunks(h, ctx.c), _chunks(labels, ctx.c), _chunks(lses, ctx.c)):
            logits = (hh @ w).float()
            p = torch.exp(logits - lse[..., None])
            p.scatter_add_(-1, ll[..., None].long(), torch.full_like(lse[..., None], -1.0))
            dlogits = (p * scale).to(h.dtype)
            dhs.append(dlogits @ w.T)
            dw += (hh.reshape(-1, d).T @ dlogits.reshape(-1, w.shape[1])).float()
        return torch.cat(dhs, dim=1), dw.to(w.dtype), None, None


def chunked_cross_entropy(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor, *,
                          ce_chunk: int = 2048) -> torch.Tensor:
    """Mean token cross-entropy of ``h @ head_w`` against ``labels``.

    h: (B, S, D) final hidden states (already normed); head_w: (D, V);
    labels: (B, S) integer. Returns an fp32 scalar."""
    s = h.shape[1]
    c = min(ce_chunk, s)
    if s % c:
        c = s  # single chunk for odd lengths
    return _ChunkedCE.apply(h, head_w, labels, c)
