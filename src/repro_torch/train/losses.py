"""Chunked cross-entropy that never builds the (B, S, V) logits.

Port of ``src/repro/train/losses.py``. The forward walks the sequence in
chunks of ``ce_chunk`` positions, keeping live logits at (B, c, V) and the
per-position log-sum-exp; the backward recomputes each chunk's logits from
it and accumulates the head-weight gradient in fp32, as ``_ce_bwd`` does.
One difference: torch has no fp32-output product of bf16 inputs here, so
each chunk's bf16 ``h^T . dlogits`` is rounded to bf16 before it is added
to the fp32 accumulator (JAX rounds once, at the end); fp32 models are
unaffected.

Over the model axis (``tp``, ``dist.tensor_parallel``) the head splits
over the vocab and each rank holds its slice of the logits: the chunk's
max, its sum of exponentials and the target's logit come from
all-reduces over the model group (the target lies in one rank's slice),
and the backward gives each rank its slice of ``dlogits``, so its shard of
the head's gradient, and its part of ``dh``, which ``tp.enter`` sums.
"""
from __future__ import annotations

import torch


def _chunks(x: torch.Tensor, c: int) -> list[torch.Tensor]:
    return list(x.split(c, dim=1))


def _chunk_lse(logits: torch.Tensor, tp) -> torch.Tensor:
    """The log-sum-exp of a chunk's logits over the whole vocab."""
    if tp is None:
        return torch.logsumexp(logits, dim=-1)
    m = tp.reduce_max(logits.amax(dim=-1))
    return m + torch.log(tp.reduce_sum(torch.exp(logits - m[..., None]).sum(dim=-1)))


def _local_labels(labels: torch.Tensor, v: int, tp):
    """(the labels as indices into this rank's vocab slice of ``v``
    columns, whether each label lies in it)."""
    lo = 0 if tp is None else tp.rank * v
    here = (labels >= lo) & (labels < lo + v)
    return (labels - lo).clamp(0, v - 1).long(), here


class _ChunkedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, labels, c: int, tp):
        b, s, _ = h.shape
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        lses = []
        for hh, ll in zip(_chunks(h, c), _chunks(labels, c)):
            logits = (hh @ w).float()  # (B, c, V), or this rank's slice of V
            lse = _chunk_lse(logits, tp)
            if tp is None:
                picked = torch.gather(logits, -1, ll[..., None].long())[..., 0]
            else:
                idx, here = _local_labels(ll, w.shape[1], tp)
                picked = torch.gather(logits, -1, idx[..., None])[..., 0]
                picked = tp.reduce_sum(torch.where(here, picked, 0.0))
            total = total + (lse - picked).sum()
            lses.append(lse)
        ctx.save_for_backward(h, w, labels, torch.cat(lses, dim=1))
        ctx.c, ctx.tp = c, tp
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
            idx, here = _local_labels(ll, w.shape[1], ctx.tp)
            p.scatter_add_(-1, idx[..., None], torch.where(here, -1.0, 0.0)[..., None])
            dlogits = (p * scale).to(h.dtype)
            dhs.append(dlogits @ w.T)
            dw += (hh.reshape(-1, d).T @ dlogits.reshape(-1, w.shape[1])).float()
        return torch.cat(dhs, dim=1), dw.to(w.dtype), None, None, None


def chunked_cross_entropy(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor, *,
                          ce_chunk: int = 2048, tp=None, vocab: int | None = None
                          ) -> torch.Tensor:
    """Mean token cross-entropy of ``h @ head_w`` against ``labels``.

    h: (B, S, D) final hidden states (already normed); head_w: (D, V);
    labels: (B, S) integer. Returns an fp32 scalar. ``tp``: the model axis;
    ``h`` is then the block boundary's layout (this rank's rows under
    sequence parallelism) and ``head_w`` this rank's vocab slice where it
    is narrower than ``vocab``."""
    if tp is not None:
        split = head_w.shape[1] != vocab
        h = tp.enter(h, partial=split)
        tp = tp if split else None
    s = h.shape[1]
    c = min(ce_chunk, s)
    if s % c:
        c = s  # single chunk for odd lengths
    return _ChunkedCE.apply(h, head_w, labels, c, tp)
