"""Plain PyTorch versions of the ported kernels.

Op for op the oracles of ``src/repro/kernels/ref.py`` (``rmsnorm_ref``,
``paged_attention_ref``). The CPU path of the kernels package runs these,
and the tests and ``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

import math

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * scale


def paged_attention_ref(q, k_hot, v_hot, k_cold, v_cold, sel, mask):
    """Materialise the ring view (cache row ``r`` lives at ring row
    ``r % hot_window``), select the canonical rows, then run
    ``_masked_decode_attn``'s op sequence.

    q: (B, 1, Hq, hd); k/v_hot: (B, W, Hkv, hd); k/v_cold: (B, S, Hkv, hd),
    on q's device or in host memory; sel: (B, S) bool (True -> ring
    canonical); mask: (B, S) fp32 additive.
    """
    b, _, hq, hd = q.shape
    s_kv, hkv = k_cold.shape[1], k_cold.shape[2]
    w = k_hot.shape[1]
    g = hq // hkv
    dev = q.device
    rows = torch.arange(s_kv, device=dev) % w
    s = sel.to(dev)[..., None, None]
    # stream-ordered copies: a pinned cold store is read without a host sync
    k = torch.where(s, k_hot[:, rows], k_cold.to(dev, non_blocking=True))
    v = torch.where(s, v_hot[:, rows], v_cold.to(dev, non_blocking=True))
    qh = (q.float() / math.sqrt(hd)).reshape(b, hkv, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qh, k.float())
    logits = logits + mask.to(dev)[:, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)
