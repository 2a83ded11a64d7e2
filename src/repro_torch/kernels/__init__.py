"""Kernel dispatch by the tensor's device.

A CPU tensor gets the plain PyTorch version (``ref.py``); a CUDA tensor gets
the hand-written kernel, which raises on anything it does not take. There is
no fallback from one to the other. Launch counts of the kernels:
``launch_counts`` / ``reset_launch_counts``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import launch_counts, reset_launch_counts


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if _route(x, "rmsnorm"):
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda

        return rmsnorm_cuda(x, scale, eps)
    return ref.rmsnorm_ref(x, scale, eps)


def decode_paged_attention(q, k_hot, v_hot, k_cold, v_cold, sel, mask, *, n_hot: int):
    """Decode attention over the paged layout (serve/paging.PagedKV); routed
    by q's device (the cold store may lie in pinned host memory)."""
    if _route(q, "paged_attention"):
        from repro_torch.kernels.paged_attention import paged_attention_cuda

        return paged_attention_cuda(q, k_hot, v_hot, k_cold, v_cold, sel, mask, n_hot=n_hot)
    return ref.paged_attention_ref(q, k_hot, v_hot, k_cold, v_cold, sel, mask)


__all__ = ["decode_paged_attention", "fused_rmsnorm", "launch_counts",
           "reset_launch_counts"]
