"""Kernel dispatch by the tensor's device.

A CPU tensor gets the plain PyTorch version (``ref.py``); a CUDA tensor gets
the hand-written kernel, which raises on anything it does not take. There is
no fallback from one to the other. Under the dry-run's ``FakeTensorMode``
(``launch/dryrun.py``; ``compat.faking``) a CUDA tensor gets the kernel's
fake (``fake.py``): its outputs' shapes and dtypes and its FLOPs, no launch
and no count. Launch counts of the kernels:
``launch_counts`` / ``reset_launch_counts``. ``fused_rmsnorm`` carries a
gradient (``rmsnorm.RMSNormFn``) when grad mode is on and an input requires
it; the serving path, under ``inference_mode``, calls the forward alone.
"""
from __future__ import annotations

import torch

from repro_torch.compat import faking
from repro_torch.kernels import fake, ref
from repro_torch.kernels.build import launch_counts, reset_launch_counts

PLAIN, CUDA, FAKE = "plain", "cuda", "fake"


def _route(t: torch.Tensor, what: str) -> str:
    """``CUDA`` for the kernel, ``FAKE`` for its fake (a CUDA tensor under
    ``FakeTensorMode``), ``PLAIN`` for the plain version (a CPU tensor, fake
    or not)."""
    if t.device.type == "cuda":
        return FAKE if faking() else CUDA
    if t.device.type == "cpu":
        return PLAIN
    raise ValueError(f"{what}: no kernel or plain version for device {t.device}")


def fused_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        from repro_torch.kernels.rmsnorm import RMSNormFn

        _route(x, "rmsnorm")
        return RMSNormFn.apply(x, scale, eps)
    route = _route(x, "rmsnorm")
    if route == FAKE:
        return fake.rmsnorm(x, scale)
    if route == CUDA:
        from repro_torch.kernels.rmsnorm import rmsnorm_cuda

        return rmsnorm_cuda(x, scale, eps)
    return ref.rmsnorm_ref(x, scale, eps)


def decode_paged_attention(q, k_hot, v_hot, k_cold, v_cold, sel, mask, *, n_hot: int):
    """Decode attention over the paged layout (serve/paging.PagedKV); routed
    by q's device (the cold store may lie in pinned host memory)."""
    route = _route(q, "paged_attention")
    if route == FAKE:
        return fake.paged_attention(q, k_cold)
    if route == CUDA:
        from repro_torch.kernels.paged_attention import paged_attention_cuda

        return paged_attention_cuda(q, k_hot, v_hot, k_cold, v_cold, sel, mask, n_hot=n_hot)
    return ref.paged_attention_ref(q, k_hot, v_hot, k_cold, v_cold, sel, mask)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                    block_kv: int | None = None):
    """Attention forward with its log-sum-exp. q: (B, Sq, Hq, hd); k, v:
    (B, Sk, Hkv, hd). Returns out (B, Sq, Hq, hd) and lse (B, Hq, Sq) fp32.
    A row with nothing attended gets the JAX references' value: the mean of
    V over the keys padded to a multiple of ``block_kv`` (default: the
    Pallas kernel's tile, ``min(128, Sk)``; ``_mea`` passes its own), lse
    -1e30."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_kv=block_kv)
    route = _route(q, "flash_attention")
    if route == FAKE:
        return fake.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if route == CUDA:
        from repro_torch.kernels.flash_cuda import flash_attention_cuda

        return flash_attention_cuda(q, k, v, **kw)
    return ref.attention_lse_ref(q, k, v, **kw)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent ``dout``; rows
    with nothing attended get ``_mea_bwd``'s gradients."""
    route = _route(q, "flash_attention_bwd")
    if route == FAKE:
        return fake.flash_attention_bwd(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset)
    if route == CUDA:
        from repro_torch.kernels.flash_cuda import flash_attention_bwd_cuda

        return flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal, window=window,
                                        q_offset=q_offset)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal, window=window,
                                       q_offset=q_offset)


def fused_adam_update(p, g, master, m, v, scalars):
    """One Adam step of a leaf, in place on p, master, m and v; routed by
    g's device (p and the states may lie in pinned host memory beside a
    CUDA g). ``scalars``: (8,) fp32 on g's device, ``[lr, b1, b2, eps, wd,
    bc1, bc2, 0]``. Returns (p, master, m, v)."""
    route = _route(g, "fused_adam")
    if route == FAKE:
        return p, master, m, v
    if route == CUDA:
        from repro_torch.kernels.fused_adam import fused_adam_cuda

        return fused_adam_cuda(p, g, master, m, v, scalars)
    lr, b1, b2, eps, wd, bc1, bc2, _ = scalars.unbind()
    outs = ref.fused_adam_ref(p, g, master, m, v, lr=lr, b1=b1, b2=b2, eps=eps,
                              weight_decay=wd, bc1=bc1, bc2=bc2)
    for dst, src in zip((p, master, m, v), outs):
        dst.copy_(src)
    return p, master, m, v


def fused_quantize_ef(ch: torch.Tensor, me: int):
    """Per-chunk absmax int8 quantize of ``ch`` (z, ...) plus chunk ``me``'s
    residual: (q int8, scales (z,) fp32, err fp32 like ch[0])."""
    route = _route(ch, "fused_quantize_ef")
    if route == FAKE:
        return fake.fused_quantize_ef(ch)
    if route == CUDA:
        from repro_torch.kernels.fused_quant import fused_quantize_ef_cuda

        return fused_quantize_ef_cuda(ch, me)
    return ref.fused_quantize_ef_ref(ch, me)


__all__ = ["decode_paged_attention", "flash_attention", "flash_attention_bwd",
           "fused_adam_update", "fused_quantize_ef", "fused_rmsnorm", "launch_counts",
           "reset_launch_counts"]
