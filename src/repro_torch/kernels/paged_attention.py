"""Wrapper of the CUDA paged decode-attention kernel (``csrc/paged_attention.cu``).

Replaces the Pallas ``src/repro/kernels/paged_attention.py::paged_attention``.
q, the hot ring, ``sel`` and ``mask`` lie on one CUDA device; the cold store
lies there too or in pinned host memory, which the kernel reads in place
through unified addressing. Anything else raises: the kernels package sends
CPU queries to ``ref.paged_attention_ref`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on sm_90


def paged_attention_cuda(q, k_hot, v_hot, k_cold, v_cold, sel, mask, *, n_hot: int):
    """Single-token decode attention over hot ring + cold store.

    q: (B, 1, Hq, hd); k/v_hot: (B, W, Hkv, hd) with W = page_size * n_hot;
    k/v_cold: (B, S, Hkv, hd); sel: (B, S) bool; mask: (B, S) fp32.
    Returns (B, 1, Hq, hd) in q's dtype.
    """
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged-attention kernel needs q on CUDA, got {dev}")
    b, one, hq, hd = q.shape
    _, w, hkv, hd_k = k_hot.shape
    s_kv = k_cold.shape[1]
    if one != 1 or hd_k != hd or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k_hot {tuple(k_hot.shape)}")
    for name, t, shape in (("k_hot", k_hot, (b, w, hkv, hd)), ("v_hot", v_hot, (b, w, hkv, hd)),
                           ("k_cold", k_cold, (b, s_kv, hkv, hd)),
                           ("v_cold", v_cold, (b, s_kv, hkv, hd))):
        if tuple(t.shape) != shape or t.dtype != q.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, want {shape} {q.dtype}")
    for name, t in (("k_hot", k_hot), ("v_hot", v_hot), ("sel", sel), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    for name, t in (("k_cold", k_cold), ("v_cold", v_cold)):
        if t.device != dev and not (t.device.type == "cpu" and t.is_pinned()):
            raise ValueError(f"{name} must lie on {dev} or in pinned host memory, "
                             f"got {t.device} (pinned={t.is_pinned()})")
    if sel.dtype != torch.bool or mask.dtype != torch.float32:
        raise TypeError(f"sel must be bool and mask fp32, got {sel.dtype}, {mask.dtype}")
    if tuple(sel.shape) != (b, s_kv) or tuple(mask.shape) != (b, s_kv):
        raise ValueError(f"sel {tuple(sel.shape)} / mask {tuple(mask.shape)} != {(b, s_kv)}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"paged-attention kernel takes bf16 or fp32, got {q.dtype}")
    g = hq // hkv
    if g not in (1, 2, 4, 8) or hd not in (64, 128):
        raise ValueError(f"paged-attention kernel is built for G in (1, 2, 4, 8) and "
                         f"hd in (64, 128), got G={g}, hd={hd}")
    if w % n_hot or s_kv % (w // n_hot):
        raise ValueError(f"hot window {w} / n_hot {n_hot} does not tile {s_kv} slots")
    tensors = (q, k_hot, v_hot, k_cold, v_cold, sel, mask)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged-attention kernel takes contiguous tensors")
    lib = build.load_library()
    smem = lib.repro_paged_attention_smem_bytes(g, hd, s_kv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged-attention kernel keeps the whole (G, S) logits row in "
                         f"shared memory: {smem} bytes at G={g}, S={s_kv} exceeds "
                         f"{SMEM_LIMIT}; longer caches need split-KV")
    out = torch.empty_like(q)
    rc = lib.repro_paged_attention(*(t.data_ptr() for t in tensors), out.data_ptr(),
                                   b, hkv, g, hd, s_kv, w, build.DTYPE_CODES[q.dtype],
                                   build.stream_handle(dev))
    build.check(lib, rc, "paged_attention launch")
    build.count_launch("paged_attention")
    return out
