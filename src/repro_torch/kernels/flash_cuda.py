"""Wrappers of the CUDA FlashAttention kernels (``csrc/flash_attention.cu``).

The forward replaces the Pallas ``src/repro/kernels/flash_attention.py::
flash_attention`` and also returns the log-sum-exp; the backward computes
``src/repro/models/layers.py::_mea_bwd``. Both take bf16 CUDA tensors in
the model's (B, S, H, hd) layout through their strides (unit stride on hd,
the others multiples of 8 elements, 16-byte aligned data), hd 64 or 128,
and raise on anything else: the kernels package sends CPU tensors to the
plain versions in ``ref.py`` instead.

Rows with nothing attended (which follow from ``(sq, sk, q_offset,
causal, window)`` alone: ``ref.unattended_rows``, on the host) leave the
kernels' loops with out 0, lse -1e30 and zero gradients; a short pass over
those rows only (``ref.fix_unattended_fwd`` / ``fix_unattended_bwd``) then
gives them the JAX references' values. It does nothing when there are
none, as in every causal training step.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"flash attention: {name} on {t.device}, q on {device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash attention kernel takes bf16, got {name} {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"flash attention: {name} {tuple(t.shape)}, want {shape}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"flash attention: {name} needs a unit hd stride, other strides "
                         f"multiples of 8 and 16-byte aligned data (strides {t.stride()})")


def _geometry(q, k, v) -> tuple[int, int, int, int, int, int]:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel needs CUDA tensors, got q on {q.device}")
    b, sq, hq, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS or hkv == 0 or hq % hkv:
        raise ValueError(f"flash attention kernel is built for hd in {HEAD_DIMS} and Hq a "
                         f"multiple of Hkv, got q {tuple(q.shape)} k {tuple(k.shape)}")
    _check("q", q, (b, sq, hq, hd), q.device)
    _check("k", k, (b, sk, hkv, hd), q.device)
    _check("v", v, (b, sk, hkv, hd), q.device)
    return b, sq, sk, hq, hkv, hd


def _dims(*vals: int):
    return (ctypes.c_longlong * len(vals))(*vals)


def _strides(*ts: torch.Tensor):
    return _dims(*(s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))))


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                         block_kv: int | None = None):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), bf16. Returns out (B, Sq,
    Hq, hd) bf16 and the fp32 log-sum-exp (B, Hq, Sq). A block computes two
    query heads of a kv group when the group is even, else one. A row with
    nothing attended averages V over ``ref.padded_keys(sk, block_kv)`` keys."""
    b, sq, sk, hq, hkv, hd = _geometry(q, k, v)
    out = torch.empty(b, sq, hq, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    if b * sq == 0:
        return out, lse
    lib = build.load_library()
    rc = lib.repro_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _dims(b, sq, sk, hq, hkv, hd), _strides(q, k, v, out), int(causal), int(window),
        int(q_offset), 1.0 / math.sqrt(hd), build.stream_handle(q.device))
    build.check(lib, rc, "flash_attention launch")
    build.count_launch("flash_attention")
    ref.fix_unattended_fwd(v, out, lse, ref.unattended_rows(sq, sk, causal, window, q_offset),
                           ref.padded_keys(sk, block_kv))
    return out, lse


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, *, causal: bool = True, window: int = 0,
                             q_offset: int = 0):
    """Gradients (dq, dk, dv) of the forward at (q, k, v) for the cotangent
    ``dout``, given its ``out`` and ``lse``; shapes and dtypes as the inputs."""
    b, sq, sk, hq, hkv, hd = _geometry(q, k, v)
    _check("out", out, (b, sq, hq, hd), q.device)
    _check("dout", dout, (b, sq, hq, hd), q.device)
    if lse.device != q.device or lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) \
            or not lse.is_contiguous():
        raise ValueError(f"flash attention: lse must be contiguous fp32 {(b, hq, sq)} on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")
    dq = torch.empty(b, sq, hq, hd, dtype=q.dtype, device=q.device)
    dk = torch.empty(b, sk, hkv, hd, dtype=k.dtype, device=q.device)
    dv = torch.empty(b, sk, hkv, hd, dtype=v.dtype, device=q.device)
    if b * sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty(b, hq, sq, dtype=torch.float32, device=q.device)
    lib = build.load_library()
    rc = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _dims(b, sq, sk, hq, hkv, hd), _strides(q, k, v, out, dout, dq, dk, dv), int(causal),
        int(window), int(q_offset), 1.0 / math.sqrt(hd), build.stream_handle(q.device))
    build.check(lib, rc, "flash_attention_bwd launch")
    build.count_launch("flash_attention_bwd")
    ref.fix_unattended_bwd(q, k, v, out, dout, dq, dk, dv,
                           ref.unattended_rows(sq, sk, causal, window, q_offset))
    return dq, dk, dv
