"""Wrapper of the CUDA fused int8 quantize kernel (``csrc/fused_quant.cu``).

Replaces the Pallas ``src/repro/kernels/fused_quant.py::fused_quantize_ef``:
per chunk (row) of ``ch`` an absmax int8 payload and its fp32 scale, and the
fp32 error-feedback residual of chunk ``me``, bitwise equal to
``ref.fused_quantize_ef_ref``. Takes a contiguous fp32 or bf16 CUDA tensor
(bf16 is widened inside the kernel, so an activation needs no fp32 copy)
and raises on anything else: the kernels package sends CPU tensors to the
plain version instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build


def fused_quantize_ef_cuda(ch: torch.Tensor, me: int):
    """``ch``: (z, *shard). Returns (q int8 like ch, scales (z,) fp32, err
    fp32 like ch[0])."""
    if ch.device.type != "cuda":
        raise ValueError(f"fused quantize kernel needs a CUDA tensor, got {ch.device}")
    if ch.dtype not in build.DTYPE_CODES:
        raise TypeError(f"fused quantize kernel takes fp32 or bf16, got {ch.dtype}")
    if ch.ndim < 2 or not ch.is_contiguous() or ch.data_ptr() % 16:
        raise ValueError(f"fused quantize kernel takes a contiguous, 16-byte aligned (z, ...) "
                         f"tensor, got shape {tuple(ch.shape)} strides {ch.stride()}")
    z, n = ch.shape[0], math.prod(ch.shape[1:])
    me = int(me)
    if z == 0 or n == 0 or not 0 <= me < z:
        raise ValueError(f"fused quantize kernel: z={z}, n={n}, me={me} (want z, n > 0 and "
                         f"0 <= me < z)")
    q = torch.empty(ch.shape, dtype=torch.int8, device=ch.device)
    scales = torch.empty(z, dtype=torch.float32, device=ch.device)
    err = torch.empty(ch.shape[1:], dtype=torch.float32, device=ch.device)
    lib = build.load_library()
    partial = torch.empty(lib.repro_fused_quant_scratch(z, n), dtype=torch.float32,
                          device=ch.device)
    rc = lib.repro_fused_quantize_ef(ch.data_ptr(), build.DTYPE_CODES[ch.dtype], q.data_ptr(),
                                     scales.data_ptr(), err.data_ptr(), partial.data_ptr(), z, n,
                                     me, build.stream_handle(ch.device))
    build.check(lib, rc, "fused_quantize_ef launch")
    build.count_launch("fused_quantize_ef")
    return q, scales, err
