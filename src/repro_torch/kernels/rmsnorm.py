"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas ``src/repro/kernels/rmsnorm.py::rmsnorm``. Takes CUDA
tensors only; the kernels package sends CPU tensors to
``ref.rmsnorm_ref`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``bf16(x * rsqrt(mean(x^2) + eps)) * scale`` over the last axis."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and scale on one CUDA device, "
                         f"got {x.device} and {scale.device}")
    if x.dtype not in build.DTYPE_CODES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes bf16 or fp32 x with a scale of the "
                        f"same dtype, got {x.dtype} and {scale.dtype}")
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = build.load_library()
    rc = lib.repro_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                           float(eps), build.DTYPE_CODES[x.dtype],
                           build.stream_handle(x.device))
    build.check(lib, rc, "rmsnorm launch")
    build.count_launch("rmsnorm")
    return out
