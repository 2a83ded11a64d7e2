"""Wrapper of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces the Pallas ``src/repro/kernels/rmsnorm.py::rmsnorm``. Takes CUDA
tensors only; the kernels package sends CPU tensors to
``ref.rmsnorm_ref`` instead. ``RMSNormFn`` gives the forward a gradient:
the JAX package differentiates RMSNorm with XLA's autodiff, which has no
Pallas kernel to port, so its backward is the plain ``ref.rmsnorm_bwd_ref``
in fp32 on either device (a backward kernel is queued in ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.compat import faking
from repro_torch.kernels import build, fake, ref


def rmsnorm_cuda(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
                 pdl: bool = True) -> torch.Tensor:
    """``bf16(x * rsqrt(mean(x^2) + eps)) * scale`` over the last axis.

    ``pdl``: programmatic dependent launch -- the kernel may be scheduled
    while the previous kernel on the stream finishes (it touches memory only
    after that kernel is done). Every caller keeps it on, which cut a
    decode-shape row's graph-replay time (PERF.md); ``False`` is for
    ``scripts/rmsnorm_chip.py``'s A/B."""
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
                           float(eps), build.DTYPE_CODES[x.dtype], int(pdl),
                           build.stream_handle(x.device))
    build.check(lib, rc, "rmsnorm launch")
    build.count_launch("rmsnorm")
    return out


def empty_kernel_cuda(device: torch.device) -> None:
    """Launch one empty block on ``device``'s current stream: the least a
    launch costs, which a decode-shape row's time stands on. A measurement
    aid, on no path of the model."""
    lib = build.load_library()
    build.check(lib, lib.repro_empty_kernel(build.stream_handle(device)), "empty kernel launch")


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with a gradient: forward by device (the kernel on CUDA, its
    fake on a fake CUDA tensor, the plain version on the CPU), backward
    ``ref.rmsnorm_bwd_ref``."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cuda":
            return fake.rmsnorm(x, scale) if faking() else rmsnorm_cuda(x, scale, eps)
        return ref.rmsnorm_ref(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = ref.rmsnorm_bwd_ref(x, scale, dy, ctx.eps)
        return dx, dscale, None
