"""Wrapper of the CUDA fused-Adam kernel (``csrc/fused_adam.cu``).

Replaces the Pallas ``src/repro/kernels/fused_adam.py::fused_adam``. The
update runs in place: p, master, m and v are overwritten. g (bf16 or fp32)
lies on a CUDA device, the one the kernel runs on; p (bf16 or fp32) and the
fp32 master, m and v lie there too or in pinned host memory (a host chunk's
weights under ``host_params=True``, its optimizer states), which the kernel
reads and writes in place through unified addressing (so a CPU read of them
must wait for the stream). Anything else raises: the kernels package sends
CPU gradients to ``ref.fused_adam_ref`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def fused_adam_cuda(p, g, master, m, v, scalars):
    """One in-place Adam step of a leaf. ``scalars``: (8,) fp32 on g's device,
    ``[lr, b1, b2, eps, wd, bc1, bc2, 0]``. Returns (p, master, m, v)."""
    dev = g.device
    if dev.type != "cuda":
        raise ValueError(f"fused-Adam kernel needs g on CUDA, got {dev}")
    for name, t, dtypes in (("p", p, build.DTYPE_CODES), ("g", g, build.DTYPE_CODES),
                            ("master", master, (torch.float32,)), ("m", m, (torch.float32,)),
                            ("v", v, (torch.float32,))):
        if t.dtype not in dtypes:
            raise TypeError(f"fused-Adam kernel: {name} dtype {t.dtype} not in {tuple(dtypes)}")
        if t.shape != p.shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused-Adam kernel: {name} must be contiguous, 16-byte aligned "
                             f"and of p's shape {tuple(p.shape)}, got {tuple(t.shape)}")
    for name, t in (("p", p), ("master", master), ("m", m), ("v", v)):
        if t.device != dev and not (t.device.type == "cpu" and t.is_pinned()):
            raise ValueError(f"fused-Adam kernel: {name} must lie on {dev} or in pinned host "
                             f"memory, got {t.device} (pinned={t.is_pinned()})")
    if scalars.device != dev or scalars.dtype != torch.float32 or tuple(scalars.shape) != (8,):
        raise ValueError(f"fused-Adam kernel: scalars must be (8,) fp32 on {dev}, got "
                         f"{tuple(scalars.shape)} {scalars.dtype} on {scalars.device}")
    if p.numel() == 0:
        return p, master, m, v
    lib = build.load_library()
    rc = lib.repro_fused_adam(p.data_ptr(), g.data_ptr(), master.data_ptr(), m.data_ptr(),
                              v.data_ptr(), scalars.data_ptr(), p.numel(),
                              build.DTYPE_CODES[p.dtype], build.DTYPE_CODES[g.dtype],
                              build.stream_handle(dev))
    build.check(lib, rc, "fused_adam launch")
    build.count_launch("fused_adam")
    return p, master, m, v
