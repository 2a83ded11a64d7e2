"""Wrapper of the CUDA fused int8 quantize kernel (``csrc/fused_quant.cu``).

Replaces the Pallas ``src/repro/kernels/fused_quant.py::fused_quantize_ef``:
per chunk (row) of ``ch`` an absmax int8 payload and its fp32 scale, and the
fp32 error-feedback residual of chunk ``me``, bitwise equal to
``ref.fused_quantize_ef_ref``. Takes a contiguous fp32 or bf16 CUDA tensor
(bf16 is widened inside the kernel, so an activation needs no fp32 copy)
and raises on anything else: the kernels package sends CPU tensors to the
plain version instead.

``quant_plan`` picks the shape of a launch from (z, n, dtype) alone, so the
CPU tests check it for every width the configs hold; the kernel's entry
point checks the plan again and refuses one it cannot run.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import build

ROWS_BLOCK = 256  # threads of a block that holds several rows
MAX_ROW_THREADS = 1024  # one block a row at most
SHARED_ROW_THREADS = 512  # the most threads a row takes where two blocks can share an SM
TARGET_LOADS = 4  # loads a thread takes before a row takes twice the threads
LOAD_SLOTS = (1, 2, 4, 6)  # loads a thread can hold (the kernel's instances)
SEGMENT = 16384  # values a block of a two-pass row (csrc/fused_quant.cu kSeg)
PATHS = {"rows": 0, "segments": 1}  # csrc/fused_quant.cu kPath*


@dataclasses.dataclass(frozen=True)
class QuantPlan:
    """One launch of the quantizer (``csrc/fused_quant.cu`` describes its
    paths). ``vec``: values a load (16 bytes where n allows it); the rows
    path: ``threads_per_row`` threads a row, ``rows`` rows a block,
    ``loads_per_thread`` loads a thread; the segments path (two passes):
    ``scratch`` floats of partial maxima."""

    path: str
    vec: int
    threads_per_row: int
    rows: int
    loads_per_thread: int
    blocks: int
    threads: int
    scratch: int

    @property
    def passes(self) -> int:
        return 2 if self.path == "segments" else 1


def quant_plan(z: int, n: int, dtype: torch.dtype) -> QuantPlan:
    """How the kernel runs z rows of n values of ``dtype`` (fp32 or bf16).

    One pass while a row fits ``MAX_ROW_THREADS`` threads of
    ``max(LOAD_SLOTS)`` loads: a row takes the fewest threads (a power of
    two, one warp at least) that hold it in ``TARGET_LOADS`` loads each,
    but no more than ``SHARED_ROW_THREADS`` where those hold it in
    ``max(LOAD_SLOTS)``; rows of fewer than ``ROWS_BLOCK`` threads share a
    block. Longer rows (the gradient wire) take two passes."""
    widths = (8, 4) if dtype == torch.bfloat16 else (4,)
    vec = next((w for w in widths if n % w == 0), 1)
    loads = n // vec
    tpr = 32
    while tpr < MAX_ROW_THREADS and loads > TARGET_LOADS * tpr:
        tpr *= 2
    if tpr > SHARED_ROW_THREADS and loads <= max(LOAD_SLOTS) * SHARED_ROW_THREADS:
        tpr = SHARED_ROW_THREADS
    need = -(-loads // tpr)
    slot = next((s for s in LOAD_SLOTS if s >= need), None)
    if slot is None:
        nseg = -(-n // SEGMENT)
        return QuantPlan("segments", vec, 0, 1, SEGMENT // (ROWS_BLOCK * vec), z * nseg,
                         ROWS_BLOCK, z * nseg)
    rows = min(max(1, ROWS_BLOCK // tpr), z)
    return QuantPlan("rows", vec, tpr, rows, slot, -(-z // rows), tpr * rows, 0)


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
    plan = quant_plan(z, n, ch.dtype)
    q = torch.empty(ch.shape, dtype=torch.int8, device=ch.device)
    scales = torch.empty(z, dtype=torch.float32, device=ch.device)
    err = torch.empty(ch.shape[1:], dtype=torch.float32, device=ch.device)
    partial = torch.empty(plan.scratch, dtype=torch.float32, device=ch.device)
    lib = build.load_library()
    rc = lib.repro_fused_quantize_ef(ch.data_ptr(), build.DTYPE_CODES[ch.dtype], q.data_ptr(),
                                     scales.data_ptr(), err.data_ptr(), partial.data_ptr(), z, n,
                                     me, plan.vec, PATHS[plan.path], plan.threads_per_row,
                                     plan.rows, plan.loads_per_thread, SEGMENT,
                                     build.stream_handle(ch.device))
    build.check(lib, rc, "fused_quantize_ef launch")
    build.count_launch("fused_quantize_ef")
    return q, scales, err
