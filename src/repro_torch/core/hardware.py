"""Hardware descriptions the cost models plan against.

Port of ``src/repro/core/hardware.py``: the same ``HardwareSpec`` and
``MeshSpec``, the capacity constants and the TPU / paper-testbed entries
(kept so the port's planner can be held to the reference's on the same
specs), plus ``H100_SXM`` (NVIDIA's data sheet) and ``local_cuda_hw``, the
spec of the card the process runs on, with its memory, the host's memory
and the host link's rate read at call time.
"""
from __future__ import annotations

import dataclasses
import os

# Shared capacity fractions (planner + serving). HBM_CAPACITY_FRACTION is
# the usable slice of a chip's memory the planners budget against; the rest
# absorbs allocator slack, collective scratch and fragmentation.
HBM_CAPACITY_FRACTION = 0.92
# SERVE_RESIDENT_HEADROOM: the fraction of the budget that weights + KV
# cache may fill while still keeping everything resident.
SERVE_RESIDENT_HEADROOM = 0.75


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float  # bf16/fp16 FLOP/s per chip
    hbm_bytes: float  # device memory per chip
    hbm_bw: float  # B/s per chip
    ici_bw: float  # B/s per link, intra-pod interconnect (ICI / NVLink)
    host_bw: float  # B/s device<->host (PCIe / host DMA)
    dcn_bw: float  # B/s per chip across pods (data-center network)
    host_mem_bytes: float  # host DRAM available for offload, per host
    chips_per_host: int = 4
    # Achievable fractions (exposed for calibration)
    flops_efficiency: float = 0.55  # MFU ceiling for dense matmul pipelines
    mem_efficiency: float = 0.8
    coll_efficiency: float = 0.85
    host_flops: float = 2.0e12  # host-side update throughput (fused CPU Adam analogue)
    hbm_capacity_fraction: float = HBM_CAPACITY_FRACTION
    serve_resident_headroom: float = SERVE_RESIDENT_HEADROOM

    def matmul_time(self, flops: float) -> float:
        return flops / (self.peak_flops * self.flops_efficiency)

    def hbm_time(self, nbytes: float) -> float:
        return nbytes / (self.hbm_bw * self.mem_efficiency)

    def capacity_bytes(self) -> float:
        """Plannable device memory per chip -- the Eq. 1 M_capacity both the
        training search and the serving planner constrain against."""
        return self.hbm_bytes * self.hbm_capacity_fraction


TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    peak_flops=197e12,
    hbm_bytes=16e9,
    hbm_bw=819e9,
    ici_bw=50e9,
    host_bw=25e9,
    dcn_bw=12.5e9,
    host_mem_bytes=512e9,
)

# Paper testbeds (Section 5.1).
RTX_3090 = HardwareSpec(
    name="rtx-3090",
    peak_flops=71e12,  # fp16 w/ fp32 accumulate
    hbm_bytes=24e9,
    hbm_bw=936e9,
    ici_bw=15.8e9,  # no NVLink: collectives ride PCIe 3
    host_bw=15.8e9,  # PCIe 3 x16
    dcn_bw=12.5e9,  # 100 Gb IB (paper section 5.5)
    host_mem_bytes=384e9,
    chips_per_host=4,
    host_flops=0.6e12,  # 24-core Xeon Silver, fused CPU Adam
)

A100_80G = HardwareSpec(
    name="a100-80g",
    peak_flops=312e12,
    hbm_bytes=80e9,
    hbm_bw=2039e9,
    ici_bw=300e9,  # NVLink 3.0
    host_bw=31.5e9,  # PCIe 4 x16
    dcn_bw=12.5e9,
    host_mem_bytes=1e12,
    chips_per_host=4,
    host_flops=2.5e12,  # 112-core Platinum 8480+
)

# NVIDIA H100 SXM5, data sheet (dense bf16, no sparsity, at 700 W): 80 GB of
# HBM3 at 3.35 TB/s, NVLink 4 at 900 GB/s both ways (450 a direction), PCIe
# 5.0 x16 at 64 GB/s a direction, one 400 Gb/s NDR InfiniBand port per GPU
# in a DGX H100 (8 GPUs, 2 TB of host memory, two 56-core Xeon 8480C).
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    host_bw=64e9,
    dcn_bw=50e9,
    host_mem_bytes=2e12,
    chips_per_host=8,
    host_flops=2.5e12,
)

# Local-host CPU constants: the planner's spec for runs on the CPU.
LOCAL_CPU_HW = HardwareSpec(
    name="cpu-host",
    peak_flops=5e10,
    hbm_bytes=32e9,
    hbm_bw=20e9,
    ici_bw=10e9,
    host_bw=10e9,
    dcn_bw=1e9,
    host_mem_bytes=32e9,
)

HARDWARE = {h.name: h for h in (TPU_V5E, RTX_3090, A100_80G, H100_SXM)}


def host_memory_bytes() -> int:
    """Physical memory of this host (``os.sysconf``)."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def measure_host_link(device, nbytes: int = 256 << 20, reps: int = 5) -> dict:
    """Copy-engine rates between pinned host memory and ``device`` (CUDA), in
    bytes / s: ``h2d`` and ``d2h`` alone, and ``both_ways``, the rate each
    direction gets while the other runs at once, on two streams. CUDA-event
    timed, median of ``reps`` after one warm-up."""
    import statistics

    import torch

    src, back = (torch.empty(nbytes, dtype=torch.uint8).pin_memory() for _ in range(2))
    dst, out = (torch.empty(nbytes, dtype=torch.uint8, device=device) for _ in range(2))
    side = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)

    def h2d():
        dst.copy_(src, non_blocking=True)

    def d2h():
        back.copy_(out, non_blocking=True)

    def both_ways():
        side.wait_stream(cur)
        dst.copy_(src, non_blocking=True)
        with torch.cuda.stream(side):
            back.copy_(out, non_blocking=True)
        cur.wait_stream(side)

    def rate(fn) -> float:
        fn()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(cur)
            fn()
            end.record(cur)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return nbytes / statistics.median(times)

    return {"h2d": rate(h2d), "d2h": rate(d2h), "both_ways": rate(both_ways)}


def local_cuda_hw(device=None) -> HardwareSpec:
    """``H100_SXM`` with this machine's numbers: ``hbm_bytes`` from
    ``torch.cuda.get_device_properties``, ``host_mem_bytes`` from the host
    (``os.sysconf``), ``host_bw`` measured now (``measure_host_link``).

    ``host_bw`` is the **both-ways rate per direction**: what each direction
    gets while the other copies too. The host bytes the cost model prices
    move that way in the port. ``t_dma``, the host optimizer's 26 B a
    parameter, is the pinned-state Adam pipeline, which streams master, m and
    v in while it writes updated states and weights out (it ran at 93-106 %
    of this rate on the H100), and those are most of a step's host bytes.
    The one-way rate would price them as if the link were idle in the other
    direction. ``t_upload`` reads the same one figure: the weight fetches
    alone on the link can reach the one-way rate (``measure_host_link``'s
    ``h2d``), so there it prices from above. The data sheet's 64 GB/s is
    not used: measured rates on the same card type ranged from 27 to 46
    GB/s a direction."""
    import torch

    from repro_torch.compat import resolve_device

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError(f"local_cuda_hw reads a CUDA card, not {device}")
    props = torch.cuda.get_device_properties(device)
    link = measure_host_link(device)
    return dataclasses.replace(H100_SXM, name=f"local-{H100_SXM.name}",
                               hbm_bytes=float(props.total_memory),
                               host_mem_bytes=float(host_memory_bytes()),
                               host_bw=link["both_ways"])


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh geometry + per-axis bandwidth class."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def n_chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)] if name in self.axes else 1

    @property
    def zero_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def zero_degree(self) -> int:
        n = 1
        for a in self.zero_axes:
            n *= self.axis_size(a)
        return n

    @property
    def tp_degree(self) -> int:
        return self.axis_size("model")

    def gather_bw(self, hw: HardwareSpec) -> float:
        """Effective per-chip bandwidth for a ZeRO all-gather: the slowest
        participating axis; the DCN leg when the ``pod`` axis participates."""
        if "pod" in self.axes and self.axis_size("pod") > 1:
            return hw.dcn_bw * hw.coll_efficiency
        return hw.ici_bw * hw.coll_efficiency


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))
# One card, the mesh every single-device plan of the port runs on.
ONE_CHIP = MeshSpec((1,), ("data",))
