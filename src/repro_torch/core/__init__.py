"""ProTrain core of the port: memory plans, profiler, cost models, tuner.

The same exports as ``src/repro/core/__init__.py``, plus the port's
``H100_SXM``, ``LOCAL_CPU_HW``, ``ONE_CHIP`` and ``local_cuda_hw``.
"""
from repro_torch.core.autotuner import SearchResult, exhaustive_search, search
from repro_torch.core.chunks import ChunkInfo, chunk_inventory, chunk_size_search
from repro_torch.core.cost_model import (
    Workload,
    build_workload,
    estimate_memory,
    estimate_runtime,
)
from repro_torch.core.hardware import (
    H100_SXM,
    HARDWARE,
    LOCAL_CPU_HW,
    MULTI_POD,
    ONE_CHIP,
    SINGLE_POD,
    TPU_V5E,
    HardwareSpec,
    MeshSpec,
    local_cuda_hw,
)
from repro_torch.core.plan import MemoryPlan, fsdp_style_plan, fully_resident_plan
from repro_torch.core.profiler import BlockProfile, profile_fn, profile_superblock
