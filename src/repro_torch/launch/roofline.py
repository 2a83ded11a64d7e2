"""Roofline of a dry-run cell: compute, memory and collective terms.

Port of ``src/repro/launch/roofline.py``. Three terms per (arch x shape x
mesh), in seconds:

    compute    = FLOPs_per_chip / peak FLOP/s
    memory     = HBM bytes_per_chip / HBM bandwidth
    collective = serialized collective bytes per chip / link bandwidth

The FLOPs and bytes are the analytic ones (``core/cost_model.step_totals``
/ ``serve_totals``), as in the reference. The reference parses its
collectives from compiled HLO, multiplying a while body's ops by its trip
count; the port has no HLO, and its step is a Python program that issues
every collective it runs, loops unrolled. ``CollectiveRecorder`` is a
``TorchDispatchMode`` that records each of them as the step issues it
(``torch.ops.c10d.*``, the ``torch.distributed`` calls, and
``torch.ops._c10d_functional.*``): its kind under the reference's names,
its payload bytes (the output for an all-gather and an all-to-all, the
input for a reduce-scatter, the buffer for an all-reduce, as the
reference's HLO shapes), its dtype and its group's size. Each op is one
``CollectiveOp``, with the recorder's ``multiplier`` at the time: 1, or a
loop body's trip count where the dry-run runs a loop's body once for
several trips (its microbatches). ``analyze`` takes that list where the
reference takes the HLO.

``wire_bytes`` keeps the reference's ring formulas. The reference halves
fp32 collective bytes by default (XLA's CPU backend widens bf16 dots, so
its HLO moves fp32 where a TPU moves bf16); PyTorch moves bf16 as bf16, so
``dtype_correction`` is off by default here and the switch is kept for
parity with the reference.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the reference's HLO names for torch dtypes
DTYPE_NAMES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.int32: "s32", torch.float32: "f32",
               torch.float64: "f64", torch.int64: "s64"}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    nbytes: int  # payload (output for ag, input for rs, buffer for ar)
    dtype: str
    group_size: int
    multiplier: float = 1.0

    def wire_bytes(self) -> float:
        """Per-chip serialized bytes on the slowest link (ring algorithms)."""
        g = max(self.group_size, 1)
        if self.kind == "all-gather":
            return self.nbytes * (g - 1) / g
        if self.kind == "reduce-scatter":
            return self.nbytes * (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * self.nbytes * (g - 1) / g
        if self.kind == "all-to-all":
            return self.nbytes * (g - 1) / g
        return float(self.nbytes)  # collective-permute


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(ts)[0]
               if isinstance(t, torch.Tensor))


def _dtype(ts) -> str:
    first = next(t for t in tree_flatten(ts)[0] if isinstance(t, torch.Tensor))
    return DTYPE_NAMES.get(first.dtype, str(first.dtype))


def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


# c10d op (what the torch.distributed calls reach) -> (kind, which argument
# holds the payload, which the process group)
_C10D = {
    "allreduce_": ("all-reduce", 0, 1),
    "allgather_": ("all-gather", 0, 2),
    "_allgather_base_": ("all-gather", 0, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 1, 2),
    "alltoall_base_": ("all-to-all", 0, 2),
}
# _c10d_functional op -> (kind, payload from the output (True) or the input)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", False),
    "all_gather_into_tensor": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", False),
    "all_to_all_single": ("all-to-all", True),
}


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective issued under it, in order (``ops``). Works
    on real tensors over a real process group and on fake tensors over the
    fake one alike."""

    def __init__(self):
        super().__init__()
        self.ops: list[CollectiveOp] = []
        self.multiplier = 1.0  # given to the ops recorded from now on

    def record(self, func, args, out) -> None:
        """Record ``func(*args) -> out`` if it is a collective."""
        ns, name = func.namespace, func._opname
        if ns == "c10d" and name in _C10D:
            kind, payload, pg = _C10D[name]
            ts = args[payload]
            group = args[pg]
            if isinstance(group, torch.ScriptObject):  # the boxed form the dispatcher passes
                group = dist.ProcessGroup.unbox(group)
            size = int(group.size())
        elif ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind, from_out = _FUNCTIONAL[name]
            ts = out if from_out else args[0]
            size = _group_size(args[-1])
        else:
            return
        self.ops.append(CollectiveOp(kind, _bytes(ts), _dtype(ts), size,
                                     multiplier=self.multiplier))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.record(func, args, out)
        return out


@dataclasses.dataclass
class RooflineReport:
    flops_per_chip: float  # analytic
    hbm_bytes_per_chip: float
    collective_bytes_raw: float  # per chip, serialized, as recorded
    collective_bytes_corrected: float  # fp32 halved where dtype_correction is on
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float  # 6*N*D (dense) / 6*N_active*D (MoE)
    useful_flops_ratio: float
    by_kind: dict[str, float]

    def row(self) -> dict:
        d = dataclasses.asdict(self)
        d["by_kind"] = {k: round(v / 1e9, 3) for k, v in self.by_kind.items()}
        return d


def analyze(
    *,
    collectives: list[CollectiveOp],
    flops_per_chip: float,
    hbm_bytes_per_chip: float,
    model_flops_per_chip: float,
    hw,
    dtype_correction: bool = False,
) -> RooflineReport:
    ops = collectives
    raw = sum(o.wire_bytes() * o.multiplier for o in ops)
    corrected = sum(
        o.wire_bytes() * o.multiplier * (0.5 if (dtype_correction and o.dtype == "f32") else 1.0)
        for o in ops
    )
    by_kind: dict[str, float] = {}
    for o in ops:
        by_kind[o.kind] = by_kind.get(o.kind, 0.0) + o.wire_bytes() * o.multiplier

    t_comp = flops_per_chip / hw.peak_flops
    t_mem = hbm_bytes_per_chip / hw.hbm_bw
    t_coll = corrected / hw.ici_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return RooflineReport(
        flops_per_chip=flops_per_chip,
        hbm_bytes_per_chip=hbm_bytes_per_chip,
        collective_bytes_raw=raw,
        collective_bytes_corrected=corrected,
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops_per_chip,
        useful_flops_ratio=model_flops_per_chip / flops_per_chip if flops_per_chip else 0.0,
        by_kind=by_kind,
    )
