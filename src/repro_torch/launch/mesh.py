"""The process group a training step syncs over.

Port of ``src/repro/launch/mesh.py``. ``mesh_spec`` is the planner's data,
unchanged. The port's mesh is one axis, ``data``: one rank a device, every
rank holding the whole batch's replica of the step and its own shards of
the ZeRO-sharded leaves. ``make_local_mesh`` returns it for this process
(``LocalMesh``: ``rank``, ``world``, the process ``group``, the ``device``
and the ``MeshSpec((world,), ("data",))`` the planner prices); the model
axis (tensor parallelism) and the multi-pod mesh are queued in ROADMAP.md.

``init_distributed`` joins the process group as ``torchrun`` describes it
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR`` /
``MASTER_PORT`` or an explicit ``init_method``): NCCL on CUDA with rank r on
``cuda:LOCAL_RANK``, gloo only when the caller asks for the CPU. A world of
one needs no process group.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.compat import resolve_device
from repro_torch.core.hardware import MULTI_POD, SINGLE_POD, MeshSpec

AXES = ("data",)


def mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    return MULTI_POD if multi_pod else SINGLE_POD


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """This process's place in the data-parallel mesh."""

    rank: int
    world: int
    group: object | None  # a torch.distributed ProcessGroup (None: the default group)
    device: torch.device

    @property
    def spec(self) -> MeshSpec:
        return MeshSpec((self.world,), AXES)


def make_local_mesh(device=None, group=None) -> LocalMesh:
    """The mesh of this process: the initialised default process group (or
    ``group``) if there is one, else a world of one on ``device``."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not "
                             "initialised")
        return LocalMesh(0, 1, None, device)
    return LocalMesh(dist.get_rank(group), dist.get_world_size(group), group, device)


def init_distributed(device=None, *, init_method: str | None = None,
                     rank: int | None = None, world: int | None = None) -> LocalMesh:
    """Join the process group this process was started in and return its
    mesh. ``rank`` / ``world`` default to ``RANK`` / ``WORLD_SIZE`` (1 when
    unset); a CUDA device defaults to ``cuda:LOCAL_RANK``. NCCL on CUDA,
    gloo on the CPU; ``init_method`` defaults to ``env://``."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world > 1 and not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        kw = {"device_id": device} if device.type == "cuda" else {}
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world, **kw)
    return make_local_mesh(device)
