"""The process groups a training step syncs over.

Port of ``src/repro/launch/mesh.py``. ``mesh_spec`` is the planner's data,
unchanged. The port's mesh has the reference's axes, ``pod``, ``data`` and
``model``: ``world = pod * data * model`` ranks, one a device, rank ``r``
at ``(p, d, m)`` in row-major order (the order of ``jax.make_mesh((pod,
data, model))``). ``make_local_mesh`` returns it for this process
(``LocalMesh``: ``rank``, ``world``, the process ``group``, the ``device``,
the ``model`` and ``pod`` extents, and a process group for each side:
``data_group``, this rank's column, the ranks that share its model rank
across pod x data -- the reference's zero axes, every axis but ``model``
(``src/repro/dist/sharding.py:13-15, 46-48``); ``model_group``, its row,
the ranks that share its pod and data ranks). ``LocalMesh.data`` is that
column's extent, ``pod * data``, and ``data_rank`` this rank's place in it,
pod-major: the ZeRO dims shard and the batch splits over it
(``dist/sharding.py``), as the reference's over ``("pod", "data")``. The
pod axis changes no arithmetic; it changes what the planner prices:
``spec`` is the ``MeshSpec`` of the mesh, ``((world,), ("data",))`` at a
model extent of one and a single pod, ``((data, model), ("data",
"model"))`` with a model axis, and ``((pod, data, model), ("pod", "data",
"model"))`` across pods, whose ZeRO gathers ``MeshSpec.gather_bw`` prices
on the pods' network (``dcn_bw``). A model extent of one leaves every path
as it was: ``data_group`` is then ``group``.

The reference's ``make_local_mesh`` picks a model extent of 4, 2 or 1 by
the device count; the port's takes it from the caller (``launch.train
--model M``). ``make_production_mesh`` is this rank's place in the
production meshes, 16 x 16 or 2 x 16 x 16, over a process group of 256 or
512 ranks that the caller has joined (the dry-run's is a fake one,
``launch/dryrun.py``).

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
AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


def mesh_spec(*, multi_pod: bool = False) -> MeshSpec:
    return MULTI_POD if multi_pod else SINGLE_POD


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """This process's place in the ``(pod, data, model)`` mesh."""

    rank: int
    world: int
    group: object | None  # a torch.distributed ProcessGroup (None: the default group)
    device: torch.device
    model: int = 1  # the model axis's extent
    col_group: object | None = None  # the zero axes' group at model > 1
    row_group: object | None = None  # the model axis's group at model > 1
    pod: int = 1  # the pod axis's extent

    def __post_init__(self):
        if self.model < 1 or self.pod < 1 or self.world % (self.model * self.pod):
            raise ValueError(f"a pod extent of {self.pod} and a model extent of "
                             f"{self.model} do not divide a world of {self.world}")

    @property
    def data(self) -> int:
        """The zero axes' extent: the pods' data ranks, ``pod * data``."""
        return self.world // self.model

    @property
    def coords(self) -> tuple[int, ...]:
        """This rank's place along ``spec``'s axes, row-major."""
        out, r = [], self.rank
        for n in reversed(self.spec.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    @property
    def zero_ranks(self) -> tuple[int, ...]:
        """The ranks of ``data_group`` (numbered in ``group``), pod-major."""
        return tuple(z * self.model + self.model_rank for z in range(self.data))

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def data_group(self):
        """The ranks of this rank's model rank, over which the ZeRO dims
        shard and the gradients are reduced."""
        return self.group if self.model == 1 else self.col_group

    @property
    def model_group(self):
        """The ranks of this rank's data rank, over which the ``tp`` and
        ``exp`` dims shard (None at a model extent of one)."""
        return None if self.model == 1 else self.row_group

    @property
    def spec(self) -> MeshSpec:
        if self.pod > 1:
            return MeshSpec((self.pod, self.data // self.pod, self.model), AXES_3D)
        if self.model == 1:
            return MeshSpec((self.world,), AXES)
        return MeshSpec((self.data, self.model), AXES_2D)


def axis_groups(world: int, model: int, group=None) -> tuple[object, object]:
    """(this rank's data group, its model group) over the ranks of the
    initialised process group: every rank creates every group, in one
    order, as ``torch.distributed.new_group`` asks."""
    rank = dist.get_rank(group)
    ranks = (list(range(world)) if group is None
             else dist.get_process_group_ranks(group))
    cols = [dist.new_group([ranks[d * model + m] for d in range(world // model)])
            for m in range(model)]
    rows = [dist.new_group([ranks[d * model + m] for m in range(model)])
            for d in range(world // model)]
    return cols[rank % model], rows[rank // model]


def make_local_mesh(device=None, group=None, model: int = 1, pod: int = 1) -> LocalMesh:
    """The mesh of this process: the initialised default process group (or
    ``group``) if there is one, else a world of one on ``device``; its
    ranks laid out ``(pod, world // (pod * model), model)``."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a process group was given, but torch.distributed is not "
                             "initialised")
        return LocalMesh(0, 1, None, device, model=model, pod=pod)
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    if world % (model * pod):
        raise ValueError(f"a pod extent of {pod} and a model extent of {model} do not "
                         f"divide a world of {world}")
    if model == 1:
        return LocalMesh(rank, world, group, device, pod=pod)
    col, row = axis_groups(world, model, group)
    return LocalMesh(rank, world, group, device, model=model, col_group=col, row_group=row,
                     pod=pod)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> LocalMesh:
    """This rank's place in the production mesh, ``(16, 16)`` or ``(2, 16,
    16)`` (``src/repro/launch/mesh.py:17-26``), over the initialised
    process group of 256 or 512 ranks."""
    spec = mesh_spec(multi_pod=multi_pod)
    if not dist.is_initialized() or dist.get_world_size() != spec.n_chips:
        raise ValueError(f"the production mesh {spec.shape} needs a process group of "
                         f"{spec.n_chips} ranks")
    return make_local_mesh(device, model=spec.tp_degree, pod=spec.axis_size("pod"))


def init_distributed(device=None, *, init_method: str | None = None,
                     rank: int | None = None, world: int | None = None,
                     model: int = 1) -> LocalMesh:
    """Join the process group this process was started in and return its
    mesh, ``model`` ranks a row. ``rank`` / ``world`` default to ``RANK`` /
    ``WORLD_SIZE`` (1 when unset); a CUDA device defaults to
    ``cuda:LOCAL_RANK``. NCCL on CUDA, gloo on the CPU; ``init_method``
    defaults to ``env://``."""
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
    return make_local_mesh(device, model=model)
