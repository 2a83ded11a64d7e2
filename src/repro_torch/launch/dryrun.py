"""Dry-run: plan and build every (architecture x input shape) cell for one
rank of the production meshes without allocating, and record memory,
FLOPs, collectives and the roofline.

Port of ``src/repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --device cpu

Writes one JSON line a cell to ``reports/dryrun_cells_torch.jsonl`` (or
``--out DIR``; appended; completed cells are skipped on a re-run, so a
crashed sweep resumes). The reference's ``reports/dryrun_cells.jsonl`` is
the JAX package's, which its own tests read.

The reference lowers and compiles each cell for 256 or 512 forced host
devices. Here that becomes: join a fake process group of the mesh's world
size as rank 0 (``torch.distributed``'s ``fake`` backend: every collective
returns at once, nothing is sent), take this rank's mesh
(``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16 across two
pods), build the step -- ``build_train_step`` for training, the stateless
``build_prefill_step(chunk=None)`` for a prefill, the decode step through
``serve_layout`` and ``serve.prefill.ServeStep(graph=False)`` -- around
this rank's state, and run it once on fake tensors (``FakeTensorMode``:
shapes, dtypes and storages, no data, nothing allocated) under three
dispatch modes: ``torch.utils.flop_counter.FlopCounterMode``,
``launch.roofline.CollectiveRecorder`` (every collective the step issues)
and ``LiveBytes`` (every storage the step makes, live until its last
reference goes). The group is destroyed after the cell, so a caller's
process is left as it was (it must not hold a process group of its own).

``device`` picks the route the fake step accounts, never where it runs:
``"cuda"`` (the default, as for every entry point of the port; no card is
needed, the tensors are fake) sends the kernels' calls to their fakes
(``kernels/fake.py``: output shapes, dtypes and FLOPs), ``"cpu"`` to
their plain PyTorch versions, whose temporaries then count as live bytes.
Plans and roofline terms are priced on ``target_hw`` (default
``H100_SXM``, the data sheet): modeled, not measured.

A record keeps the reference's keys where they mean the same -- ``arch``,
``shape``, ``mesh``, ``mode``, ``sp``, ``plan``, ``plan_feasible``,
``modeled`` (``search`` / ``serve_plan`` / ``serve_memory_estimate``),
``ok``, and ``roofline.{t_compute_s, t_memory_s, t_collective_s,
bottleneck, flops_per_chip, hbm_gb_per_chip, collective_gb_raw,
collective_gb_corrected, by_kind_gb, model_flops_per_chip,
useful_flops_ratio}`` from the analytic totals -- and renames what has no
XLA here:

  reference            port
  -------------------  --------------------------------------------------
  lower_s, compile_s   build_s, run_s (the ``dryrun.build`` and
                       ``dryrun.run`` spans of the current telemetry's
                       tracer)
  xla_memory           memory: ``argument_gb`` (this rank's state and
                       batch on the device), ``output_gb``, ``temp_gb``
                       (the peak of the live bytes the step made on the
                       device), ``host_gb`` (the state the plan puts in
                       pinned host memory, plus the peak of swapped
                       activations); ``alias_gb`` is dropped; a decode
                       cell adds ``cache_gb`` (its cache on the device,
                       beside ``modeled.cache_gb``)
  xla_flops_raw        roofline.counted_flops: ``FlopCounterMode`` over
                       the fake step plus the kernels' fakes' FLOPs
  xla_bytes_raw        dropped: nothing counts it

beside the port's own ``route``, ``target_hw``, ``n_collectives`` and
``peak_gb`` (``argument_gb + temp_gb``: what the card's allocator would
report as its peak). On the CPU route a swapped activation stays on the
one device, so there it counts in ``temp_gb``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import obs
from repro_torch.compat import resolve_device, storage_key
from repro_torch.configs import ARCHS, get_config, get_shape, shapes_for
from repro_torch.core import (H100_SXM, HARDWARE, MULTI_POD, SINGLE_POD, MeshSpec,
                              build_workload, search)
from repro_torch.core.cost_model import serve_totals, step_totals
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.serve_plan import serve_memory_estimate, serve_plan
from repro_torch.kernels import fake as FK
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh, mesh_spec

REPORT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..", "reports"))
OUT_NAME = "dryrun_cells_torch.jsonl"


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------
def _register_fake_backend() -> None:
    """``torch.distributed``'s ``fake`` backend: the one its test utilities
    register, else a minimal registration of the same process group."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401  registers "fake"
        return
    except ImportError:
        pass
    if "fake" in dist.Backend.backend_list:
        return
    from torch._C._distributed_c10d import FakeProcessGroup

    def create(common_opts, backend_opts):
        make = getattr(FakeProcessGroup, "_create_internal", FakeProcessGroup)
        return make(common_opts.group_rank, common_opts.group_size, backend_opts)

    dist.Backend.register_backend("fake", create, extended_api=True, devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a fake process group of ``world`` ranks,
    for the block."""
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised: the dry-run joins a fake one "
                           "of its own")
    _register_fake_backend()
    dist.init_process_group("fake", rank=0, world_size=world, store=dist.HashStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages ops make under it, live from the op to
    the storage's last reference: the peak on the device and on the host
    (CPU storages beside a CUDA device). Storages in ``known`` (the
    arguments) are not counted. ``recorder`` (a ``CollectiveRecorder``)
    sees every op from here: one dispatch layer for both."""

    def __init__(self, device: torch.device, known: set[int],
                 recorder: RL.CollectiveRecorder):
        super().__init__()
        self.device_type = device.type
        self.seen = set(known)
        self.live = {"device": 0, "host": 0}
        self.peak = {"device": 0, "host": 0}
        self.recorder = recorder

    def _free(self, key: int, side: str, n: int) -> None:
        self.seen.discard(key)
        self.live[side] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.recorder.record(func, args, out)
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.seen:
                continue
            self.seen.add(key)
            side = "host" if t.device.type == "cpu" and self.device_type != "cpu" else "device"
            n = st.nbytes()
            self.live[side] += n
            self.peak[side] = max(self.peak[side], self.live[side])
            weakref.finalize(st, self._free, key, side, n)
        return out


def _bytes(tensors, *, host: bool | None = None, device_type: str = "cuda") -> int:
    """Bytes of the distinct storages of ``tensors``; ``host`` True / False
    keeps the CPU storages beside a CUDA device / the others."""
    seen, total = set(), 0
    for t in tensors:
        key = storage_key(t)
        on_host = t.device.type == "cpu" and device_type != "cpu"
        if key in seen or (host is not None and on_host != host):
            continue
        seen.add(key)
        total += t.untyped_storage().nbytes()
    return total


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _empty_tree(defs, device):
    from repro_torch.models import layers as L

    return L.map_defs(lambda d: torch.empty(d.shape, dtype=L.torch_dtype(d.dtype),
                                            device=device), defs)


def _batch(cfg, shape, device, labels: bool) -> dict:
    """A fake global batch: tokens (and labels), with an encoder-decoder's
    frames or a vision-language model's patches."""
    from repro_torch.models.layers import torch_dtype

    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    out = {"tokens": torch.empty(b, s, dtype=torch.int32, device=device)}
    if labels:
        out["labels"] = torch.empty(b, s, dtype=torch.int32, device=device)
    if cfg.kind == "encdec":
        out["frames"] = torch.empty(b, s, d, dtype=torch_dtype(cfg.dtype), device=device)
    if cfg.frontend == "vision_patches":
        out["patches"] = torch.empty(b, min(1024, s), d, dtype=torch_dtype(cfg.dtype),
                                     device=device)
    return out


def _host_state(state: dict, runs, plan: MemoryPlan) -> list[torch.Tensor]:
    """The training state's leaves that the plan puts in pinned host memory:
    a host chunk's optimizer states, and under ``host_params`` its weights."""
    first = plan.chunk_placement(0) == "host"
    last = plan.chunk_placement(plan.n_chunks - 1) == "host"
    on = {"embed": first, "encoder": first, "final_norm": last, "head": last}

    def pick(tree) -> list:
        out = [t for k, v in tree.items() if k != "runs" and on.get(k) for t in _tensors(v)]
        return out + [t for sub, r in zip(tree["runs"], runs) if r.placement == "host"
                      for t in _tensors(sub)]

    trees = [state["opt"][k] for k in ("master", "m", "v")]
    if plan.host_params:
        trees.append(state["params"])
    return [t for tree in trees for t in pick(tree)]


@dataclasses.dataclass
class _Built:
    """One cell's step for this rank around fake state (``_build``)."""

    run: object  # runs the step once
    args: list  # what it reads: the state and the batch
    host: list  # the state the plan puts in host memory
    views: list = dataclasses.field(default_factory=list)  # device views of host memory
    cache: list = dataclasses.field(default_factory=list)  # a decode's cache


def _build(cfg, shape, plan: MemoryPlan, mesh, device, trips: MicrobatchTrips,
           paging=None, chunk: int = 1) -> _Built:
    """The step of one cell for this rank, around fake state; a training
    step's microbatch loop is ``trips``. A paged decode reads its cold
    stores through device views of host memory, made once before the step
    as its warm-up makes them. A decode step takes ``paging`` (default: the
    plan's) and replays over ``chunk`` tokens."""
    from repro_torch.models import kvcache as KVC
    from repro_torch.models import model as M
    from repro_torch.serve.paging import init_paged_cache
    from repro_torch.serve.prefill import ServeStep
    from repro_torch.train import step_builder as SB

    if shape.is_training:
        art = SB.build_train_step(cfg, plan, device, shape, mesh=mesh, accumulate=trips)
        state = art.place_state(_empty_tree(art.defs, device))
        batch = _batch(cfg, shape, device, labels=True)
        return _Built(lambda: art.fn(state, batch)[1], _tensors(state) + _tensors(batch),
                      _host_state(state, art.runs, plan))
    full = _empty_tree(M.param_defs(cfg), device)
    if shape.mode == "prefill":
        art = SB.build_prefill_step(cfg, plan, device, shape, mesh=mesh)
        params = art.place_state(full)
        batch = _batch(cfg, shape, device, labels=False)
        return _Built(lambda: art.fn(params, batch), _tensors(params) + _tensors(batch), [])
    layout = SB.serve_layout(cfg, plan, shape, paging, mesh)
    params = layout.shard(full)
    slots = layout.slots[1]
    if layout.paging is None:
        cache = KVC.init_cache(cfg, slots, shape.seq_len, device, layout.tp)
    else:
        cache = init_paged_cache(cfg, slots, shape.seq_len, layout.paging, device, layout.tp)
    step = ServeStep(params, cache, cfg, layout.kv_io, batch=shape.global_batch, chunk=chunk,
                     device=device, graph=False, layout=layout, gather=layout.gather(params))

    def run():
        step.replay_once()
        if step.distributed:
            with torch.inference_mode():
                step.next_tok.copy_(layout.greedy(step.last, cfg))
        return step.next_tok

    cold = [leaf for entry in cache.values() for name, leaf in entry.items()
            if name.endswith("_cold")]  # pinned host memory beside a card
    views = [layout.kv_io._device_view(leaf, device) for leaf in cold]
    return _Built(run, _tensors(params) + _tensors(cache) + _tensors(step.__dict__), cold,
                  views, _tensors(cache))


class MicrobatchTrips:
    """The fake step's microbatch loop (``build_train_step(accumulate=)``):
    ``train/sync.accumulate_grads`` running two trips and counting the rest
    as the second, as the reference's roofline multiplies a loop body by
    its trip count. The second trip's collectives carry the multiplier
    ``microbatch - 1`` on ``rec``; its FLOPs (``flops`` and the kernels'
    ``kernel_flops``) count ``microbatch - 2`` times more, in ``extra``; the
    later trips fold the second's gradients again. The live bytes are the
    second trip's, whose accumulators are already there. At one or two
    microbatches every trip runs. ``fake_step`` sets ``rec``, ``flops`` and
    ``kernel_flops`` before the step runs."""

    def __init__(self):
        self.rec: RL.CollectiveRecorder | None = None
        self.flops: FlopCounterMode | None = None
        self.kernel_flops: dict = {}
        self.extra = 0.0

    def __call__(self, micro_grad, batch, microbatch, overlap=False):
        from repro_torch.train.sync import accumulate_grads, ready

        if microbatch <= 2:
            return accumulate_grads(micro_grad, batch, microbatch, overlap)
        trips: list = []

        def trip(mb):
            if len(trips) == 0:
                trips.append(None)
                return micro_grad(mb)
            if len(trips) == 1:
                f0, k0 = self.flops.get_total_flops(), sum(self.kernel_flops.values())
                self.rec.multiplier = microbatch - 1
                g, loss = micro_grad(mb)
                g = ready(g)
                self.rec.multiplier = 1.0
                body = (self.flops.get_total_flops() - f0
                        + sum(self.kernel_flops.values()) - k0)
                self.extra += body * (microbatch - 2)
                trips.append((g, loss))
            return trips[1]

        return accumulate_grads(trip, batch, microbatch, overlap)


def fake_step(cfg, shape, plan: MemoryPlan, spec: MeshSpec, device, tracer=None,
              tags: dict | None = None, **build_kw) -> dict:
    """Build and run one step for rank 0 of a mesh of ``spec``'s geometry
    (a world of one without a process group) on fake tensors: its memory,
    counted FLOPs, collectives and spans. ``build_kw``: a decode step's
    ``paging`` and ``chunk``."""
    device = torch.device(device)
    tracer = tracer if tracer is not None else obs.current_telemetry().tracer
    tags = tags or {}
    world = contextlib.nullcontext() if spec.n_chips == 1 else fake_world(spec.n_chips)
    with world, FakeTensorMode():
        with tracer.span("dryrun.build", **tags) as bsp:
            if spec in (SINGLE_POD, MULTI_POD):
                mesh = make_production_mesh(multi_pod=spec == MULTI_POD, device=device)
            else:
                mesh = make_local_mesh(device, model=spec.tp_degree, pod=spec.axis_size("pod"))
            trips = MicrobatchTrips()
            built = _build(cfg, shape, plan, mesh, device, trips, **build_kw)
        args = built.args
        known = {storage_key(t) for t in args + built.views}
        rec = RL.CollectiveRecorder()
        live = LiveBytes(device, known, recorder=rec)
        with tracer.span("dryrun.run", **tags) as rsp:
            with FK.counting() as kernel_flops, FlopCounterMode(display=False) as fc, live:
                trips.rec, trips.flops, trips.kernel_flops = rec, fc, kernel_flops
                out = built.run()
        dt = device.type
        host = {storage_key(t) for t in built.host}  # host memory on either route
        return {
            "build_s": round(bsp.dur_s, 2), "run_s": round(rsp.dur_s, 2),
            "collectives": rec.ops,
            "counted_flops": (float(fc.get_total_flops()) + sum(kernel_flops.values())
                              + trips.extra),
            "kernel_flops": kernel_flops,
            "memory": {
                "argument_gb": _bytes([t for t in args if storage_key(t) not in host],
                                      host=False, device_type=dt) / 1e9,
                "output_gb": _bytes(_tensors(out), host=False, device_type=dt) / 1e9,
                "temp_gb": live.peak["device"] / 1e9,
                "host_gb": (_bytes(built.host) + live.peak["host"]) / 1e9,
                **({"cache_gb": _bytes([t for t in built.cache if storage_key(t) not in host],
                                       host=False, device_type=dt) / 1e9}
                   if built.cache else {}),
            },
        }


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellPlan:
    """A cell's plan and its analytic totals a chip (``plan_cell``)."""

    record: dict  # the record's planning keys
    cfg: object
    shape: object
    mspec: MeshSpec
    plan: MemoryPlan
    flops_per_chip: float
    hbm_bytes_per_chip: float
    model_flops_per_chip: float


def plan_cell(arch: str, shape_name: str, multi_pod: bool, *, sp: str = "off",
              plan_override: MemoryPlan | None = None, target_hw=H100_SXM) -> CellPlan:
    """The planning half of ``run_cell``, as the reference plans a cell:
    ``search`` (or ``plan_override``) for training, ``serve_plan`` and
    ``serve_memory_estimate`` for serving, priced on ``target_hw``; the
    analytic FLOPs and bytes a chip (``step_totals``, ``serve_totals``,
    ``decode_totals``) and the model's useful FLOPs a chip."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mspec = mesh_spec(multi_pod=multi_pod)
    hw = target_hw
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "multi" if multi_pod else "single",
        "mode": shape.mode, "sp": sp, "target_hw": hw.name,
    }
    if shape.is_training:
        from repro_torch.core import estimate_memory, estimate_runtime

        w = build_workload(cfg, shape, mspec, hw)
        if plan_override is not None:
            plan = plan_override
            if plan.dp_only:
                new = (MeshSpec((mspec.axis_size("pod"),
                                 mspec.n_chips // mspec.axis_size("pod")), ("pod", "data"))
                       if "pod" in mspec.axes else MeshSpec((mspec.n_chips,), ("data",)))
                w = dataclasses.replace(w, mesh=new)
            rt, mem = estimate_runtime(w, plan), estimate_memory(w, plan)
            rec["plan_feasible"] = mem.peak < hw.capacity_bytes()
        else:
            res = search(w, sp=sp)
            plan = res.plan
            rt, mem = res.runtime, res.memory
            rec["plan_feasible"] = res.feasible
        rec["plan"] = plan.describe() + (" dp" if plan.dp_only else "") + (
            " sp" if plan.seq_shard_acts else "")
        rec["modeled"] = {
            "t_iteration_s": rt.t_iteration,
            "tokens_per_s": rt.tokens_per_second,
            "peak_gb_per_chip": mem.peak / 1e9,
        }
        flops_dev, bytes_dev = step_totals(w, plan)
        tokens = shape.global_batch * shape.seq_len
        model_flops = 6.0 * cfg.active_param_count() * tokens / mspec.n_chips
    else:
        plan = plan_override or serve_plan(cfg, shape, mspec, hw)
        rec["plan"] = plan.describe()
        rec["modeled"] = serve_memory_estimate(cfg, shape, mspec, plan)
        if shape.mode == "prefill":
            w = build_workload(cfg, shape, mspec, hw)
            flops_dev, bytes_dev = serve_totals(w, plan)
            tokens = shape.global_batch * shape.seq_len
            model_flops = 2.0 * cfg.active_param_count() * tokens / mspec.n_chips
        else:
            flops_dev, bytes_dev = decode_totals(cfg, shape, mspec)
            model_flops = 2.0 * cfg.active_param_count() * shape.global_batch / mspec.n_chips
    return CellPlan(rec, cfg, shape, mspec, plan, flops_dev, bytes_dev, model_flops)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, sp: str = "off",
             plan_override: MemoryPlan | None = None, device=None,
             target_hw=H100_SXM) -> dict:
    """Plan one cell on ``target_hw`` (``plan_cell``) and build its step for
    rank 0 of the production mesh on fake tensors (see the module
    docstring)."""
    device = resolve_device(device)
    cell = plan_cell(arch, shape_name, multi_pod, sp=sp, plan_override=plan_override,
                     target_hw=target_hw)
    rec = cell.record
    rec["route"] = "kernels" if device.type == "cuda" else "plain"
    tracer = obs.current_telemetry().tracer
    tags = dict(arch=arch, shape=shape_name, mesh=rec["mesh"])
    built = fake_step(cell.cfg, cell.shape, cell.plan, cell.mspec, device, tracer, tags)
    rec["build_s"], rec["run_s"] = built["build_s"], built["run_s"]
    rec["memory"] = built["memory"]
    rec["peak_gb"] = built["memory"]["argument_gb"] + built["memory"]["temp_gb"]
    rep = RL.analyze(
        collectives=built["collectives"],
        flops_per_chip=cell.flops_per_chip,
        hbm_bytes_per_chip=cell.hbm_bytes_per_chip,
        model_flops_per_chip=cell.model_flops_per_chip,
        hw=target_hw,
    )
    rec["n_collectives"] = len(built["collectives"])
    rec["roofline"] = {
        "t_compute_s": rep.t_compute,
        "t_memory_s": rep.t_memory,
        "t_collective_s": rep.t_collective,
        "bottleneck": rep.bottleneck,
        "flops_per_chip": rep.flops_per_chip,
        "hbm_gb_per_chip": rep.hbm_bytes_per_chip / 1e9,
        "collective_gb_raw": rep.collective_bytes_raw / 1e9,
        "collective_gb_corrected": rep.collective_bytes_corrected / 1e9,
        "by_kind_gb": {k: v / 1e9 for k, v in rep.by_kind.items()},
        "model_flops_per_chip": rep.model_flops,
        "useful_flops_ratio": rep.useful_flops_ratio,
        "counted_flops": built["counted_flops"],
    }
    rec["ok"] = True
    return rec


def decode_totals(cfg, shape, mspec) -> tuple[float, float]:
    """A decode step's analytic (FLOPs, bytes) a chip, the reference's
    formula (``src/repro/launch/dryrun.py:101-112``): every active
    parameter once a slot, the weights and the rank's cache read once."""
    from repro_torch.core.chunks import chunk_inventory
    from repro_torch.core.serve_plan import cache_bytes_per_device

    b_loc = shape.global_batch / mspec.zero_degree
    flops = 2.0 * cfg.active_param_count() * b_loc / mspec.tp_degree
    nbytes = (sum(c.param_bytes for c in chunk_inventory(cfg)) / mspec.tp_degree
              + cache_bytes_per_device(cfg, shape, mspec))
    return flops, nbytes


def run_megatrain(arch: str, shape_name: str, *, device=None, target_hw=H100_SXM) -> dict:
    """MegaTrain demo (PAPERS.md): plan a 100B+ config with every chunk on
    the all-host optimizer tier -- bf16 weight and gradient shards on the
    device, fp32 Adam states and the update on the host
    (``core.autotuner.megatrain_plan``) -- then build it like any cell.
    Asserts that the planned device footprint fits
    ``target_hw.capacity_bytes()`` before building; the record's
    ``memory.host_gb`` shows the states in pinned host memory."""
    from repro_torch.core import estimate_memory
    from repro_torch.core.autotuner import megatrain_plan

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    assert shape.is_training, "--megatrain is a training-path demo"
    assert cfg.param_count() >= 100e9, (
        f"--megatrain demonstrates the 100B+ tier; {arch} is too small")
    hw = target_hw
    w = build_workload(cfg, shape, mesh_spec(multi_pod=False), hw)
    plan = megatrain_plan(w)
    mem = estimate_memory(w, plan)
    assert mem.peak < hw.capacity_bytes(), (
        f"MegaTrain plan overflows the chip: planned {mem.peak / 1e9:.1f} GB "
        f">= capacity {hw.capacity_bytes() / 1e9:.1f} GB")
    rec = run_cell(arch, shape_name, False, plan_override=plan, device=device, target_hw=hw)
    rec["megatrain"] = {
        "planned_peak_gb": round(mem.peak / 1e9, 3),
        "capacity_gb": round(hw.capacity_bytes() / 1e9, 3),
        "model_states_gb": round(mem.model_states / 1e9, 3),
    }
    return rec


def cells(archs, shapes_filter=None):
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if shapes_filter and shape.name not in shapes_filter:
                continue
            yield arch, shape.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sp", default="off", choices=["off", "on", "auto"])
    ap.add_argument("--megatrain", action="store_true",
                    help="one-cell MegaTrain demo: all-host optimizer tier "
                         "on a 100B+ model (default llama3-405b x train_4k)")
    ap.add_argument("--out", default=None, help=f"directory of {OUT_NAME} (default reports/)")
    ap.add_argument("--target-hw", default=H100_SXM.name, choices=sorted(HARDWARE),
                    help="the data sheet plans and roofline terms are priced on")
    ap.add_argument("--device", default=None,
                    help="the route the fake step accounts: cuda (default, the kernels' "
                         "fakes) or cpu (the plain versions); nothing runs there")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    hw = HARDWARE[args.target_hw]

    out_dir = args.out or REPORT
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, OUT_NAME)

    if args.megatrain:
        rec = run_megatrain(args.arch or "llama3-405b", args.shape or "train_4k",
                            device=device, target_hw=hw)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        mt, xm = rec["megatrain"], rec["memory"]
        print(f"[dryrun] MEGATRAIN OK {rec['arch']} x {rec['shape']}: "
              f"plan [{rec['plan']}] planned {mt['planned_peak_gb']}GB "
              f"< capacity {mt['capacity_gb']}GB; built temp "
              f"{xm['temp_gb']:.2f}GB host {xm['host_gb']:.2f}GB", flush=True)
        return 0
    done = set()
    if os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"], r.get("sp", "off")))
                except json.JSONDecodeError:
                    pass

    archs = [args.arch] if args.arch else sorted(ARCHS)
    shape_filter = {args.shape} if args.shape else None
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    todo = [(a, s, mp) for a, s in cells(archs, shape_filter) for mp in meshes]
    print(f"[dryrun] {len(todo)} cells ({len(done)} already done)", flush=True)
    failures = 0
    for arch, shape, mp in todo:
        key = (arch, shape, "multi" if mp else "single", args.sp)
        if key in done:
            continue
        tag = f"{arch} x {shape} x {key[2]}"
        try:
            rec = run_cell(arch, shape, mp, sp=args.sp, device=device, target_hw=hw)
            rl = rec["roofline"]
            print(f"[dryrun] OK  {tag}: bottleneck={rl['bottleneck']} "
                  f"comp={rl['t_compute_s']:.3f}s mem={rl['t_memory_s']:.3f}s "
                  f"coll={rl['t_collective_s']:.3f}s (build {rec['build_s']}s, "
                  f"run {rec['run_s']}s)", flush=True)
        except Exception as e:
            failures += 1
            rec = {"arch": arch, "shape": shape, "mesh": key[2], "sp": args.sp,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            print(f"[dryrun] FAIL {tag}: {type(e).__name__}: {str(e)[:200]}", flush=True)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    print(f"[dryrun] complete, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
