"""End-to-end training launcher of the port.

    python -m repro_torch.launch.train --arch gpt2-1b --steps 20 --batch 2 --seq 1024
    python -m repro_torch.launch.train --arch stablelm-3b --reduced \\
        --steps 4 --batch 2 --seq 64 --plan resident --device cpu
    python -m repro_torch.launch.train --arch qwen2-moe-a2.7b --reduced \\
        --steps 4 --batch 2 --seq 64 --device cpu
    python -m repro_torch.launch.train --arch mamba2-130m --batch 1 --seq 32768 --steps 4
    python -m repro_torch.launch.train --arch seamless-m4t-large-v2 --batch 1 --seq 4096 \\
        --steps 2
    python -m repro_torch.launch.train --arch llava-next-34b --reduced --steps 2 \\
        --batch 2 --seq 64 --device cpu
    python -m repro_torch.launch.train --arch llama3-405b --reduced --nproc 4 \\
        --steps 4 --batch 16 --seq 32 --device cpu        # 4 gloo ranks, spawned
    python -m repro_torch.launch.train --arch llama3-405b --reduced --nproc 4 \\
        --steps 4 --batch 16 --seq 32 --device cpu --plan fsdp   # the xla path
    python -m repro_torch.launch.train --arch llama3-405b --reduced --nproc 4 \\
        --model 2 --steps 4 --batch 16 --seq 32 --device cpu     # data 2 x model 2
    python -m repro_torch.launch.train --arch mamba2-130m --reduced --nproc 4 \\
        --model 2 --steps 4 --batch 16 --seq 32 --device cpu     # any family
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch mistral-7b \\
        --nproc 4 --plan zero3 --batch 4 --seq 4096        # 4 NCCL ranks

The PyTorch counterpart of ``src/repro/launch/train.py``: picks the
architecture (``--reduced``: the tiny same-family config), builds the plan,
the plan-realized step, the synthetic data pipeline and the fault-tolerant
loop with checkpoints and auto-resume. Dense, MoE, Mamba-2
(``mamba2-130m``) and hybrid (``jamba-1.5-large-398b``, at ``--reduced``
on one card) decoders run, and the encoder-decoder
(``seamless-m4t-large-v2``: its batches carry seeded frames of ``--seq``
rows, its encoder trains in the front chunk with the embedding) and the
vision-language model (``llava-next-34b``: its batches carry min(1024,
``--seq``) seeded patches, which run ahead of the tokens through every
layer; at full width its 550 GB of training state outgrow one card and
its host, which ``chip_smoke.py``'s ``vlm_plan`` meets by cutting the
depth); an MoE's
loss is its cross-entropy plus the aux loss, and the loop logs both.
Weights are random, drawn on the device from ``--seed``. Runs on CUDA
unless ``--device cpu``. Prints the plan, then one JSON summary line.

Plans: ``auto`` (the default) is ProTrain's search (``core.autotuner``)
against ``--target-hw`` (a ``core.hardware.HARDWARE`` name) or, without
one, this card's spec (``local_cuda_hw``; ``LOCAL_CPU_HW`` on the CPU). On
CUDA the searched plan runs as searched: its host chunks live in pinned
host memory, and the allocator grows its device segments in place
(``expandable_segments``, set before the first allocation): a plan searched
near the card's capacity otherwise leaves blocks reserved between
allocations, and the searched plans of ``mistral-7b`` and
``qwen2-moe-a2.7b`` ran out of memory without it on the H100. On the CPU,
as the JAX launcher does, the chunks are parked on the device and the block
policies kept. ``resident``: every chunk
persistent, no remat; ``fsdp``: every block checkpointed.

Data parallelism: ``--nproc N`` trains on N ranks, each on its rows of
the global batch, under the plan's gradient sync: the xla path's sharded
layouts (``train/sync.XlaSync``: ZeRO-sharded and host chunks, swap,
``zero1_persistent``) or the manual kinds (``train/sync.ManualSync``).
Under ``torchrun`` (``WORLD_SIZE`` set) the process is one rank; otherwise
it spawns the N ranks itself, joined through a ``file://`` store in a
temporary directory. Rank r runs on ``cuda:r`` (NCCL) or, with ``--device
cpu``, on the CPU (gloo). ``auto`` then searches both sync modes on
``MeshSpec((N,), ("data",))``, as the reference's launcher searches its
mesh, and the plan runs as searched (host chunks and all, on the CPU too);
``fsdp`` (every chunk ZeRO-sharded, every block checkpointed) and
``resident`` run through the xla path; ``ddp``, ``zero2`` and ``zero3``
name the manual kinds (int8 + EF on the wire). Rank 0 prints the plan and
the JSON line, with the plan, the sync strategy's kind and the world size;
each rank keeps its own checkpoint file.

Tensor parallelism: ``--model M`` lays the N ranks out as ``(N / M, M)``,
data by model (``launch/mesh.py``; the default 1 keeps ``--nproc N`` data
N). Every family splits its ``tp`` and ``exp`` dims over the model axis
(``dist/tensor_parallel.py``): the dense and MoE decoders, Mamba-2 and
the hybrid (on a rank's SSD heads), the encoder-decoder (its frames'
encoder and the cross-attention too) and the VLM (its patches ahead of
the tokens); ``auto`` then searches on
``MeshSpec((N / M, M), ("data", "model"))`` with sequence sharding and
``dp_only`` among the candidates, and the searched plan runs. The
reference's ``make_local_mesh`` picks the model extent (4, 2 or 1) by the
device count; here the caller picks it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.compat import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotuner import search
from repro_torch.core.chunks import chunk_inventory, model_state_bytes
from repro_torch.core.cost_model import build_workload
from repro_torch.core.hardware import HARDWARE, LOCAL_CPU_HW, ONE_CHIP, MeshSpec, local_cuda_hw
from repro_torch.core.plan import MemoryPlan, fully_resident_plan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch.mesh import init_distributed
from repro_torch.models.model import num_repeats
from repro_torch.optim.adam import AdamConfig, cosine_schedule
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step_builder import build_train_step


MANUAL_PLANS = {  # --plan: the manual kinds, int8 + EF on the wire
    "ddp": lambda nc: dict(n_persist=nc),
    "zero2": lambda nc: dict(n_persist=0, zero_stage=2),
    "zero3": lambda nc: dict(n_persist=0),
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch, over every rank")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke-scale) variant of the arch")
    ap.add_argument("--target-hw", default=None, choices=[None, *HARDWARE],
                    help="plan against this hardware spec instead of the local one")
    ap.add_argument("--plan", default="auto",
                    choices=["auto", "resident", "fsdp", *MANUAL_PLANS])
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks; spawned unless under torchrun")
    ap.add_argument("--model", type=int, default=1,
                    help="the model axis's extent: the ranks laid out (nproc / model, model)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without it)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.nproc > 1 and "WORLD_SIZE" not in os.environ:
        return spawn(args, argv)
    summary = run(args)
    if summary is not None:
        print(json.dumps(summary))
    return 0


def spawn(args, argv) -> int:
    """Run ``args.nproc`` ranks of this launcher as processes of their own,
    then print rank 0's JSON line."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.nproc, argv, tmp), nprocs=args.nproc, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "summary.json")) as f:
            print(f.read().strip())
    return 0


def _rank(rank: int, world: int, argv, tmp: str) -> None:
    args = parse_args(argv)
    summary = run(args, rank=rank, world=world, init_method=f"file://{tmp}/store")
    if summary is not None:
        with open(os.path.join(tmp, "summary.json"), "w") as f:
            f.write(json.dumps(summary))


def run(args, *, rank: int | None = None, world: int | None = None,
        init_method: str | None = None) -> dict | None:
    """Train as one rank (of ``world``; default: ``RANK`` / ``WORLD_SIZE``);
    returns rank 0's summary (None on the other ranks)."""
    device, mesh = resolve_device(args.device), None
    if args.nproc % args.model:
        raise ValueError(f"--model {args.model} does not divide --nproc {args.nproc}")
    if args.nproc > 1:
        if device.type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.nproc))
        mesh = init_distributed(device, init_method=init_method, rank=rank, world=world,
                                model=args.model)
        if mesh.world != args.nproc:
            raise ValueError(f"--nproc {args.nproc}, but the process group has {mesh.world} "
                             "ranks")
        device = mesh.device
    try:
        return _train(args, device, mesh)
    finally:
        if mesh is not None and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, device, mesh) -> dict | None:
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if device.type == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    world = 1 if mesh is None else mesh.world
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    chunks = chunk_inventory(cfg)
    nc, nb = len(chunks), num_repeats(cfg)
    if args.plan == "auto":
        if args.target_hw:
            hw = HARDWARE[args.target_hw]
        else:
            hw = local_cuda_hw(device) if device.type == "cuda" else LOCAL_CPU_HW
        if world == 1:
            # one device: the plain reduction; compression buys nothing there
            res = search(build_workload(cfg, shape, ONE_CHIP, hw), compress="off", sync="xla")
        elif mesh.model == 1:
            res = search(build_workload(cfg, shape, MeshSpec((world,), ("data",)), hw))
        else:  # the model axis: sequence sharding and dp_only are candidates too
            res = search(build_workload(cfg, shape, mesh.spec, hw), sp="auto", dp="auto")
        plan = res.plan
        say(f"[train] searched plan: {plan.describe()} (modeled t_iter="
            f"{res.runtime.t_iteration:.3f}s, peak {res.memory.peak / 1e9:.2f}GB on {hw.name}, "
            f"feasible={res.feasible}, {res.search_seconds:.2f}s)")
        if device.type == "cpu" and world == 1:
            # the CPU is its own host: park the chunks on the device, keep
            # the block policies and the microbatching
            plan = dataclasses.replace(plan, n_host=0, n_persist=plan.n_chunks, n_buffer=0)
    elif args.plan in MANUAL_PLANS:
        plan = MemoryPlan(n_chunks=nc, n_blocks=nb, sync_mode="manual",
                          grad_compress="int8_ef", **MANUAL_PLANS[args.plan](nc))
    elif args.plan == "fsdp":  # every chunk ZeRO-sharded (one device: all of it there)
        plan = MemoryPlan(n_chunks=nc, n_blocks=nb, n_checkpoint=nb)
    else:
        plan = fully_resident_plan(nc, nb)
    say(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
        f"state={model_state_bytes(chunks) / 1e9:.2f}GB device={device} world={world} "
        f"plan={plan.describe()}")

    art = build_train_step(
        cfg, plan, device, shape, mesh=mesh, adam=AdamConfig(lr=args.lr),
        lr_schedule=cosine_schedule(args.lr, warmup=min(20, args.steps // 10 + 1),
                                    total=args.steps))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=args.seed, device=device)
    mgr = (CheckpointManager(args.ckpt_dir, keep=2, rank=0 if mesh is None else mesh.rank,
                             world=world) if args.ckpt_dir else None)
    res = train_loop(art, pipe, mgr,
                     LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                                log_every=max(1, args.steps // 20)),
                     generator=torch.Generator(device=device).manual_seed(args.seed), log=say)
    if not lead:
        return None
    return {
        "arch": cfg.name,
        "device": str(device),
        "steps": res.steps_run,
        "first_loss": res.losses[0] if res.losses else None,
        "final_loss": res.losses[-1] if res.losses else None,
        "final_ce": res.ces[-1] if res.ces else None,
        "resumed_from": res.resumed_from,
        "straggler_events": res.straggler_events,
        "plan": plan.describe(),
        "strategy": art.strategy.kind,
        "world": world,
        "model": 1 if mesh is None else mesh.model,
        "dp_only": plan.dp_only,
        "seq_shard_acts": plan.seq_shard_acts,
    }


if __name__ == "__main__":
    raise SystemExit(main())
