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
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.compat import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotuner import search
from repro_torch.core.chunks import chunk_inventory, model_state_bytes
from repro_torch.core.cost_model import build_workload
from repro_torch.core.hardware import HARDWARE, LOCAL_CPU_HW, ONE_CHIP, local_cuda_hw
from repro_torch.core.plan import MemoryPlan, fully_resident_plan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models.model import num_repeats
from repro_torch.optim.adam import AdamConfig, cosine_schedule
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step_builder import build_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (smoke-scale) variant of the arch")
    ap.add_argument("--target-hw", default=None, choices=[None, *HARDWARE],
                    help="plan against this hardware spec instead of the local one")
    ap.add_argument("--plan", default="auto", choices=["auto", "resident", "fsdp"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without it)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
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
        w = build_workload(cfg, shape, ONE_CHIP, hw)
        # one device: check_train_plan runs only the plain reduction, so the
        # search keeps XLA-style sync without wire compression
        res = search(w, compress="off", sync="xla")
        plan = res.plan
        print(f"[train] searched plan: {plan.describe()} (modeled t_iter="
              f"{res.runtime.t_iteration:.3f}s, peak {res.memory.peak / 1e9:.2f}GB on {hw.name}, "
              f"feasible={res.feasible}, {res.search_seconds:.2f}s)")
        if device.type == "cpu":
            # the CPU is its own host: park the chunks on the device, keep
            # the block policies and the microbatching
            plan = dataclasses.replace(plan, n_host=0, n_persist=plan.n_chunks, n_buffer=0)
    elif args.plan == "fsdp":  # one device: every chunk already resident; checkpoint all
        plan = MemoryPlan(n_chunks=nc, n_blocks=nb, n_persist=nc, n_checkpoint=nb)
    else:
        plan = fully_resident_plan(nc, nb)
    print(f"[train] arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"state={model_state_bytes(chunks) / 1e9:.2f}GB device={device} "
          f"plan={plan.describe()}")

    art = build_train_step(
        cfg, plan, device, shape, adam=AdamConfig(lr=args.lr),
        lr_schedule=cosine_schedule(args.lr, warmup=min(20, args.steps // 10 + 1),
                                    total=args.steps))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=args.seed, device=device)
    mgr = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    res = train_loop(art, pipe, mgr,
                     LoopConfig(total_steps=args.steps, checkpoint_every=args.ckpt_every,
                                log_every=max(1, args.steps // 20)),
                     generator=torch.Generator(device=device).manual_seed(args.seed))
    print(json.dumps({
        "arch": cfg.name,
        "device": str(device),
        "steps": res.steps_run,
        "first_loss": res.losses[0] if res.losses else None,
        "final_loss": res.losses[-1] if res.losses else None,
        "final_ce": res.ces[-1] if res.ces else None,
        "resumed_from": res.resumed_from,
        "straggler_events": res.straggler_events,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
