"""Serve a synthetic request stream through the port's ``DecodeEngine``.

The PyTorch counterpart of ``examples/serve_lm.py``, at full width by
default (``--reduced`` picks the tiny same-family config):

    python -m repro_torch.launch.serve --arch mistral-7b --plan paged \\
        --seq-len 1024 --requests 4 --max-new 16 --prompt-len 520 799 \\
        --page-size 256 --hot-pages 2

``--arch qwen2-moe-a2.7b`` serves the MoE family the same way,
``--arch mamba2-130m`` the Mamba-2 family, ``--arch
jamba-1.5-large-398b --reduced`` the hybrid, ``--arch
seamless-m4t-large-v2`` the encoder-decoder's decoder and ``--arch
llava-next-34b`` the vision-language model's decoder, on its tokens alone
(image patches enter only through ``models.model.forward``, in training and
``train.step_builder.build_prefill_step``, as in the JAX package; its 68.8
GB of bf16 weights fill most of one 80 GB card). The engine leaves
an encoder-decoder's cross-attention cache as ``init_cache`` makes it,
zeros, as the JAX engine does (its admission zeroes a slot's whole cache
and nothing fills it from frames); ``models.kvcache.prime_cross_cache``
fills it from an encoder's output where a caller has one. Weights are
random, drawn on the device from ``--seed``; prompts come from a numpy
generator seeded the same way. ``--plan resident`` keeps the whole cache on the device;
``--plan paged`` keeps a hot ring there and the cold pages in pinned host
memory (the default where the model has attention; a Mamba-2 position's
state is never paged); the default prompt lengths (520 to 799 tokens) reach
past a 2-page hot window of 256-token pages, so attention reads cold rows.
``--admission`` defaults to the engine's choice: ``replay`` for an
attention-free model, else ``chunked``. Runs on CUDA unless ``--device
cpu``. Prints one JSON line: the engine report, tokens/s, TTFT, the cache
bytes and the bytes attention read from the cold store (``h2d_bytes``).

On a mesh: ``--nproc N --model M`` serves on N ranks laid out data N / M
by model M (``launch/mesh.py``), as ``launch.train`` does: under
``torchrun`` (``WORLD_SIZE`` set) the process is one rank, NCCL on
``cuda:LOCAL_RANK``; otherwise it spawns the N ranks itself, joined
through a ``file://`` store in a temporary directory, gloo with ``--device
cpu``. Every rank draws the whole model from ``--seed`` and keeps its
shards; each holds the cache of its slots and heads; rank 0 prints the
JSON line, with the world, its own cache and cold bytes and their sums
over the ranks.

``--plan auto`` takes the plan ``core.serve_plan`` chooses for the mesh on
this card's spec (the host's on the CPU), its device memory ``--hbm-gb``
where given: resident, paged (at the planner's page size), or, where the
weights overflow, every chunk ZeRO-sharded over the data ranks
(``n_persist = 0``, a resident cache), each layer gathered a layer ahead:

    python -m repro_torch.launch.serve --arch mistral-7b --reduced --nproc 4 \\
        --model 2 --seq-len 64 --prompt-len 5 20 --page-size 16 --device cpu
    python -m repro_torch.launch.serve --arch mistral-7b --reduced --nproc 4 \\
        --model 2 --seq-len 64 --plan auto --hbm-gb 0.0005 --device cpu  # n_persist=0
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch mistral-7b \\
        --nproc 2 --model 2           # 2 NCCL ranks, one a card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.hardware import LOCAL_CPU_HW, ONE_CHIP, HardwareSpec, local_cuda_hw
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.serve_plan import paging_from_plan, serve_plan
from repro_torch.launch.mesh import init_distributed
from repro_torch.models import kvcache as KV
from repro_torch.models.model import init_params, num_repeats
from repro_torch.serve import DecodeEngine, Request, choose_paging


def build_requests(n: int, vocab: int, max_new: int, lo: int, hi: int,
                   seed: int) -> list[Request]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [Request(i, rng.integers(1, vocab, int(k)).tolist(), max_new)
            for i, k in enumerate(lens)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mistral-7b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--plan", choices=["resident", "paged", "auto"], default=None,
                    help="default: paged, resident for an attention-free model; auto: "
                         "core.serve_plan's choice")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="--plan auto: the device memory planned for, GB")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(520, 799),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--hot-pages", type=int, default=2)
    ap.add_argument("--admission", default=None, choices=["replay", "chunked", "whole"],
                    help="default: replay for an attention-free model, else chunked")
    ap.add_argument("--prefill-chunk", type=int, default=32)
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
        return 0 if summary["drained"] else 1
    return 0


def spawn(args, argv) -> int:
    """Run ``args.nproc`` ranks of this launcher as processes of their own,
    then print rank 0's JSON line."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank, args=(args.nproc, argv, tmp), nprocs=args.nproc, join=True,
                           start_method="spawn")
        with open(os.path.join(tmp, "summary.json")) as f:
            summary = json.loads(f.read())
    print(json.dumps(summary))
    return 0 if summary["drained"] else 1


def _rank(rank: int, world: int, argv, tmp: str) -> None:
    args = parse_args(argv)
    summary = run(args, rank=rank, world=world, init_method=f"file://{tmp}/store")
    if summary is not None:
        with open(os.path.join(tmp, "summary.json"), "w") as f:
            f.write(json.dumps(summary))


def run(args, *, rank: int | None = None, world: int | None = None,
        init_method: str | None = None) -> dict | None:
    """Serve as one rank (of ``world``; default: ``RANK`` / ``WORLD_SIZE``);
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
        return _serve(args, device, mesh)
    finally:
        if mesh is not None and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def planning_hw(args, device) -> HardwareSpec:
    """The device ``--plan auto`` plans for: this one, with ``--hbm-gb`` of
    device memory where given."""
    hw = local_cuda_hw(device) if device.type == "cuda" else LOCAL_CPU_HW
    if args.hbm_gb is not None:
        hw = dataclasses.replace(hw, hbm_bytes=args.hbm_gb * 1e9)
    return hw


def _serve(args, device, mesh) -> dict | None:
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.plan is None:
        args.plan = "resident" if cfg.attention_free else "paged"
    shape = ShapeConfig("serve", args.seq_len, args.batch_slots, "decode")
    n_chunks = num_repeats(cfg) + 2  # embedding + one per block + head
    paging = None
    plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks)
    if args.plan == "auto":
        plan = serve_plan(cfg, shape, ONE_CHIP if mesh is None else mesh.spec,
                          planning_hw(args, device))
        paging = paging_from_plan(cfg, shape, plan)
    if args.plan == "paged":
        paging = choose_paging(KV.cache_len(cfg, args.seq_len), args.page_size, args.hot_pages)
        plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks, n_host=paging.n_cold)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    engine = DecodeEngine(cfg, plan, None if mesh else device, shape, params, paging=paging,
                          own_params=True, admission=args.admission,
                          prefill_chunk=args.prefill_chunk, mesh=mesh)
    del params  # on a mesh the engine keeps this rank's shards
    engine.warmup()
    report = engine.run(build_requests(args.requests, cfg.vocab_size, args.max_new,
                                       *args.prompt_len, seed=args.seed))
    if mesh is not None and mesh.rank != 0:
        return None
    h2d = engine.tel.registry.snapshot()["serve.h2d_bytes"]["value"]
    return {
        "arch": cfg.name, "device": str(device),
        "world": 1 if mesh is None else mesh.world, "model": 1 if mesh is None else mesh.model,
        "plan": args.plan, "n_persist": plan.n_persist, "n_chunks": plan.n_chunks,
        "paging": None if paging is None else
        [paging.page_size, paging.n_pages, paging.n_hot],
        **report.to_dict(),
        "hbm_cache_bytes": report.hbm_cache_bytes,
        "host_cache_bytes": report.host_cache_bytes,
        "resident_cache_bytes": report.resident_cache_bytes,
        "h2d_bytes": h2d,
        "finished": {str(k): v for k, v in sorted(report.finished.items())},
    }


if __name__ == "__main__":
    raise SystemExit(main())
