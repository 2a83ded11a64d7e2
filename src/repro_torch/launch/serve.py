"""Serve a synthetic request stream through the port's ``DecodeEngine``.

The PyTorch counterpart of ``examples/serve_lm.py``, at full width by
default (``--reduced`` picks the tiny same-family config):

    python -m repro_torch.launch.serve --arch mistral-7b --plan paged \\
        --seq-len 1024 --requests 4 --max-new 16 --prompt-len 520 799 \\
        --page-size 256 --hot-pages 2

Weights are random, drawn on the device from ``--seed``; prompts come from
a numpy generator seeded the same way. ``--plan resident`` keeps the whole
cache on the device; ``--plan paged`` keeps a hot ring there and the cold
pages in pinned host memory; the default prompt lengths (520 to 799
tokens) reach past a 2-page hot window of 256-token pages, so attention
reads cold rows. Runs on CUDA unless ``--device cpu``. Prints one JSON
line: the engine report, tokens/s, TTFT, the cache bytes and the bytes
attention read from the cold store (``h2d_bytes``).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.models import kvcache as KV
from repro_torch.models.model import init_params, num_repeats
from repro_torch.serve import DecodeEngine, Request, choose_paging


def build_requests(n: int, vocab: int, max_new: int, lo: int, hi: int,
                   seed: int) -> list[Request]:
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, size=n)
    return [Request(i, rng.integers(1, vocab, int(k)).tolist(), max_new)
            for i, k in enumerate(lens)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="mistral-7b")
    ap.add_argument("--reduced", action="store_true", help="tiny same-family config")
    ap.add_argument("--plan", choices=["resident", "paged"], default="paged")
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(520, 799),
                    metavar=("MIN", "MAX"))
    ap.add_argument("--page-size", type=int, default=256)
    ap.add_argument("--hot-pages", type=int, default=2)
    ap.add_argument("--admission", default="chunked", choices=["replay", "chunked", "whole"])
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda (raises without it)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("serve", args.seq_len, args.batch_slots, "decode")
    n_chunks = num_repeats(cfg) + 2  # embedding + one per block + head
    paging = None
    plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks)
    if args.plan == "paged":
        paging = choose_paging(KV.cache_len(cfg, args.seq_len), args.page_size, args.hot_pages)
        plan = MemoryPlan(n_chunks, num_repeats(cfg), n_persist=n_chunks, n_host=paging.n_cold)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    engine = DecodeEngine(cfg, plan, device, shape, params, paging=paging, own_params=True,
                          admission=args.admission,
                          prefill_chunk=None if args.admission == "replay" else args.prefill_chunk)
    engine.warmup()
    report = engine.run(build_requests(args.requests, cfg.vocab_size, args.max_new,
                                       *args.prompt_len, seed=args.seed))
    h2d = engine.tel.registry.snapshot()["serve.h2d_bytes"]["value"]
    print(json.dumps({
        "arch": cfg.name, "device": str(device),
        "plan": args.plan, "paging": None if paging is None else
        [paging.page_size, paging.n_pages, paging.n_hot],
        **report.to_dict(),
        "hbm_cache_bytes": report.hbm_cache_bytes,
        "host_cache_bytes": report.host_cache_bytes,
        "resident_cache_bytes": report.resident_cache_bytes,
        "h2d_bytes": h2d,
        "finished": {str(k): v for k, v in sorted(report.finished.items())},
    }))
    return 0 if report.drained else 1


if __name__ == "__main__":
    raise SystemExit(main())
