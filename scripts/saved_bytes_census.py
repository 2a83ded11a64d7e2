#!/usr/bin/env python3
"""What autograd keeps for one superblock's backward, against what the
planner's profile models (``core/profiler.profile_superblock``'s
``act_residual_bytes``).

Runs one forward of a full-width superblock on the CPU under
``torch.autograd.graph.saved_tensors_hooks`` and sums the bytes of the
distinct storages saved, leaving out the weights and the block's input.
An encoder-decoder's block runs with its cross-attention over a memory of
``--seq`` rows (an input too, left out like the block's); the profile, as
the reference's, traces the block without it. Prints one JSON line: the
modeled and the kept bytes, their ratio, and the largest kept storages.
Keep the sequence short: the CPU holds every saved tensor.

    PYTHONPATH=src python3 scripts/saved_bytes_census.py --arch mamba2-130m --seq 1024
    PYTHONPATH=src python3 scripts/saved_bytes_census.py --arch seamless-m4t-large-v2 --seq 1024
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402


def census(cfg, batch: int, seq: int, seed: int = 0) -> dict:
    """Modeled residual bytes of one superblock of ``cfg`` at (batch, seq)
    beside the bytes autograd keeps, with the largest kept storages."""
    from repro_torch.core.profiler import profile_superblock
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    modeled = profile_superblock(cfg, batch, seq).act_residual_bytes
    gen = torch.Generator().manual_seed(seed)
    params = L.map_defs(lambda d: d.initialize(gen, "cpu")[0].requires_grad_(),
                        M.param_defs(cfg)["blocks"])
    x = torch.randn(batch, seq, cfg.d_model, generator=gen).to(L.torch_dtype(cfg.dtype))
    x.requires_grad_()
    memory = None
    if cfg.kind == "encdec":
        memory = torch.randn(batch, seq, cfg.d_model, generator=gen).to(x.dtype)
        memory.requires_grad_()
    kept: dict[int, tuple[int, list[int], str]] = {}

    def pack(t: torch.Tensor) -> torch.Tensor:
        st = t.untyped_storage()
        kept.setdefault(st.data_ptr(), (st.nbytes(), list(t.shape), str(t.dtype)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        M.apply_superblock(params, x, cfg, memory=memory)
    inputs = [x] + ([] if memory is None else [memory])
    own = {t.untyped_storage().data_ptr() for t in inputs + list(_leaves(params))}
    acts = sorted((v for k, v in kept.items() if k not in own), key=lambda v: -v[0])
    saved = sum(v[0] for v in acts)
    return {"arch": cfg.name, "batch": batch, "seq": seq, "modeled_bytes": modeled,
            "kept_bytes": saved, "kept_over_modeled": saved / modeled,
            "largest": [{"bytes": b, "shape": s, "dtype": d} for b, s, d in acts[:8]]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None) -> int:
    from repro_torch.configs import get_config

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=1024)
    args = ap.parse_args(argv)
    print(json.dumps(census(get_config(args.arch), args.batch, args.seq)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
