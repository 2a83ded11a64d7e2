#!/usr/bin/env python3
"""How far 3 bf16 training steps of seamless-m4t-large-v2 spread under
orders of summation that compute the same function, on one card.

``chip_smoke.py``'s ``tp`` phase holds two ranks of the model axis to one
device. In bf16 the two differ by rounding, and Adam's first updates,
nearly the gradient's sign, can turn that rounding into trajectories that
part. This script measures how far, at the ``tp`` phase's seamless run
(``chip_smoke.tp_setup``: 8 + 8 layers at full width, B 1, S 4096, the
resident plan, the weights of seed 0), with Adam at ``--lr``:

* one device with the cross-entropy chunked by 2048 (the step's
  default), 1024, 512 and 4096 rows: the same function summed in other
  orders;
* two processes on the one card (a gloo group, data 1 x model 2), at
  chunks of 2048 and 1024.

Each run takes 2 steps, then the gradients of a third batch (``grad_fn``,
made whole from the shards). Printed: each run's grad norms of the 2
steps and of the third batch, relative to the one-device run at 2048;
each run's third-batch gradient against that run's, a leaf at a time
(median and largest relative L2 difference); and the first step's
gradient against the one-device run's, a leaf at a time.

    python3 scripts/tp_spread_chip.py [--lr 3e-4]

Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import chip_smoke as C  # noqa: E402

CHUNKS_ONE, CHUNKS_TP = (2048, 1024, 512, 4096), (2048, 1024)


def run(out: str, tag: str, lr: float, ce_chunk: int, mesh=None) -> dict:
    """One run: the first batch's gradient, 2 steps, the third batch's
    gradient (whole leaves written to ``out``, rank 0 or one device)."""
    import torch

    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.optim.adam import AdamConfig, tree_leaves
    from repro_torch.train.step_builder import build_train_step

    cfg, shape, plan = C.tp_setup("seamless", False)
    art = build_train_step(cfg, plan, "cuda", shape, mesh=mesh, adam=AdamConfig(lr=lr),
                           ce_chunk=ce_chunk)
    state = art.init(torch.Generator(device="cuda").manual_seed(0))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0, device="cuda")
    batches = [pipe.next_sync() for _ in range(3)]

    def whole_grads(batch, name):
        grads, _ = art.grad_fn(state, batch)
        g = [t.detach() for t in tree_leaves(grads)]
        if mesh is not None:
            g = [SH.unshard2(t, ls.dim, ls.mdim, mesh) for t, ls in zip(g, art.leaf_syncs)]
        if mesh is None or mesh.rank == 0:
            torch.save([t.float().cpu() for t in g], f"{out}/{tag}_{name}.pt")
        return [float(t.float().norm()) for t in g]

    whole_grads(batches[0], "g1")
    norms = []
    for batch in batches[:2]:
        state, m = art.fn(state, batch)
        norms.append(float(m["grad_norm"]))
    leaf3 = whole_grads(batches[2], "g3")
    del state, art
    torch.cuda.empty_cache()
    return {"norms": norms, "norm3": sum(x * x for x in leaf3) ** 0.5}


def _rank(rank: int, world: int, store: str, out: str, lr: float) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        mesh = make_local_mesh("cuda:0", model=world)
        res = {f"tp_ce{c}": run(out, f"tp_ce{c}", lr, c, mesh) for c in CHUNKS_TP}
        if rank == 0:
            with open(f"{out}/tp.json", "w") as f:
                json.dump(res, f)
    finally:
        dist.destroy_process_group()


def rel(a, b) -> list[float]:
    """Each leaf's relative L2 distance of ``b`` from ``a``."""
    return [float((y - x).norm()) / max(float(x.norm()), 1e-30) for x, y in zip(a, b)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=C.TP_LR)
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("tp_spread_chip.py: needs a CUDA card", file=sys.stderr)
        return 2
    print(C.phase_card(), flush=True)
    C.phase_build()
    out = tempfile.mkdtemp()
    res = {f"one_ce{c}": run(out, f"one_ce{c}", args.lr, c) for c in CHUNKS_ONE}
    mp.start_processes(_rank, args=(C.TP_MODEL, f"{out}/store", out, args.lr),
                       nprocs=C.TP_MODEL, join=True, start_method="spawn")
    with open(f"{out}/tp.json") as f:
        res.update(json.load(f))
    base = "one_ce2048"
    g1, g3 = (torch.load(f"{out}/{base}_{n}.pt") for n in ("g1", "g3"))
    for tag, r in res.items():
        line = {"run": tag, "lr": args.lr, "grad_norms_steps_1_2": r["norms"],
                "grad_norm_batch_3": r["norm3"],
                "batch_3_rel": abs(r["norm3"] - res[base]["norm3"]) / res[base]["norm3"]}
        if tag != base:
            d1 = sorted(rel(g1, torch.load(f"{out}/{tag}_g1.pt")))
            d3 = sorted(rel(g3, torch.load(f"{out}/{tag}_g3.pt")))
            line.update(step1_leaf_rel_median=d1[len(d1) // 2], step1_leaf_rel_max=d1[-1],
                        batch3_leaf_rel_median=d3[len(d3) // 2], batch3_leaf_rel_max=d3[-1])
        print(json.dumps(line), flush=True)
    for name in os.listdir(out):
        if name.endswith(".pt"):
            os.remove(os.path.join(out, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
