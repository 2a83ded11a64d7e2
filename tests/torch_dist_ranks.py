"""What each of the 4 gloo ranks of the distributed tests runs.

``tests/test_torch_dist.py`` and ``tests/test_torch_dist_train.py`` spawn
4 CPU ranks once a module (``spawn_ranks``); every rank joins a gloo
process group through a ``file://`` store in the test's temporary
directory (no fixed port: the suite runs in parallel workers), runs the
module's scenarios and saves its results with ``torch.save`` for the test
process to hold against the JAX package. Imports torch and the port only.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT = datetime.timedelta(seconds=120)


def spawn_ranks(scenarios: str, directory: str, *extra) -> list[dict]:
    """Run ``scenarios`` (a function of this module) on ``WORLD`` ranks;
    returns each rank's results."""
    return start_ranks(scenarios, directory, *extra)()


def start_ranks(scenarios: str, directory: str, *extra):
    """Start ``scenarios`` on ``WORLD`` ranks and return at once: the
    returned function waits for them and returns each rank's results."""
    store = os.path.join(directory, "store")
    ctx = mp.start_processes(_rank_main, args=(scenarios, store, directory, *extra),
                             nprocs=WORLD, join=False, start_method="spawn")

    def results() -> list[dict]:
        while not ctx.join():
            pass
        return [torch.load(os.path.join(directory, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return results


def _rank_main(rank: int, scenarios: str, store: str, directory: str, *extra) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=TIMEOUT)
    try:
        out = globals()[scenarios](rank, directory, *extra)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Primitives (tests/test_torch_dist.py)
# ---------------------------------------------------------------------------
# (name, shape, sharded dim): even and uneven (padded) dims
RS_CASES = (("even", (8, 12), 1), ("even_dim0", (8, 3), 0), ("uneven_dim1", (6, 7), 1),
            ("uneven_dim0", (10, 3), 0))
SEED = 100


def prim_inputs(rank: int, shape, seed: int = SEED):
    """(x, err) of a rank: seeded numpy, fp32, varied scale."""
    rng = np.random.default_rng(seed + rank)
    x = (rng.standard_normal(shape) * np.exp(rng.standard_normal())).astype(np.float32)
    err = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    return x, err


def shard_err(rank: int, shape, dim: int):
    """A rank's shard-sized residual for a reduce-scatter along ``dim``
    (the padded shard)."""
    z = WORLD
    shard = list(shape)
    shard[dim] = -(-shape[dim] // z)
    rng = np.random.default_rng(SEED + 50 + rank)
    return (rng.standard_normal(shard) * 1e-2).astype(np.float32)


def primitives(rank: int, directory: str) -> dict:
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as SH

    out = {}
    x, err = prim_inputs(rank, (9, 13))
    tx, terr = torch.from_numpy(x), torch.from_numpy(err)
    q, s = C._quantize_int8(tx)
    out["quantize"] = (q.numpy(), s.numpy())
    mean, new_err = C.manual_int8_ef_sync(tx, terr.clone())
    out["int8_sync"] = (mean.numpy(), new_err.numpy())
    pend, new_err2 = C.manual_int8_ef_sync(tx, terr.clone(), async_op=True)
    out["int8_sync_async"] = (pend.wait().numpy(), new_err2.numpy())
    avg, new = C.compressed_all_reduce(tx, terr.clone(), group=dist.group.WORLD)
    out["compressed_all_reduce"] = (avg.numpy(), new.numpy())
    out["bf16_all_reduce"] = C.bf16_all_reduce(tx, group=dist.group.WORLD).numpy()
    out["mean"] = C.manual_mean(tx).numpy()
    out["bf16_mean"] = C.manual_bf16_mean(tx).numpy()
    for name, shape, dim in RS_CASES:
        x, _ = prim_inputs(rank, shape, SEED + 7)
        e = shard_err(rank, shape, dim)
        tx = torch.from_numpy(x.copy())
        g, ne = C.manual_int8_ef_reduce_scatter(tx, torch.from_numpy(e), None, dim)
        unchanged = bool(np.array_equal(tx.numpy(), x))  # the caller's gradient
        ch = C._chunk(tx, dim, WORLD)
        ch[rank] += torch.from_numpy(e)
        q, sc, _ = C.K.fused_quantize_ef(ch, rank)
        out[f"rs_{name}"] = {"mean": g.numpy(), "err": ne.numpy(), "q": q.numpy(),
                             "scale": sc.numpy(), "input_unchanged": unchanged}
        out[f"rs_none_{name}"] = C.manual_reduce_scatter(tx, None, dim).numpy()
        out[f"rs_bf16_{name}"] = C.manual_bf16_reduce_scatter(tx, None, dim).numpy()
    # the lazy gather: forward is the full leaf, backward the reduce-scatter
    # with the residual written in place, as the direct call computes them
    full = torch.from_numpy(prim_inputs(0, (8, 12), SEED + 9)[0])
    w = SH.shard(full, 1, rank, WORLD).requires_grad_()
    e0 = torch.from_numpy(shard_err(rank, (8, 12), 1))
    ct = torch.from_numpy(prim_inputs(rank, (8, 12), SEED + 11)[0])
    lazy_err = e0.clone()
    g_full = C.gather_param_lazy(w, lazy_err, None, 1, "int8_ef")
    (g_w,) = torch.autograd.grad(g_full, w, ct)
    want_g, want_err = C.manual_int8_ef_reduce_scatter(ct, e0.clone(), None, 1)
    out["lazy"] = {"forward_equal": bool(torch.equal(g_full.detach(), full)),
                   "grad_equal": bool(torch.equal(g_w, want_g)),
                   "err_equal": bool(torch.equal(lazy_err, want_err)),
                   "unshard_equal": bool(torch.equal(SH.unshard(w.detach(), 1, WORLD), full))}
    return out


# ---------------------------------------------------------------------------
# Training steps (tests/test_torch_dist_train.py)
# ---------------------------------------------------------------------------
LR = 3e-3
STEPS = 5


def train_setup():
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig

    cfg = reduced(get_config("llama3-405b"), dtype="float32")
    return cfg, ShapeConfig("tiny", 32, 16, "train")


def relayout(blocks_params: dict, runs) -> dict:
    """A copy of a ``blocks`` tree as the state tree of a run layout."""
    def sl(tree, start=0, length=None):
        if isinstance(tree, torch.Tensor):
            return (tree if length is None else tree[start:start + length]).clone()
        return {k: sl(v, start, length) for k, v in tree.items()}

    out = {k: sl(v) for k, v in blocks_params.items() if k != "blocks"}
    out["runs"] = [sl(blocks_params["blocks"], r.start, r.length) for r in runs]
    return out


def unshard_tree(tree, leaf_syncs) -> list[np.ndarray]:
    """Every leaf of a rank's tree made whole (tree_leaves order)."""
    from repro_torch.dist import sharding as SH
    from repro_torch.optim.adam import tree_leaves

    return [SH.unshard(t.detach(), ls.dim, WORLD).numpy().copy()
            for t, ls in zip(tree_leaves(tree), leaf_syncs)]


def run_plan(plan, params, steps: int, telemetry=None) -> dict:
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adam import AdamConfig, tree_leaves
    from repro_torch.train.step_builder import build_train_step

    cfg, shape = train_setup()
    art = build_train_step(cfg, plan, "cpu", shape, mesh=make_local_mesh("cpu"),
                           adam=AdamConfig(lr=LR), telemetry=telemetry)
    state = art.place_state(relayout(params, art.runs))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0)
    losses, norms, ef_norms = [], [], []
    master3 = None
    for step in range(steps):
        state, m = art.fn(state, pipe.next_sync())
        if step == 2:  # tests/test_torch_train.py holds the masters after 3 steps
            master3 = unshard_tree(state["opt"]["master"], art.leaf_syncs)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "ef_norm" in m:
            ef_norms.append(float(m["ef_norm"]))
    ls = art.leaf_syncs
    res = {"kind": art.strategy.kind, "losses": losses, "norms": norms, "ef_norms": ef_norms,
           "dims": [x.dim for x in ls],
           "master": unshard_tree(state["opt"]["master"], ls), "master3": master3,
           "params": [t.detach().numpy().copy() for t in tree_leaves(state["params"])]}
    if "ef" in state:
        res["ef"] = [e.numpy().copy() for e in tree_leaves(state["ef"])]
    return res


def plan_of(kind: str, compress: str, **kw):
    from repro_torch.core.plan import MemoryPlan

    layout = {"ddp": dict(n_persist=4), "zero2": dict(n_persist=0, zero_stage=2),
              "zero3": dict(n_persist=0)}[kind]
    return MemoryPlan(4, 2, sync_mode="manual", grad_compress=compress, **{**layout, **kw})


def gather_counts(tel) -> dict[str, float]:
    snap = tel.registry.snapshot()
    return {k: v["value"] for k, v in snap.items() if k.startswith("sync.param_gathers")}


def train_steps(rank: int, directory: str, params_file: str) -> dict:
    from repro_torch import obs

    params = torch.load(params_file, weights_only=True)
    out = {}
    for kind in ("ddp", "zero2", "zero3"):
        for compress in ("int8_ef", "none"):
            out[f"{kind}_{compress}"] = run_plan(plan_of(kind, compress), params, STEPS)
    # ZeRO-3 buffering and overlap: 2 steps of 2 microbatches. Buffered:
    # both repeats in one buffered run (prefetch one repeat ahead under
    # overlap); unbuffered: every chunk; checkpointed and unbuffered.
    for name, kw in (("buffered", dict(n_buffer=3)), ("unbuffered", dict(n_buffer=0)),
                     ("unbuffered_ckpt", dict(n_buffer=0, n_checkpoint=2))):
        for overlap in (True, False):
            tel = obs.Telemetry(trace=False)
            r = run_plan(plan_of("zero3", "int8_ef", microbatch=2, overlap=overlap, **kw),
                         params, 2, telemetry=tel)
            r["gathers"] = gather_counts(tel)
            out[f"zero3_{name}_overlap_{overlap}"] = r
    out["checkpoint"] = checkpoint_resume(rank, directory)
    return out


def checkpoint_resume(rank: int, directory: str) -> dict:
    """4 steps straight against 2, a checkpoint, and 2 more from it, under
    ZeRO-3 with int8_ef (2 microbatches): every rank's state bitwise."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adam import AdamConfig, tree_leaves
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step_builder import build_train_step

    cfg, shape = train_setup()
    plan = plan_of("zero3", "int8_ef", microbatch=2, n_buffer=2)
    ck = os.path.join(directory, "ckpt")

    def loop(steps, mgr):
        art = build_train_step(cfg, plan, "cpu", shape, mesh=make_local_mesh("cpu"),
                               adam=AdamConfig(lr=LR))
        return train_loop(art, SyntheticTokenPipeline(cfg, shape, seed=0), mgr,
                          LoopConfig(total_steps=steps, checkpoint_every=2, log_every=0),
                          generator=torch.Generator().manual_seed(0), log=lambda s: None)

    straight = loop(4, None)
    first = loop(2, CheckpointManager(ck, keep=2, rank=rank, world=WORLD))
    dist.barrier()  # every rank's step-2 file is written before any rank looks
    mgr = CheckpointManager(ck, keep=2, rank=rank, world=WORLD)
    saved = mgr.steps()
    fresh = build_train_step(cfg, plan, "cpu", shape, mesh=make_local_mesh("cpu"),
                             adam=AdamConfig(lr=LR)).init(torch.Generator().manual_seed(5))
    restored, _ = mgr.restore(2, fresh)
    second = loop(4, CheckpointManager(ck, keep=2, rank=rank, world=WORLD))
    other_world = None
    try:
        CheckpointManager(ck, keep=2, rank=0, world=2).steps()
    except ValueError as e:
        other_world = str(e)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b)))  # noqa: E731
    return {"saved": saved, "resumed_from": second.resumed_from,
            "restored_equal": same(restored, first.state) and restored["step"] == 2,
            "losses": first.losses + second.losses, "straight_losses": straight.losses,
            "state_equal": same(second.state, straight.state),
            "ef_leaves": len(tree_leaves(second.state["ef"])),
            "other_world_error": other_world}


def tensors(state) -> list:
    """Every tensor of a training state: params, residuals, master, m, v."""
    from repro_torch.optim.adam import tree_leaves

    return tree_leaves([state["params"], state["ef"],
                        [state["opt"][k] for k in ("master", "m", "v")]])


# ---------------------------------------------------------------------------
# The xla path on several ranks (tests/test_torch_dist_xla.py)
# ---------------------------------------------------------------------------
XLA_STEPS = 3
XLA_PLANS = {  # name: (MemoryPlan keywords, wire formats)
    # (a) every chunk ZeRO-sharded in device memory, the last one buffered
    "zero": (dict(n_persist=0, n_buffer=1), ("none", "int8_ef")),
    # (b) host chunks (weights and states pinned), one swap and one
    # checkpointed block; block 1 lives on the host and is gathered again
    # inside its replay
    "host": (dict(n_persist=1, n_host=2, n_buffer=1, n_swap=1, n_checkpoint=1),
             ("none", "int8_ef")),
    # (c) the ZeRO-Offload split: host chunks' weights on the device, two
    # microbatches
    "offload": (dict(n_persist=1, n_host=3, host_params=False, microbatch=2), ("none",)),
    # (d) every chunk persistent, the optimizer states sharded
    "zero1": (dict(n_persist=4, zero1_persistent=True), ("none", "bf16")),
}
XLA_CASES = tuple((name, c) for name, (_, cs) in XLA_PLANS.items() for c in cs)
XLA_CKPT_CASE = ("host", "int8_ef")
XLA_ABSMAX_SHAPE, XLA_ABSMAX_DIM = (8, 12), 1


def xla_plan(name: str, compress: str):
    from repro_torch.core.plan import MemoryPlan

    return MemoryPlan(4, 2, grad_compress=compress, **XLA_PLANS[name][0])


def xla_absmax_inputs(seed: int = SEED + 20):
    """One leaf whose 4 shards along ``XLA_ABSMAX_DIM`` have absmaxes 1, 10,
    0.1 and 1000 times apart, and its residual: (x, err) fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(XLA_ABSMAX_SHAPE).astype(np.float32)
    scale = np.repeat(np.array([1.0, 10.0, 0.1, 1000.0], np.float32),
                      XLA_ABSMAX_SHAPE[XLA_ABSMAX_DIM] // WORLD)
    x = x * scale[None, :]
    err = (rng.standard_normal(XLA_ABSMAX_SHAPE) * 1e-2).astype(np.float32)
    return x, err


def xla_run(name: str, compress: str, params, steps: int = XLA_STEPS) -> dict:
    """``steps`` steps of the plan at this rank from ``params`` (the JAX
    init in the plan's run layout): losses, norms, the residual norms, the
    replicated leaves' residuals after every step, the fp32 masters made
    whole after the last, the local shapes."""
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adam import AdamConfig, tree_leaves, tree_map
    from repro_torch.train.step_builder import build_train_step

    cfg, shape = train_setup()
    art = build_train_step(cfg, xla_plan(name, compress), "cpu", shape,
                           mesh=make_local_mesh("cpu"), adam=AdamConfig(lr=LR))
    state = art.place_state(tree_map(lambda t: t.clone(), params))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0)
    ls = art.leaf_syncs
    losses, norms, ef_norms, rep_ef = [], [], [], []
    for _ in range(steps):
        state, m = art.fn(state, pipe.next_sync())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "ef" in state:
            ef_norms.append(float(m["ef_norm"]))
            rep_ef.append([e.numpy().copy() for e, x in zip(tree_leaves(state["ef"]), ls)
                           if x.dim is None])
    opt = [whole(t, d) for t, d in zip(tree_leaves(state["opt"]["master"]), art.opt_dims)]
    return {"kind": art.strategy.kind, "sharded": art.strategy.sharded, "losses": losses,
            "norms": norms, "ef_norms": ef_norms, "rep_ef": rep_ef, "dims": [x.dim for x in ls],
            "opt_dims": list(art.opt_dims), "master": opt,
            "params": [whole(t, x.dim) for t, x in zip(tree_leaves(state["params"]), ls)],
            "param_shapes": [tuple(t.shape) for t in tree_leaves(state["params"])],
            "master_shapes": [tuple(t.shape) for t in tree_leaves(state["opt"]["master"])],
            "ef_shapes": [tuple(t.shape) for t in tree_leaves(state.get("ef", []))]}


def whole(t, dim) -> np.ndarray:
    """A rank's shard of a leaf made whole (the leaf itself if replicated)."""
    from repro_torch.dist import sharding as SH

    return SH.unshard(t.detach(), dim, WORLD).numpy().copy()


def xla_steps(rank: int, directory: str, params_file: str) -> dict:
    """Every plan and wire format of ``XLA_CASES``; the absmax unit case;
    a checkpoint resumed; ``launch.train``'s ``auto`` plan at 4 ranks."""
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as SH

    params = torch.load(params_file, weights_only=True)
    out = {f"{n}_{c}": xla_run(n, c, params[n]) for n, c in XLA_CASES}
    x, err = xla_absmax_inputs()
    xs = SH.shard(torch.from_numpy(x), XLA_ABSMAX_DIM, rank, WORLD)
    es = SH.shard(torch.from_numpy(err), XLA_ABSMAX_DIM, rank, WORLD)
    q, scale = C._quantize_int8(xs + es, dist.group.WORLD)
    local, new_err = C.xla_int8_ef(xs, es, dist.group.WORLD)
    out["absmax"] = {"q": q.numpy(), "scale": scale.numpy(), "local": local.numpy(),
                     "err": new_err.numpy()}
    out["checkpoint"] = xla_checkpoint_resume(rank, directory)
    out["auto"] = xla_launcher_auto()
    return out


def xla_checkpoint_resume(rank: int, directory: str) -> dict:
    """4 steps straight against 2, a checkpoint, and 2 more from it, under
    ``XLA_CKPT_CASE``: every rank's state bitwise."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.loop import LoopConfig, train_loop
    from repro_torch.train.step_builder import build_train_step

    cfg, shape = train_setup()
    plan = xla_plan(*XLA_CKPT_CASE)
    ck = os.path.join(directory, "xla_ckpt")

    def loop(steps, mgr):
        art = build_train_step(cfg, plan, "cpu", shape, mesh=make_local_mesh("cpu"),
                               adam=AdamConfig(lr=LR))
        return train_loop(art, SyntheticTokenPipeline(cfg, shape, seed=0), mgr,
                          LoopConfig(total_steps=steps, checkpoint_every=2, log_every=0),
                          generator=torch.Generator().manual_seed(0), log=lambda s: None)

    straight = loop(4, None)
    loop(2, CheckpointManager(ck, keep=2, rank=rank, world=WORLD))
    dist.barrier()  # every rank's step-2 file is written before any rank looks
    second = loop(4, CheckpointManager(ck, keep=2, rank=rank, world=WORLD))
    same = all(torch.equal(x, y) for x, y in zip(tensors(second.state), tensors(straight.state)))
    return {"resumed_from": second.resumed_from, "state_equal": same,
            "losses": second.losses, "straight_losses": straight.losses[2:]}


XLA_AUTO_ARGV = ["--arch", "llama3-405b", "--reduced", "--nproc", "4", "--steps", "2",
                 "--batch", "16", "--seq", "32", "--device", "cpu", "--plan", "auto"]


def xla_launcher_auto() -> dict | None:
    """``launch.train``'s ``--plan auto`` at this rank of the process group
    (its ``_train``, which ``--nproc 4`` runs in each spawned rank):
    rank 0's summary."""
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_local_mesh

    args = launch_train.parse_args(XLA_AUTO_ARGV)
    return launch_train._train(args, torch.device("cpu"), make_local_mesh("cpu"))


# ---------------------------------------------------------------------------
# The model axis (tests/test_torch_tp.py)
# ---------------------------------------------------------------------------
TP_STEPS = 3
TP_MODELS = {  # name: (arch, overrides of its reduced config)
    "dense": ("llama3-405b", {}),
    "kv2": ("llama3-405b", dict(num_kv_heads=2)),
    "moe": ("qwen2-moe-a2.7b", {}),
    # the config's capacity drops choices (reduced() sets 8.0: none)
    "moedrop": ("qwen2-moe-a2.7b", dict(capacity_factor=1.0)),
    "mamba": ("mamba2-130m", {}),
    # one 8-layer period: Mamba-2, attention at 3 (4 query heads over one
    # KV head: the whole_weight route), MoE every second layer
    "hybrid": ("jamba-1.5-large-398b", dict(num_kv_heads=1)),
    "seamless": ("seamless-m4t-large-v2", {}),
    # a vocab the model extent of 4 does not divide: embedding and head whole
    "seamlessv510": ("seamless-m4t-large-v2", dict(vocab_size=510)),
    "llava": ("llava-next-34b", {}),
    # serving (tests/test_torch_serve_mesh.py): GQA kept, 2 KV heads
    "mistral": ("mistral-7b", dict(num_kv_heads=2)),
    # heads a model extent of 4 does not divide: 6 query heads over 2 (the
    # sublayer runs replicated at 1 x 4) and 6 SSD heads (d_in 192 / 32)
    "llava6": ("llava-next-34b", dict(num_heads=6, num_kv_heads=2)),
    "mamba6": ("mamba2-130m", dict(d_model=96)),
    # 6 query and KV heads: the encoder's attention, the decoder's self-
    # and cross-attention run replicated at 1 x 4, the memory entered whole
    "seamless6": ("seamless-m4t-large-v2", dict(num_heads=6, num_kv_heads=6)),
}
# Adam's eps where the default (1e-8) divides the two frameworks' fp32
# noise into whole steps: the hybrid's one-device port misses the JAX
# step's masters at TOL with it, as tests/test_torch_mamba.py's ADAM_EPS
# records; both sides take it
TP_ADAM_EPS = {"hybrid": 1e-6}
TP_PLANS = {  # name: MemoryPlan keywords
    # a persistent embedding chunk, ZeRO hbm chunks, the first block
    # checkpointed, the head's chunk buffered
    "zero": dict(n_persist=1, n_buffer=1, n_checkpoint=1),
    # the same in 2 microbatches: a rank's rows of each global one
    "zeromb2": dict(n_persist=1, n_buffer=1, n_checkpoint=1, microbatch=2),
    # host chunks with a swap and a checkpointed block, int8 + EF
    "host": dict(n_persist=1, n_host=2, n_buffer=1, n_swap=1, n_checkpoint=1,
                 grad_compress="int8_ef"),
    # compressed saves: int8 rows in block 0, bf16 in block 1
    "compress": dict(n_persist=1, n_buffer=1, act_policies=("compress8", "compress16")),
}
# name: (model, plan, (data, model) layout, extra plan keywords); each case
# is held against the JAX step of its (model, plan)
TP_CASES = {
    "dense_2x2": ("dense", "zero", (2, 2), {}),
    "dense_2x2_sp": ("dense", "zero", (2, 2), dict(seq_shard_acts=True)),
    "dense_1x4": ("dense", "zero", (1, 4), {}),
    "dense_1x4_sp": ("dense", "zero", (1, 4), dict(seq_shard_acts=True)),
    "dense_2x2_dp_only": ("dense", "zero", (2, 2), dict(dp_only=True)),
    "dense_4x1": ("dense", "zero", (4, 1), {}),
    "kv2_1x4": ("kv2", "zero", (1, 4), {}),
    "moe_1x4": ("moe", "zero", (1, 4), {}),
    "moe_1x4_sp": ("moe", "zero", (1, 4), dict(seq_shard_acts=True)),
    "host_2x2_int8_ef": ("dense", "host", (2, 2), {}),
    "compress_2x2_sp": ("dense", "compress", (2, 2), dict(seq_shard_acts=True)),
    # the MoE routed over the batch group's tokens, dropping choices
    "moedrop_4x1": ("moedrop", "zeromb2", (4, 1), {}),
    "moedrop_2x2": ("moedrop", "zeromb2", (2, 2), {}),
    "moedrop_2x2_dp_only": ("moedrop", "zeromb2", (2, 2), dict(dp_only=True)),
    "mamba_2x2": ("mamba", "zero", (2, 2), {}),
    "mamba_1x4": ("mamba", "zero", (1, 4), {}),
    "mamba_1x4_sp": ("mamba", "zero", (1, 4), dict(seq_shard_acts=True)),
    "hybrid_2x2": ("hybrid", "zero", (2, 2), {}),
    "hybrid_1x4_sp": ("hybrid", "zero", (1, 4), dict(seq_shard_acts=True)),
    "seamless_2x2": ("seamless", "zero", (2, 2), {}),
    "seamless_1x4_sp": ("seamless", "zero", (1, 4), dict(seq_shard_acts=True)),
    "seamlessv510_1x4": ("seamlessv510", "zero", (1, 4), {}),
    "llava_2x2": ("llava", "zero", (2, 2), {}),
    "llava_1x4_sp": ("llava", "zero", (1, 4), dict(seq_shard_acts=True)),
}
# the pod axis (tests/test_torch_pod.py): (pod, data, model) layouts of
# the 4 ranks, held against the JAX step of their model and plan
POD_LAYOUTS = ((2, 2, 1), (2, 1, 2))
POD_CASES = {f"{m}_{p}x{d}x{k}": (m, "zero", (p, d, k), {})
             for m in ("dense", "moe") for p, d, k in POD_LAYOUTS}
# the step whose collectives rank 0 records, beside the dry-run's fake one
POD_RECORD_CASE = "dense_2x1x2"
# the same machinery for the repairs of tests/test_torch_serve_mesh.py
REPAIR_CASES = {
    "llava6_1x4": ("llava6", "zero", (1, 4), {}),
    "mamba6_1x4": ("mamba6", "zero", (1, 4), {}),
    "seamless6_1x4": ("seamless6", "zero", (1, 4), {}),
    "seamless6_1x4_sp": ("seamless6", "zero", (1, 4), dict(seq_shard_acts=True)),
}
TP_AUTO_ARGV = ["--arch", "llama3-405b", "--reduced", "--nproc", "4", "--model", "2",
                "--steps", "2", "--batch", "16", "--seq", "32", "--device", "cpu",
                "--plan", "auto"]
TP_AUTO_MAMBA_ARGV = ["--arch", "mamba2-130m"] + TP_AUTO_ARGV[2:]


def tp_overrides(cfg, model: str):
    """``cfg`` (the JAX package's or the port's reduced fp32 config) with
    ``TP_MODELS[model]``'s overrides."""
    import dataclasses

    kw = dict(TP_MODELS[model][1])
    if "capacity_factor" in kw:
        kw["moe"] = dataclasses.replace(cfg.moe, capacity_factor=kw.pop("capacity_factor"))
    return dataclasses.replace(cfg, **kw)


def tp_adam_kw(model: str) -> dict:
    """The Adam keywords of ``model``'s runs beside the learning rate."""
    return {"eps": TP_ADAM_EPS[model]} if model in TP_ADAM_EPS else {}


def tp_config(model: str):
    """The reduced fp32 config of ``TP_MODELS[model]`` and the shape."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig

    cfg = reduced(get_config(TP_MODELS[model][0]), dtype="float32")
    return tp_overrides(cfg, model), ShapeConfig("tiny", 32, 16, "train")


def tp_plan(case: str):
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models.model import num_repeats

    model, plan, _, extra = {**TP_CASES, **REPAIR_CASES, **POD_CASES}[case]
    n = num_repeats(tp_config(model)[0])
    return MemoryPlan(n + 2, n, **TP_PLANS[plan], **extra)


def tp_run(case: str, params, mesh) -> dict:
    """``TP_STEPS`` steps of a case on this rank's mesh from the full
    ``params`` (the JAX init): losses, norms, the layout, the fp32 masters
    made whole after the last step."""
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.dist import sharding as SH
    from repro_torch.optim.adam import AdamConfig, tree_leaves, tree_map
    from repro_torch.train.step_builder import build_train_step

    model = {**TP_CASES, **REPAIR_CASES, **POD_CASES}[case][0]
    cfg, shape = tp_config(model)
    art = build_train_step(cfg, tp_plan(case), "cpu", shape, mesh=mesh,
                           adam=AdamConfig(lr=LR, **tp_adam_kw(model)))
    state = art.place_state(tree_map(lambda t: t.clone(), params))
    pipe = SyntheticTokenPipeline(cfg, shape, seed=0)
    losses, norms, ef_norms = [], [], []
    for _ in range(TP_STEPS):
        state, m = art.fn(state, pipe.next_sync())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "ef_norm" in m:
            ef_norms.append(float(m["ef_norm"]))
    ls = art.leaf_syncs
    masters = [SH.unshard2(t.detach(), d, x.mdim, mesh).numpy().copy() for t, d, x in
               zip(tree_leaves(state["opt"]["master"]), art.opt_dims, ls)]
    return {"kind": art.strategy.kind, "losses": losses, "norms": norms, "ef_norms": ef_norms,
            "dims": [(x.dim, x.mdim) for x in ls], "master": masters,
            "param_shapes": [tuple(t.shape) for t in tree_leaves(state["params"])]}


def tp_steps(rank: int, directory: str, params_file: str) -> dict:
    """Every case of ``TP_CASES`` on its layout of the 4 ranks; the
    checkpoint race; ``launch.train``'s ``auto`` plan at 2 x 2."""
    from repro_torch.launch.mesh import make_local_mesh

    params = torch.load(params_file, weights_only=True)
    meshes = {m: make_local_mesh("cpu", model=m) for m in (1, 2, 4)}
    out = {}
    for case, (model, plan, (_, m), _) in TP_CASES.items():
        out[case] = tp_run(case, params[f"{model}_{plan}"], meshes[m])
    out["race"] = checkpoint_race(rank, directory)
    from repro_torch.launch import train as launch_train

    for key, argv in (("auto", TP_AUTO_ARGV), ("auto_mamba", TP_AUTO_MAMBA_ARGV)):
        out[key] = launch_train._train(launch_train.parse_args(argv), torch.device("cpu"),
                                       meshes[2])
    return out


def checkpoint_race(rank: int, directory: str) -> dict:
    """Every rank saves step 2, then step 4, but the last rank writes its
    step-4 file only once every other rank has listed the steps (it waits
    for their marks), and lists after: its own listing holds step 4
    complete, the others' do not. Returns the step this rank listed and
    the one ``restore_latest`` resumed from."""
    import time

    from repro_torch.ckpt.checkpoint import CheckpointManager

    ck = os.path.join(directory, "race")
    os.makedirs(ck, exist_ok=True)
    seen = {}

    class Marked(CheckpointManager):
        def latest_step(self):
            seen["step"] = super().latest_step()
            open(os.path.join(ck, f"listed{self.rank}"), "w").close()
            return seen["step"]

    mgr = Marked(ck, keep=3, rank=rank, world=WORLD)
    mgr.save(2, {"w": torch.full((3,), 2.0 + rank)}, sync=True)
    dist.barrier()  # every rank's step 2 is written
    if rank == WORLD - 1:  # held back until the others have listed
        while not all(os.path.exists(os.path.join(ck, f"listed{r}"))
                      for r in range(WORLD - 1)):
            time.sleep(0.01)
    mgr.save(4, {"w": torch.full((3,), 4.0 + rank)}, sync=True)
    got = mgr.restore_latest({"w": torch.zeros(3)})
    return {"listed": seen["step"], "resumed": got[0], "w": got[1]["w"].tolist()}


# ---------------------------------------------------------------------------
# Serving on a mesh (tests/test_torch_serve_mesh.py)
# ---------------------------------------------------------------------------
SERVE_B, SERVE_S, SERVE_STEPS = 4, 16, 8
SERVE_PAGING = (4, 2)  # page size, hot pages: 4 pages of 4 rows, 2 hot
# name: (model, (data, model) layout, kind): a resident cache, a paged one
# (PagedKV(use_kernel=False)), or every chunk ZeRO-sharded (n_persist=0)
DECODE_CASES = {
    **{f"mistral_{d}x{m}{k}": ("mistral", (d, m), k.strip("_") or "resident")
       for d, m in ((1, 4), (2, 2), (4, 1)) for k in ("", "_paged")},
    "mistral_4x1_sharded": ("mistral", (4, 1), "sharded"),
    "mistral_2x2_sharded": ("mistral", (2, 2), "sharded"),
    **{f"{f}_{d}x{m}": (f, (d, m), "resident")
       for f in ("moe", "mamba", "hybrid", "seamless", "llava") for d, m in ((1, 4), (2, 2))},
    "seamless_2x2_sharded": ("seamless", (2, 2), "sharded"),
    "llava6_1x4": ("llava6", (1, 4), "resident"),
    "mamba6_1x4": ("mamba6", (1, 4), "resident"),
    "seamless6_1x4": ("seamless6", (1, 4), "resident"),
}
SERVE_MODELS = sorted({m for m, _, _ in DECODE_CASES.values()})
POD_DECODE_CASES = {"mistral_2x1x2": ("mistral", (2, 1, 2), "resident")}
ENGINE_S, ENGINE_CHUNK = 32, 8
# name: (model, (data, model), slots, admission)
ENGINE_CASES = {
    "mistral_2x2_chunked": ("mistral", (2, 2), 4, "chunked"),
    "mistral_2x2_b3": ("mistral", (2, 2), 3, "chunked"),  # 3 slots over 2 data ranks
    "mamba_1x4_replay": ("mamba", (1, 4), 4, "replay"),
}
PREFILL_B, PREFILL_S = 4, 20
# name: (model, (data, model), n_persist = 0)
PREFILL_CASES = {
    "llava_2x2": ("llava", (2, 2), False),
    "llava_2x2_sharded": ("llava", (2, 2), True),
    "seamless_2x2": ("seamless", (2, 2), False),
}
ARGMAX_VOCAB = 16


def serve_inputs(vocab: int):
    """The decode cases' teacher-forced tokens (B, steps) and per-step
    active masks (steps, B)."""
    rng = np.random.default_rng(21)
    toks = rng.integers(0, vocab, (SERVE_B, SERVE_STEPS))
    active = np.array([[True, t % 3 != 1, True, t % 2 == 0] for t in range(SERVE_STEPS)])
    return toks, active


def serve_frames(cfg):
    """An encoder-decoder's frames, (B, S, D) fp32, from seeded numpy."""
    rng = np.random.default_rng(22)
    return rng.standard_normal((SERVE_B, SERVE_S, cfg.d_model)).astype(np.float32)


def prompts(n: int) -> list[tuple]:
    """The engine cases' requests: (rid, prompt, max_new)."""
    rng = np.random.default_rng(5)
    return [(i, rng.integers(1, 512, int(k)).tolist(), 4 + i)
            for i, k in enumerate(rng.integers(3, 13, n))]


def prefill_batch(cfg) -> dict:
    """The stateless prefill's batch: tokens, and a VLM's patches or an
    encoder-decoder's frames."""
    rng = np.random.default_rng(23)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S))}
    if cfg.frontend == "vision_patches":
        out["patches"] = rng.standard_normal(
            (PREFILL_B, min(1024, PREFILL_S), cfg.d_model)).astype(np.float32)
    if cfg.kind == "encdec":
        out["frames"] = rng.standard_normal(
            (PREFILL_B, PREFILL_S, cfg.d_model)).astype(np.float32)
    return out


def _serve_plan(cfg, sharded: bool = False, n_host: int = 0):
    from repro_torch.core.plan import MemoryPlan
    from repro_torch.models.model import num_repeats

    n = num_repeats(cfg)
    return MemoryPlan(n + 2, n, n_persist=0 if sharded else n + 2, n_host=n_host)


def _clone(tree):
    from repro_torch.optim.adam import tree_map

    return tree_map(lambda t: t.clone(), tree)


def serve_decode(case: str, params, mesh) -> dict:
    """``SERVE_STEPS`` teacher-forced decode steps of a case on this rank's
    mesh from the whole ``params``: each step's logits made whole (vocab,
    then slots), the layout."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.tensor_parallel import gather_vocab
    from repro_torch.models import kvcache as KV
    from repro_torch.models import model as TM
    from repro_torch.serve import PagedKV, choose_paging, init_paged_cache
    from repro_torch.train.step_builder import serve_layout

    model, _, kind = {**DECODE_CASES, **POD_DECODE_CASES}[case]
    cfg = tp_config(model)[0]
    spec = choose_paging(SERVE_S, *SERVE_PAGING) if kind == "paged" else None
    plan = _serve_plan(cfg, kind == "sharded", spec.n_cold if spec else 0)
    lay = serve_layout(cfg, plan, ShapeConfig("serve", SERVE_S, SERVE_B, "decode"), spec, mesh)
    kv_io = PagedKV(spec, use_kernel=False) if spec else None
    shards = lay.shard(_clone(params))
    gather = lay.gather(shards)
    rows, n = lay.rows, lay.slots[1]
    cache = (init_paged_cache(cfg, n, SERVE_S, spec, "cpu", lay.tp) if spec
             else KV.init_cache(cfg, n, SERVE_S, "cpu", lay.tp))
    if cfg.kind == "encdec":  # the cross cache primed from the encoder's output
        memory = TM.encode(params, torch.from_numpy(serve_frames(cfg)), cfg)
        KV.prime_cross_cache(shards, memory[rows], cache, cfg, lay.tp, gather)
    toks, active = serve_inputs(cfg.vocab_size)
    outs = []
    with torch.inference_mode():
        for t in range(SERVE_STEPS):
            logits, _ = KV.decode_step(
                shards, cache, torch.from_numpy(toks[rows, t:t + 1]),
                torch.full((n,), t), cfg, kv_io=kv_io,
                active=torch.from_numpy(active[t, rows]), tp=lay.tp, route=lay.route,
                gather=gather)
            outs.append(lay.gather_rows(gather_vocab(logits, lay.tp, cfg.vocab_size)))
    leaf = next(iter(next(iter(cache.values())).values()))
    return {"logits": torch.stack(outs).numpy(), "slots": lay.slots,
            "cache_leaf": tuple(leaf.shape),
            "cache_shapes": {p: {k: tuple(v.shape) for k, v in e.items()}
                             for p, e in cache.items()},
            "gathered": gather is not None}


def serve_engine(case: str, params, mesh) -> dict:
    """``DecodeEngine`` on this rank's mesh over ``prompts``: its tokens and
    report."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.serve import DecodeEngine, Request

    model, _, slots, admission = ENGINE_CASES[case]
    cfg = tp_config(model)[0]
    eng = DecodeEngine(cfg, _serve_plan(cfg), None, ShapeConfig("serve", ENGINE_S, slots,
                                                                "decode"),
                       params, mesh=mesh, admission=admission,
                       prefill_chunk=ENGINE_CHUNK if admission != "replay" else None)
    rep = eng.run([Request(*r) for r in prompts(4)])
    return {"finished": rep.finished, "drained": rep.drained,
            "ticks": (rep.prefill_ticks, rep.decode_ticks), "graph": eng.serve_step.graph,
            "report": rep.to_dict(), "slots": eng.layout.slots}


def serve_prefill(case: str, params, mesh) -> dict:
    """The stateless prefill of a case on this rank's mesh: the whole (B,
    V) logits every rank returns."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.step_builder import build_prefill_step

    model, _, sharded = PREFILL_CASES[case]
    cfg = tp_config(model)[0]
    art = build_prefill_step(cfg, _serve_plan(cfg, sharded), None,
                             ShapeConfig("p", PREFILL_S, PREFILL_B, "prefill"), mesh=mesh)
    batch = {k: torch.from_numpy(v) for k, v in prefill_batch(cfg).items()}
    return {"logits": art.fn(art.place_state(_clone(params)), batch).numpy()}


def argmax_cases(rank: int, meshes) -> dict:
    """``vocab_argmax`` over model extents 2 and 4 of ``ARGMAX_VOCAB``-wide
    rows: seeded values, ties within a rank's slice, across slices, an
    all-equal row. Returns (got, torch.argmax of the whole rows) a layout."""
    from repro_torch.dist.tensor_parallel import TensorParallel, vocab_argmax

    rng = np.random.default_rng(24)
    rows = rng.standard_normal((6, ARGMAX_VOCAB)).astype(np.float32)
    rows[1, [3, 5]] = rows[1].max() + 1.0  # a tie inside one slice
    rows[2, [2, 13]] = rows[2].max() + 1.0  # across the first and last slices
    rows[3, [9, 6]] = rows[3].max() + 1.0  # across two middle slices
    rows[4] = 0.5  # every value equal
    whole = torch.from_numpy(rows)
    out = {}
    for m in (2, 4):
        mesh = meshes[m]
        tp = TensorParallel(mesh.model_group, mesh.model_rank, mesh.model)
        part = whole.chunk(m, -1)[mesh.model_rank]
        out[m] = (vocab_argmax(part, tp, ARGMAX_VOCAB).numpy(),
                  torch.argmax(whole, dim=-1).numpy())
    return out


def serve_mesh(rank: int, directory: str, params_file: str) -> dict:
    """Every decode, engine and prefill case on its layout of the 4 ranks,
    the argmax, and the repairs' training steps (``REPAIR_CASES``)."""
    from repro_torch.launch.mesh import make_local_mesh

    params = torch.load(params_file, weights_only=False)
    meshes = {m: make_local_mesh("cpu", model=m) for m in (1, 2, 4)}
    out = {"decode": {c: serve_decode(c, params["serve"][m], meshes[lay[1]])
                      for c, (m, lay, _) in DECODE_CASES.items()},
           "engine": {c: serve_engine(c, params["serve"][m], meshes[lay[1]])
                      for c, (m, lay, _, _) in ENGINE_CASES.items()},
           "prefill": {c: serve_prefill(c, params["serve"][m], meshes[lay[1]])
                       for c, (m, lay, _) in PREFILL_CASES.items()},
           "argmax": argmax_cases(rank, meshes)}
    out["train"] = {c: tp_run(c, params["train"][c], meshes[REPAIR_CASES[c][2][1]])
                    for c in REPAIR_CASES}
    return out


# ---------------------------------------------------------------------------
# The pod axis (tests/test_torch_pod.py)
# ---------------------------------------------------------------------------
def recorded_step(case: str, params, mesh) -> list[tuple]:
    """The collectives one step of a case issues on this rank's mesh, in
    order: (kind, payload bytes, dtype, group size)."""
    from repro_torch.data.pipeline import SyntheticTokenPipeline
    from repro_torch.launch.roofline import CollectiveRecorder
    from repro_torch.optim.adam import AdamConfig, tree_map
    from repro_torch.train.step_builder import build_train_step

    model = POD_CASES[case][0]
    cfg, shape = tp_config(model)
    art = build_train_step(cfg, tp_plan(case), "cpu", shape, mesh=mesh,
                           adam=AdamConfig(lr=LR, **tp_adam_kw(model)))
    state = art.place_state(tree_map(lambda t: t.clone(), params))
    batch = SyntheticTokenPipeline(cfg, shape, seed=0).next_sync()
    with CollectiveRecorder() as rec:
        art.fn(state, batch)
    return [(o.kind, o.nbytes, o.dtype, o.group_size) for o in rec.ops]


def pod_steps(rank: int, directory: str, params_file: str) -> dict:
    """Each layout's place of this rank and its zero group, every
    ``POD_CASES`` run and ``POD_DECODE_CASES`` decode on its layout, and the
    collectives of ``POD_RECORD_CASE``'s step."""
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import make_local_mesh

    params = torch.load(params_file, weights_only=False)
    meshes = {lay: make_local_mesh("cpu", model=lay[2], pod=lay[0]) for lay in POD_LAYOUTS}
    out = {"mesh": {lay: {"coords": m.coords, "zero_ranks": m.zero_ranks,
                          "zero_group": dist.get_process_group_ranks(
                              m.data_group or dist.group.WORLD),
                          "spec": (m.spec.shape, m.spec.axes),
                          "batch": SH.batch_extent(m), "batch_axes": SH.batch_axes(m)}
                    for lay, m in meshes.items()}}
    out["train"] = {c: tp_run(c, params["train"][f"{model}_{plan}"], meshes[lay])
                    for c, (model, plan, lay, _) in POD_CASES.items()}
    out["decode"] = {c: serve_decode(c, params["serve"][m], meshes[lay])
                     for c, (m, lay, _) in POD_DECODE_CASES.items()}
    model, plan, lay, _ = POD_CASES[POD_RECORD_CASE]
    out["recorded"] = recorded_step(POD_RECORD_CASE, params["train"][f"{model}_{plan}"],
                                    meshes[lay])
    return out
