"""Step builders: the plan-driven training step and the serving step's
layout.

Port of ``src/repro/train/step_builder.py``: ``build_train_step``
(``:126-583``), which returns a ``StepArtifacts``; the
stateless full-sequence prefill, ``build_prefill_step`` with ``chunk=None``
(``:816-870``); and the layout the serving builders
(``build_decode_step(per_slot_pos=True)``, ``build_prefill_step(chunk=C)``,
``:756-923``) choose, ``serve_layout``: decode and chunked prefill are one
step here (``serve.prefill.ServeStep``).

Training: ``fn(state, batch) -> (state, metrics)`` runs one step in place on
``state = {"params", "opt", "step"}``. ``metrics["loss"]`` is the
cross-entropy plus the MoE aux loss, ``metrics["ce"]`` the cross-entropy
(``:377``). The params keep the JAX tree,
``{"embed", "runs": [...], "final_norm", "head"}`` with one ``(length, ...)``
stacked subtree per run of the plan (``plan_runs``). The plan lowers so on
one device: ``persist`` and ``hbm`` chunks are one placement, the device. A
``host`` chunk keeps its fp32 ``master``, ``m`` and ``v`` in **pinned host
memory**, which the fused-Adam kernel reads and writes in place -- where the
JAX package round-trips them through the device. The arithmetic is the
same. With ``host_params=False`` (the ZeRO-Offload split) its bf16 params
stay on the device; with ``host_params=True`` they live in pinned memory
too and are fetched per repeat, one repeat ahead on a side stream
(``models/offload.HostIO``): a buffered chunk (``plan.chunk_buffered``)
keeps the fetched copy FWD->BWD, an unbuffered one fetches it again for the
backward. A host embedding, final norm and head are fetched once per
microbatch, the head's copy during the layer stack (the JAX ``fetch``,
``:286-310``, with its overlap ordering). The gradient of a host chunk is
accumulated on the device, like every other chunk's (its bf16 bytes, plus
fp32 accumulators over microbatches), and the Adam kernel writes the new
bf16 weights back to pinned memory in place. The block policies become
runs of ``none``, ``checkpoint``, ``swap``, ``compress8`` or ``compress16``
superblocks (``models/model.apply_runs``), ``microbatch`` the gradient
accumulation of ``train/sync.accumulate_grads``. With ``telemetry`` the
step records ``train.act_bytes`` (on CUDA: the device bytes a microbatch's
forward leaves allocated for its backward) and ``HostIO``'s counters.

A vision-language model's batch carries ``patches`` (B, min(1024, S), D)
beside its tokens (``:255-259``): they run ahead of the tokens through
every layer, and the loss runs over the S token positions.

Gradient sync (``train/sync.py``, ``make_strategy``): on one rank the
xla path's wire numerics (``grad_compress`` int8 + EF, with its residuals
as ``state["ef"]``, or bf16) apply to the accumulated gradients. A manual
plan over a ``launch.mesh.LocalMesh`` of several ranks (``:382-500``) runs
``ManualSync``: each rank takes its rows of the global batch and keeps its
shards of the ZeRO-sharded leaves (``dist/sharding.py``) with their fp32
master, m and v and shard-sized residuals; "ddp" and "zero2" differentiate
full leaves (zero2 gathers its shards once a step) and sync each
microbatch's gradients after the backward; "zero3" gathers each chunk at
its point of use (``make_lazy_loss_fn``: the embedding, final norm and
head at the start, each run's repeats through ``dist.collectives.
LazyGather``), whose backward reduce-scatters. The losses are averaged
over the ranks and the clip's norm sums the shards' squares with one
all-reduce. The xla path on several ranks (``XlaSync`` sharded) lays the
state out by the reference's table (``dist/sharding.py``): persistent
chunks replicated (their optimizer states this rank's shards under
``zero1_persistent``, the new bf16 slices all-gathered after the update),
``hbm`` and ``host`` chunks as this rank's shards -- a host chunk's
optimizer states pinned shards, and under ``host_params`` its weights too.
Each rank takes its rows of the global batch; every non-persistent chunk
is gathered at its point of use through the ``LazyGather`` of ZeRO-3
(``compress="none"``), a host shard copied to the device by ``HostIO``
first, a repeat ahead; buffered chunks keep the gathered weights FWD->BWD,
unbuffered ones gather again in the backward; swapped sites go to this
rank's pinned memory. The gather's backward reduce-scatters; the
replicated leaves' gradients are averaged once the microbatches are
accumulated; then the wire numerics (``XlaSync.finalize_grads``).

With a model axis (``LocalMesh.model > 1``) the xla path shards every leaf
along both of its dims (``dist/sharding.shard2``): its ``zero`` dim over
the data ranks, its ``tp`` / ``exp`` dim over the model ranks. The
``LazyGather`` gathers over the data group only, so a gathered leaf stays
split over ``model`` (the reference's ``gather_sharding``); the model runs
Megatron-style on those shards (``dist/tensor_parallel.py``: column- and
row-parallel attention and MLP -- the decoder's, the encoder's and the
cross-attention's --, experts over the model axis, the Mamba-2 mixer on a
rank's SSD heads, the vocab-parallel embedding and cross-entropy,
sequence sharding under ``seq_shard_acts`` where the model extent divides
every sequence a boundary holds, ``models/model.boundary_lengths``). The
batch splits over the data axis, and under ``dp_only`` -- where the ``tp``
dims stay whole and the model runs as on one device -- over the model
axis too (``dist/sharding.batch_axes``), each rank taking its slice of
every microbatch (``dist/sharding.xla_batch_split``), and the MoE layers
route over the batch group's tokens (``dist.tensor_parallel.BatchGroup``),
as the reference's one program routes the global batch. Every
single-device plan kind and every family runs so.

Serving: ``fn(state, batch)`` runs the step under ``torch.inference_mode``
and returns ``(state, next_tok)``, the greedy argmax taken on the device.
``state`` is ``{"params", "cache"}``; the cache is written in place; the
step runs where the state's tensors lie. The stateless prefill's
``fn(params, batch)`` returns the next-token logits and touches no cache.
On a mesh (``serve_layout(..., mesh)``, ``build_prefill_step(...,
mesh=)``) a rank serves its slots and heads from its weight shards under
the serve plan (``dist/sharding.serve_shards``): the model axis splits
each sublayer as in training, the data ranks split the slots where they
divide them, and a plan with non-persistent chunks ZeRO-shards them over
the data ranks and gathers them at use (``dist.collectives.ServeGather``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.compat import faking, pinned_empty, resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.serve_plan import paging_from_plan
from repro_torch.dist import collectives as COLL
from repro_torch.dist import sharding as SH
from repro_torch.dist.tensor_parallel import (
    BatchGroup,
    TensorParallel,
    batch_group,
    gather_rows,
    gather_vocab,
    make_tensor_parallel,
    vocab_argmax,
)
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.offload import HostIO, proxy_like
from repro_torch.optim import adam as OPT
from repro_torch.serve.paging import PagedKV, PagingSpec
from repro_torch.train import sync as SYNC
from repro_torch.train.losses import chunked_cross_entropy
from repro_torch.train.sync import accumulate_grads

FRONT_KEYS = ("embed", "encoder")  # the front chunk's subtrees, fetched before the layers
NON_RUN_KEYS = FRONT_KEYS + ("final_norm", "head")


@dataclasses.dataclass
class StepArtifacts:
    fn: Callable[[dict, dict], tuple[dict, Any]]
    plan: MemoryPlan | None = None
    runs: list | None = None  # training: the plan's RunLayouts
    init: Callable[[torch.Generator | None], dict] | None = None  # training: a fresh state
    place_state: Callable[[dict], dict] | None = None  # training: a state around given params
    grad_fn: Callable[[dict, dict], tuple] | None = None  # training: the step's gradients
    strategy: Any = None  # training: the gradient sync (train/sync.py)
    leaf_syncs: list | None = None  # training: each param leaf's LeafSync, tree_leaves order
    opt_dims: list | None = None  # training: the dim each leaf's master, m, v shard over
    defs: dict | None = None  # training: the full params' ParamDefs, in the params' tree


# ---------------------------------------------------------------------------
# Plan -> run layout (step_builder.py:51-90)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RunLayout:
    start: int  # first superblock repeat (== chunk index - 1)
    length: int
    placement: str  # persist | hbm | host
    buffered: bool
    act_policy: str  # none | checkpoint | swap | compress8 | compress16


def plan_runs(plan: MemoryPlan, n_repeats: int) -> list[RunLayout]:
    runs: list[RunLayout] = []
    for r in range(n_repeats):
        chunk = r + 1  # chunk 0 is the embedding
        key = (
            plan.chunk_placement(chunk),
            plan.chunk_buffered(chunk),
            plan.block_policy(min(r, plan.n_blocks - 1)),
        )
        if runs and (runs[-1].placement, runs[-1].buffered, runs[-1].act_policy) == key:
            runs[-1].length += 1
        else:
            runs.append(RunLayout(r, 1, *key))
    return runs


def _slice_run_defs(block_defs, length: int):
    """Stacked (R, ...) ParamDefs -> (length, ...) defs for one run."""
    return L.map_defs(lambda d: dataclasses.replace(d, shape=(length,) + d.shape[1:]),
                      block_defs)


def check_train_plan(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig,
                     world: int = 1) -> None:
    """Raise ``ValueError`` for a plan that does not fit the model, or a
    batch that does not split over ``world`` ranks (the batch axes' extent)
    and the plan's microbatches (what the strategy refuses,
    ``train/sync.make_strategy``, it raises itself)."""
    n_rep = M.num_repeats(cfg)
    if plan.n_chunks != n_rep + 2 or plan.n_blocks != n_rep:
        raise ValueError(f"plan {plan.describe()} does not fit {cfg.name}: it has "
                         f"{n_rep + 2} chunks and {n_rep} blocks")
    if shape.global_batch % world or (shape.global_batch // world) % plan.microbatch:
        raise ValueError(f"global batch {shape.global_batch} does not split over {world} "
                         f"rank(s) and {plan.microbatch} microbatches")


def build_train_step(cfg: ModelConfig, plan: MemoryPlan, device, shape: ShapeConfig, *,
                     mesh: LocalMesh | None = None, strategy=None,
                     adam: OPT.AdamConfig | None = None, attn_impl: str = "blockwise",
                     ce_chunk: int = 2048,
                     lr_schedule: Callable[[int], float] | None = None,
                     telemetry: obs.Telemetry | None = None,
                     accumulate: Callable = accumulate_grads) -> StepArtifacts:
    """The plan-driven training step on ``device`` (CUDA unless told
    otherwise), this rank of ``mesh`` (default: a world of one).
    ``batch``: ``tokens`` and ``labels``, (B, S) integer on the device --
    the global batch, of which a rank of a manual sync takes its rows --
    and an encoder-decoder's ``frames`` or a vision-language model's
    ``patches``. ``metrics``: ``loss`` (cross-entropy plus aux loss, the
    mean over the ranks), ``ce``, ``grad_norm`` (device scalars), ``lr``
    and, under int8_ef, ``ef_norm``. ``strategy`` replaces
    ``train/sync.make_strategy``'s choice (a ``ManualSync`` on one rank).
    ``accumulate`` is the microbatch loop (``train/sync.accumulate_grads``;
    the dry-run passes one that runs two trips and counts the rest)."""
    device = resolve_device(device)
    adam = adam or OPT.AdamConfig()
    mesh = mesh if mesh is not None else LocalMesh(0, 1, None, device)
    batch_rank, batch_ranks = SH.batch_extent(mesh, plan.dp_only)
    check_train_plan(cfg, plan, shape, batch_ranks)
    strategy = strategy if strategy is not None else SYNC.make_strategy(plan, mesh)
    manual = strategy.manual_active
    sharded = not manual and strategy.sharded  # the xla path's sharded layouts
    # the model axis: tp / exp dims split over it (None without one, or
    # under dp_only); sequence parallelism where the model extent divides
    # every sequence a block boundary holds (the reference's sharder skips
    # a dim it does not divide: either way the same function)
    seq_fits = all(n % mesh.model == 0 for n in M.boundary_lengths(cfg, shape.seq_len))
    tp = make_tensor_parallel(mesh, plan if seq_fits else
                              dataclasses.replace(plan, seq_shard_acts=False))
    # the xla path's ranks with other rows of the batch: the MoE routes
    # over all of them, as the reference's one program
    route = batch_group(mesh, plan) if sharded else None
    runs_layout = plan_runs(plan, M.num_repeats(cfg))
    defs = M.param_defs(cfg)
    p_defs: dict[str, Any] = {
        "embed": defs["embed"],
        "final_norm": defs["final_norm"],
        "runs": [_slice_run_defs(defs["blocks"], r.length) for r in runs_layout],
    }
    if "head" in defs:
        p_defs["head"] = defs["head"]
    if "encoder" in defs:  # the front chunk's, with the embedding
        p_defs["encoder"] = defs["encoder"]
    head_host = plan.chunk_placement(plan.n_chunks - 1) == "host"
    front_host = plan.chunk_placement(0) == "host"
    on_host = {  # subtrees of host chunks
        "embed": front_host,
        "encoder": front_host,
        "final_norm": head_host,
        "head": head_host,
        "runs": [r.placement == "host" for r in runs_layout],
    }
    # where a subtree's bf16 weights live: in host memory for a host chunk
    # under host_params, else on the device
    weights_on_host = on_host if plan.host_params else {
        k: [False] * len(v) if k == "runs" else False for k, v in on_host.items()}
    # host memory is pinned memory beside a CUDA device; on a CPU device the
    # host is the device and nothing is moved, but host weights are still
    # fetched (copied), so the CPU runs the same path
    pin = device.type == "cuda"
    tel = telemetry if telemetry is not None else obs.NULL_TELEMETRY
    act_bytes = tel.registry.gauge("train.act_bytes")
    io = HostIO(device, tel.registry)
    # each leaf (tree_leaves order): its chunk's placement, and its chunk's
    # label with whether the leaf stacks a run's repeats
    chunk_of = {"embed": plan.chunk_placement(0), "encoder": plan.chunk_placement(0),
                "final_norm": plan.chunk_placement(plan.n_chunks - 1),
                "head": plan.chunk_placement(plan.n_chunks - 1)}
    placements, leaf_chunks, leaf_host = [], [], []
    for key in sorted(p_defs):
        subs = enumerate(p_defs["runs"]) if key == "runs" else [(None, p_defs[key])]
        for i, sub in subs:
            n = len(SH.def_leaves(sub))
            placements += [chunk_of[key] if i is None else runs_layout[i].placement] * n
            leaf_chunks += [(key, False) if i is None else (f"runs[{i}]", True)] * n
            leaf_host += [weights_on_host[key] if i is None else weights_on_host["runs"][i]] * n
    leafs = SYNC.leaf_sync_tree(p_defs, placements, mesh.data, mesh.model, plan.dp_only)
    # the xla path's zero1_persistent: a persistent leaf whose fp32 states
    # are shards over data while its weights stay replicated there (the
    # dim they shard over)
    zero1_dims = [od if sharded and ls.dim is None and mesh.data > 1 else None
                  for ls, od in zip(leafs, (SH.opt_dim(d, mesh.data, pl, plan.zero1_persistent)
                                            for d, pl in zip(SH.def_leaves(p_defs),
                                                             placements)))]
    zero1 = any(d is not None for d in zero1_dims)
    SYNC.record_sync_inventory(strategy, p_defs, leafs, plan.microbatch, tel.registry)

    def host_subtrees(tree, flags):
        """The subtrees of ``tree`` (embed, final_norm, head, runs[i]) whose
        flag is set."""
        subs = [tree[k] for k in NON_RUN_KEYS if k in tree and flags[k]]
        return subs + [sub for sub, f in zip(tree["runs"], flags["runs"]) if f]

    def map_host(tree, flags, fn) -> dict:
        """A copy of ``tree`` with ``fn`` applied to its flagged subtrees."""
        out = {k: fn(v) if k != "runs" and flags.get(k) else v for k, v in tree.items()}
        out["runs"] = [fn(sub) if f else sub for sub, f in zip(tree["runs"], flags["runs"])]
        return out

    def make_proxies(params) -> dict:
        """``params`` with each host weight replaced by its device proxy:
        the leaves autograd differentiates."""
        return map_host(params, weights_on_host,
                        lambda sub: OPT.tree_map(lambda t: proxy_like(t, device), sub))

    def shard_leaves(tree, dims: list) -> dict:
        """This rank's slices of a tree's leaves along ``dims`` over the data
        ranks (None: the leaf itself)."""
        it = iter(dims)
        return OPT.tree_map(lambda t: SH.shard(t, next(it), mesh.data_rank, mesh.data), tree)

    def shard_leaves2(tree) -> dict:
        """This rank's 2-D shards of a tree's full leaves."""
        it = iter(leafs)

        def one(t):
            ls = next(it)
            return SH.shard2(t, ls.dim, ls.mdim, mesh)

        return OPT.tree_map(one, tree)

    def make_gather(params, errs: list, compress: str) -> COLL.LazyGather:
        """The step's ``LazyGather`` over the data group: every leaf sharded
        over data and every leaf in host memory registered, a run's repeat
        by repeat (dim - 1). A gathered leaf stays split over the model
        axis."""
        gather = COLL.LazyGather(mesh.data_group, compress, tel.registry, io=io)
        with torch.no_grad():
            for p, e, ls, (label, stacked), host in zip(OPT.tree_leaves(params), errs, leafs,
                                                        leaf_chunks, leaf_host):
                if ls.dim is None and not host:
                    continue
                if not stacked:
                    gather.register(p, ls.dim, e, label, host)
                    continue
                for r in range(p.shape[0]):
                    gather.register(p[r], None if ls.dim is None else ls.dim - 1,
                                    None if e is None else e[r], label, host)
        return gather

    def make_runs(params, proxies, gather=None) -> list[M.Run]:
        runs = []
        for i, r in enumerate(runs_layout):
            kw = dict(params=params["runs"][i], n_repeats=r.length, act_policy=r.act_policy,
                      ckpt_group=plan.ckpt_group, buffered=r.buffered)
            if gather is not None and r.placement != "persist":  # gathered per repeat
                runs.append(M.Run(**kw, proxies=proxies["runs"][i], io=gather,
                                  prefetch=(plan.gather_prefetch_depth >= 2 and r.buffered
                                            and r.act_policy == "none")))
            else:
                runs.append(M.Run(**kw, proxies=(proxies["runs"][i] if weights_on_host["runs"][i]
                                                 else None)))
        return runs

    def loss_fn(params, proxies, batch, gather=None):
        """(loss, ce) of one microbatch. ``gather``: the step's
        ``LazyGather`` (ZeRO-3, or the xla path on several ranks); the
        embedding, final norm and head are gathered at the start (a tied
        embedding once, so both of its gradients reach the one
        reduce-scatter), each run's repeats as the layers reach them
        (``make_lazy_loss_fn``, ``step_builder.py:382-455``)."""
        fparams = dict(params)
        if gather is not None:
            for key in NON_RUN_KEYS:
                if key in params:
                    fparams[key] = gather.fetch(proxies[key], params[key])
        host_keys = [k for k in NON_RUN_KEYS
                     if gather is None and k in params and weights_on_host[k]]
        for key in host_keys:  # in flight from the start: the head's during the layers
            io.prefetch(params[key])
        for key in FRONT_KEYS:
            if key in host_keys:
                fparams[key] = io.fetch(proxies[key], params[key])
        h, aux = M.forward(fparams, batch, cfg, runs=make_runs(params, proxies, gather),
                           attn_impl=attn_impl, io=io, tp=tp, route=route)
        for key in host_keys:
            if key not in FRONT_KEYS:
                fparams[key] = io.fetch(proxies[key], params[key])
        norm = fparams["final_norm"] if tp is None else tp.norm_params(fparams["final_norm"])
        h = L.apply_norm(norm, h, cfg.norm)
        w = fparams["embed"]["tok"].T if cfg.tie_embeddings else fparams["head"]["w"]
        ce = chunked_cross_entropy(h, w, batch["labels"], ce_chunk=ce_chunk, tp=tp,
                                   vocab=cfg.vocab_size)
        return ce + aux, ce

    def grad_fn(state: dict, batch: dict):
        """The step's gradients and losses: (grads tree, (2,) fp32 [loss,
        ce]), accumulated over the plan's microbatches; the loss is the
        cross-entropy plus the MoE aux loss. Every gradient lies on the
        device. Sharded: over this rank's rows of ``batch`` (its slice of
        each microbatch, split over the batch axes), a leaf sharded over
        data has its gradient
        reduce-scattered over the data group (this rank's shard), a
        replicated leaf's local (``finalize_grads`` averages it), the
        losses averaged over the batch ranks."""
        params = state["params"]
        proxies = make_proxies(params)
        flat = OPT.tree_leaves(proxies)
        gather = None
        if sharded:
            batch = {k: SH.xla_batch_split(v, batch_rank, batch_ranks, plan.microbatch)
                     for k, v in batch.items()}
            gather = make_gather(params, [None] * len(leafs), "none")

        def micro_grad(mb_batch):
            io.reset()
            measure = device.type == "cuda" and not faking()  # not on fake tensors
            before = torch.cuda.memory_allocated(device) if measure else 0
            loss, ce = loss_fn(params, proxies, mb_batch, gather)
            if measure:
                act_bytes.set(torch.cuda.memory_allocated(device) - before)
            io.begin_backward()  # its host reads run one unit ahead
            grads = iter(torch.autograd.grad(loss, flat))
            return OPT.tree_map(lambda _: next(grads), params), torch.stack([loss, ce]).detach()

        grads, losses = accumulate(micro_grad, batch, plan.microbatch)
        return grads, strategy.batch_mean(losses) if sharded else losses

    def manual_grad_fn(state: dict, batch: dict):
        """The manual sync's gradients (this rank's shards of the sharded
        leaves) over this rank's rows of ``batch``, and the losses averaged
        over the ranks."""
        params, ef = state["params"], state.get("ef")
        local = {k: SH.manual_batch_split(v, mesh.rank, mesh.world) for k, v in batch.items()}
        lazy_loss = None
        if strategy.kind == "zero3":
            gather = make_gather(params, strategy.local_ef(ef, leafs), plan.grad_compress)
            lazy_loss = lambda p, mb: loss_fn(p, p, mb, gather)  # noqa: E731
        micro = strategy.micro_grad(params, ef, leafs, loss=lambda p, mb: loss_fn(p, p, mb),
                                    lazy_loss=lazy_loss)
        grads, losses = accumulate(micro, local, plan.microbatch, overlap=plan.overlap)
        return grads, COLL.manual_mean(losses, mesh.group)

    def step_fn(state: dict, batch: dict):
        params = state["params"]
        grads, losses = (manual_grad_fn if manual else grad_fn)(state, batch)
        if manual:
            metrics = ({"ef_norm": strategy.ef_norm(state["ef"], leafs)}
                       if plan.grad_compress == "int8_ef" else {})
            norm = SYNC.grad_norm(grads, leafs, mesh)
        else:
            grads, metrics = strategy.finalize_grads(grads, state.get("ef"), leafs)
            norm = SYNC.grad_norm(grads, leafs, mesh) if sharded else None
        lr = lr_schedule(state["step"]) if lr_schedule else adam.lr
        if zero1:
            p_up, g_up, regather = strategy.update_views(params, grads, zero1_dims)
            gnorm = OPT.adam_update(p_up, g_up, state["opt"], adam, lr, grad_norm=norm)
            regather()
        else:
            gnorm = OPT.adam_update(params, grads, state["opt"], adam, lr, grad_norm=norm)
        state["step"] += 1
        loss, ce = losses.unbind()
        return state, {"loss": loss, "ce": ce, "grad_norm": gnorm, "lr": lr, **metrics}

    def place_state(params: dict) -> dict:
        """``{"params", "opt", "step"}`` (and ``"ef"`` under int8_ef) around
        the full ``params`` (tensors on the device, in the tree above): a
        host chunk's weights move to pinned memory under host_params, a
        manual or sharded sync keeps this rank's shards, fresh optimizer
        states (and zero residuals) are placed by plan: this rank's shards
        of its leaves, a zero1 leaf's sliced from its replicated weights."""
        if manual or sharded:
            params = shard_leaves2(params)
        if pin:
            params = map_host(params, weights_on_host, to_pinned)
        opt_src = shard_leaves(params, zero1_dims) if zero1 else params

        def states(sub, host: bool) -> dict:
            """fp32 master, m and v of a subtree: a host chunk's made in
            pinned memory leaf by leaf (made whole on the device or in
            pageable memory first, they would need their 12 B a parameter
            twice), the others beside their weights."""
            if host:
                return {"master": pinned_master(sub), "m": pinned_zeros(sub),
                        "v": pinned_zeros(sub)}
            return OPT.init_opt_state(sub)

        parts = {k: states(v, pin and on_host[k]) for k, v in opt_src.items() if k != "runs"}
        runs = [states(sub, pin and f) for sub, f in zip(opt_src["runs"], on_host["runs"])]
        opt = {key: {**{k: st[key] for k, st in parts.items()}, "runs": [r[key] for r in runs]}
               for key in ("master", "m", "v")}
        opt["count"] = 0
        for p in OPT.tree_leaves(params):
            p.requires_grad_(True)
        for p in OPT.tree_leaves(host_subtrees(params, weights_on_host)):
            p.requires_grad_(False)  # their proxies take the gradients
        state = {"params": params, "opt": opt, "step": 0}
        ef = strategy.ef_state(params, leafs) if manual else strategy.ef_state(params, device)
        if ef is not None:
            state["ef"] = ef
        return state

    def init(generator: torch.Generator | None = None) -> dict:
        """A fresh state drawn from ``generator`` (on the device; default: seed 0).
        On CUDA the allocator's cache is emptied after: the draw's fp32
        temporaries and the device copies of host chunks' weights are gone,
        and their blocks would otherwise stay reserved between the step's
        allocations."""
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        state = place_state(L.init_tree(p_defs, generator, device))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return state

    return StepArtifacts(fn=step_fn, plan=plan, runs=runs_layout, init=init,
                         place_state=place_state,
                         grad_fn=manual_grad_fn if manual else grad_fn, strategy=strategy,
                         leaf_syncs=leafs, defs=p_defs,
                         opt_dims=[ls.dim if z is None else z for ls, z in zip(leafs, zero1_dims)])


def to_pinned(tree):
    """A copy of a tree in pinned host memory."""
    return OPT.tree_map(lambda t: pinned_empty(t.shape, t.dtype).copy_(t), tree)


def pinned_master(tree):
    """fp32 copies of a tree's weights, made in pinned host memory."""
    return OPT.tree_map(lambda t: pinned_empty(t.shape, torch.float32).copy_(t.detach()), tree)


def pinned_zeros(tree):
    """fp32 zeros shaped like a tree, in pinned host memory."""
    return OPT.tree_map(lambda t: pinned_empty(t.shape, torch.float32).zero_(), tree)


@dataclasses.dataclass
class ServeLayout:
    """A rank's serving layout (``serve_layout``): the page geometry (None
    for a resident cache) and the cache hook the step threads through
    ``decode_forward``; on a mesh also the model axis (``tp``), the MoE's
    batch group over the data ranks where they split the slots
    (``route``), this rank's slots (``slots``: first, count, of ``batch``)
    and the serve tree's dims over the data and model ranks."""

    paging: PagingSpec | None
    kv_io: Any
    batch: int
    mesh: LocalMesh | None = None
    plan: MemoryPlan | None = None
    defs: dict | None = None
    tp: Any = None
    route: Any = None
    slots: tuple[int, int] = (0, 0)
    data_dims: dict | None = None

    @property
    def world(self) -> int:
        return 1 if self.mesh is None else self.mesh.world

    @property
    def rows(self) -> slice:
        """This rank's slots (rows of a whole-batch input)."""
        return slice(self.slots[0], self.slots[0] + self.slots[1])

    def shard(self, params: dict) -> dict:
        """This rank's shards of the whole serve tree ``params``
        (``params`` itself at a world of one)."""
        if self.world == 1:
            return params
        return SH.serve_shards(params, self.defs, self.plan, self.mesh)

    def gather(self, shards: dict, registry=None) -> COLL.ServeGather | None:
        """The weights' gathers over the data ranks for this rank's
        ``shards`` (None where no leaf is sharded over them)."""
        dims = COLL.tree_leaves_dims(self.data_dims) if self.data_dims is not None else []
        if not any(d is not None for d in dims):
            return None
        g = COLL.ServeGather(self.mesh.data_group,
                             obs.NULL_REGISTRY if registry is None else registry)
        g.register(shards, self.data_dims)
        return g

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x`` (this rank's slots first-dim) made
        whole over the data ranks (``x`` itself where they hold every
        slot)."""
        if self.slots[1] == self.batch:
            return x
        return gather_rows(x, self.mesh.data_group, self.mesh.data)

    def greedy(self, logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """The whole batch's greedy tokens from this rank's logits (its
        slots, its vocab slice): the argmax over the model group, then the
        data group's all-gather."""
        return self.gather_rows(vocab_argmax(logits, self.tp, cfg.vocab_size))


def _mesh_layout(cfg: ModelConfig, plan: MemoryPlan, batch: int, mesh) -> dict:
    """The fields of ``ServeLayout`` a mesh decides (none at a world of one)."""
    if mesh is None or mesh.world == 1:
        return {"slots": (0, batch)}
    defs = M.param_defs(cfg)
    slots = SH.slot_split(batch, mesh)
    return {"mesh": mesh, "plan": plan, "defs": defs, "slots": slots,
            "tp": (TensorParallel(mesh.model_group, mesh.model_rank, mesh.model)
                   if mesh.model > 1 else None),
            "route": (BatchGroup(mesh.data_group, mesh.data_rank, mesh.data)
                      if slots[1] < batch else None),
            "data_dims": SH.serve_dims(defs, plan, mesh)[0]}


def build_prefill_step(cfg: ModelConfig, plan: MemoryPlan, device, shape: ShapeConfig, *,
                       chunk: int | None = None, attn_impl: str = "blockwise",
                       mesh: LocalMesh | None = None) -> StepArtifacts:
    """The stateless full-sequence prefill (``chunk=None`` in the JAX
    package, ``step_builder.py:816-870``): one parallel forward of every
    layer with nothing kept for a backward, the final norm at the last
    position and the head. ``fn(params, batch)`` takes the parameter tree
    on ``device`` (CUDA unless told otherwise) and ``batch["tokens"]`` (B,
    S), with an encoder-decoder's ``frames`` or a vision-language model's
    ``patches`` (B, min(1024, S), D), and returns the (B, V) next-token
    logits under ``torch.inference_mode``; it touches no decode cache.
    Chunked prefill, which ingests a cache, is ``serve.prefill.ServeStep``.

    On a ``mesh`` (``device`` is then the mesh's): ``place_state(params)``
    gives this rank's shards of the whole tree under the serve plan
    (``dist/sharding.serve_shards``), which ``fn`` takes; every rank takes
    the whole batch and runs its rows where the data ranks divide B, the
    model axis split as in training (the encoder's frames and the VLM's
    patches too), the MoE routed over the data ranks' rows, the
    non-persistent chunks gathered over the data ranks at use (the layer
    stack a superblock ahead, through ``dist.collectives.ServeGather``);
    the logits come back whole on every rank, all-gathered over the vocab
    and the batch."""
    if chunk is not None:
        raise ValueError(f"chunk={chunk}: chunked prefill into a decode cache is "
                         "serve.prefill.ServeStep (through serve.DecodeEngine)")
    device = mesh.device if mesh is not None else resolve_device(device)
    want = (shape.global_batch, shape.seq_len)
    SH.serve_placements(plan)  # raises for weight chunks in host memory
    lay = ServeLayout(None, None, shape.global_batch,
                      **_mesh_layout(cfg, plan, shape.global_batch, mesh))
    n_rep = M.num_repeats(cfg)

    def step_fn(params: dict, batch: dict) -> torch.Tensor:
        if tuple(batch["tokens"].shape) != want or batch["tokens"].device.type != device.type:
            raise ValueError(f"tokens {tuple(batch['tokens'].shape)} on "
                             f"{batch['tokens'].device}, want {want} on {device}")
        gather = lay.gather(params)
        with torch.inference_mode():
            local = {k: v[lay.rows] for k, v in batch.items()}
            p = params if gather is None else gather.outer(params)
            # under a sharded plan the layer stack is gathered a superblock ahead
            run = (M.Run(params=p["blocks"], n_repeats=n_rep) if gather is None else
                   M.Run(params=p["blocks"], n_repeats=n_rep, proxies=p["blocks"],
                         io=gather.lazy, prefetch=True))
            h, _ = M.forward(p, local, cfg, runs=[run], attn_impl=attn_impl, tp=lay.tp,
                             route=lay.route)
            logits = M.lm_head(p, h[:, -1:].contiguous(), cfg, lay.tp)[:, 0]
            return lay.gather_rows(gather_vocab(logits, lay.tp, cfg.vocab_size))

    return StepArtifacts(fn=step_fn, plan=plan, runs=plan_runs(plan, n_rep),
                         place_state=lay.shard)


def serve_layout(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig,
                 paging: PagingSpec | None = None, mesh: LocalMesh | None = None) -> ServeLayout:
    """The serving step's layout: the page geometry (None for a resident
    cache) and the cache hook the step threads through ``decode_forward``
    and, on a ``mesh``, this rank's part: its slots (``B / data`` where the
    data ranks divide B, else every slot), its heads over the model ranks,
    its weight shards under the plan (the layer stack, and the embedding
    and head where their chunks are not persistent, ZeRO-sharded over the
    data ranks and gathered at use). Every plan ``core.serve_plan`` returns
    runs: resident, paged, and ``n_persist = 0``. Decode and chunked
    prefill are one step, ``serve.prefill.ServeStep``, which the engine
    binds to its state; the stateless full-sequence prefill is
    ``build_prefill_step``. The model axis splits the ``tp`` and ``exp``
    dims (``dp_only`` and ``seq_shard_acts`` lay out training's batch and
    activations, and serving keeps the decode step's layout)."""
    SH.serve_placements(plan)  # raises for weight chunks in host memory
    if paging is None:
        paging = paging_from_plan(cfg, shape, plan)
    kv_io = KV.RESIDENT_KV if paging is None else PagedKV(paging)
    return ServeLayout(paging, kv_io, shape.global_batch,
                       **_mesh_layout(cfg, plan, shape.global_batch, mesh))
