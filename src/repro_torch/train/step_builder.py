"""Step builders: the plan-driven training step and the serving step's
layout, on one device.

Port of ``src/repro/train/step_builder.py``: ``build_train_step``
(``:126-583``, the xla-sync branch), which returns a ``StepArtifacts``; the
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

Serving: ``fn(state, batch)`` runs the step under ``torch.inference_mode``
and returns ``(state, next_tok)``, the greedy argmax taken on the device.
``state`` is ``{"params", "cache"}``; the cache is written in place; the
step runs where the state's tensors lie. The stateless prefill's
``fn(params, batch)`` returns the next-token logits and touches no cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import obs
from repro_torch.compat import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.serve_plan import paging_from_plan
from repro_torch.models import kvcache as KV
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.offload import HostIO, proxy_like
from repro_torch.optim import adam as OPT
from repro_torch.serve.paging import PagedKV, PagingSpec
from repro_torch.train.losses import chunked_cross_entropy
from repro_torch.train.sync import accumulate_grads

_SYNC_TODO = "ROADMAP.md, port queue 1: distributed sync"
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


def check_train_plan(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for what this
    slice does not run, and ``ValueError`` for a plan that does not fit the
    model or the batch."""
    if plan.sync_mode != "xla" or plan.grad_compress != "none":
        raise NotImplementedError(
            f"sync_mode={plan.sync_mode!r}, grad_compress={plan.grad_compress!r}: one device "
            f"runs the plain reduction only ({_SYNC_TODO})")
    n_rep = M.num_repeats(cfg)
    if plan.n_chunks != n_rep + 2 or plan.n_blocks != n_rep:
        raise ValueError(f"plan {plan.describe()} does not fit {cfg.name}: it has "
                         f"{n_rep + 2} chunks and {n_rep} blocks")
    if shape.global_batch % plan.microbatch:
        raise ValueError(f"global batch {shape.global_batch} does not split into "
                         f"{plan.microbatch} microbatches")


def build_train_step(cfg: ModelConfig, plan: MemoryPlan, device, shape: ShapeConfig, *,
                     adam: OPT.AdamConfig | None = None, attn_impl: str = "blockwise",
                     ce_chunk: int = 2048,
                     lr_schedule: Callable[[int], float] | None = None,
                     telemetry: obs.Telemetry | None = None) -> StepArtifacts:
    """The plan-driven training step on one device (CUDA unless ``device``
    says otherwise). ``batch``: ``tokens`` and ``labels``, (B, S) integer on
    the device, and an encoder-decoder's ``frames`` or a vision-language
    model's ``patches``. ``metrics``: ``loss`` (cross-entropy plus aux
    loss), ``ce``, ``grad_norm`` (device scalars) and ``lr``."""
    device = resolve_device(device)
    adam = adam or OPT.AdamConfig()
    check_train_plan(cfg, plan, shape)
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

    def make_runs(params, proxies) -> list[M.Run]:
        return [M.Run(params=params["runs"][i], n_repeats=r.length, act_policy=r.act_policy,
                      ckpt_group=plan.ckpt_group, buffered=r.buffered,
                      proxies=proxies["runs"][i] if weights_on_host["runs"][i] else None)
                for i, r in enumerate(runs_layout)]

    def loss_fn(params, proxies, batch):
        fparams = dict(params)
        host_keys = [k for k in NON_RUN_KEYS if k in params and weights_on_host[k]]
        for key in host_keys:  # in flight from the start: the head's during the layers
            io.prefetch(params[key])
        for key in FRONT_KEYS:
            if key in host_keys:
                fparams[key] = io.fetch(proxies[key], params[key])
        h, aux = M.forward(fparams, batch, cfg, runs=make_runs(params, proxies),
                           attn_impl=attn_impl, io=io)
        for key in host_keys:
            if key not in FRONT_KEYS:
                fparams[key] = io.fetch(proxies[key], params[key])
        h = L.apply_norm(fparams["final_norm"], h, cfg.norm)
        w = fparams["embed"]["tok"].T if cfg.tie_embeddings else fparams["head"]["w"]
        ce = chunked_cross_entropy(h, w, batch["labels"], ce_chunk=ce_chunk)
        return ce + aux, ce

    def grad_fn(state: dict, batch: dict):
        """The step's gradients and losses: (grads tree, (2,) fp32 [loss,
        ce]), accumulated over the plan's microbatches; the loss is the
        cross-entropy plus the MoE aux loss. Every gradient lies on the
        device."""
        params = state["params"]
        proxies = make_proxies(params)
        flat = OPT.tree_leaves(proxies)

        def micro_grad(mb_batch):
            io.reset()
            before = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
            loss, ce = loss_fn(params, proxies, mb_batch)
            if device.type == "cuda":
                act_bytes.set(torch.cuda.memory_allocated(device) - before)
            io.begin_backward()  # its host reads run one unit ahead
            grads = iter(torch.autograd.grad(loss, flat))
            return OPT.tree_map(lambda _: next(grads), params), torch.stack([loss, ce]).detach()

        return accumulate_grads(micro_grad, batch, plan.microbatch)

    def step_fn(state: dict, batch: dict):
        params = state["params"]
        grads, losses = grad_fn(state, batch)
        lr = lr_schedule(state["step"]) if lr_schedule else adam.lr
        gnorm = OPT.adam_update(params, grads, state["opt"], adam, lr)
        state["step"] += 1
        loss, ce = losses.unbind()
        return state, {"loss": loss, "ce": ce, "grad_norm": gnorm, "lr": lr}

    def place_state(params: dict) -> dict:
        """``{"params", "opt", "step"}`` around ``params`` (tensors on the
        device, in the tree above): a host chunk's weights move to pinned
        memory under host_params, fresh optimizer states are placed by plan."""
        if pin:
            params = map_host(params, weights_on_host, to_pinned)

        def states(sub, host: bool) -> dict:
            """fp32 master, m and v of a subtree: a host chunk's made in
            pinned memory leaf by leaf (made whole on the device or in
            pageable memory first, they would need their 12 B a parameter
            twice), the others beside their weights."""
            if host:
                return {"master": pinned_master(sub), "m": pinned_zeros(sub),
                        "v": pinned_zeros(sub)}
            return OPT.init_opt_state(sub)

        parts = {k: states(v, pin and on_host[k]) for k, v in params.items() if k != "runs"}
        runs = [states(sub, pin and f) for sub, f in zip(params["runs"], on_host["runs"])]
        opt = {key: {**{k: st[key] for k, st in parts.items()}, "runs": [r[key] for r in runs]}
               for key in ("master", "m", "v")}
        opt["count"] = 0
        for p in OPT.tree_leaves(params):
            p.requires_grad_(True)
        for p in OPT.tree_leaves(host_subtrees(params, weights_on_host)):
            p.requires_grad_(False)  # their proxies take the gradients
        return {"params": params, "opt": opt, "step": 0}

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
                         place_state=place_state, grad_fn=grad_fn)


def to_pinned(tree):
    """A copy of a tree in pinned host memory."""
    return OPT.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        .copy_(t), tree)


def pinned_master(tree):
    """fp32 copies of a tree's weights, made in pinned host memory."""
    return OPT.tree_map(lambda t: torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
                        .copy_(t.detach()), tree)


def pinned_zeros(tree):
    """fp32 zeros shaped like a tree, in pinned host memory."""
    return OPT.tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32, pin_memory=True),
                        tree)


def check_serve_plan(plan: MemoryPlan) -> None:
    if plan.n_persist != plan.n_chunks:
        raise NotImplementedError(
            f"serving plan {plan.describe()}: only an all-persistent weight placement "
            "runs on one device (ROADMAP.md, the planner and distributed slices)")


def build_prefill_step(cfg: ModelConfig, plan: MemoryPlan, device, shape: ShapeConfig, *,
                       chunk: int | None = None, attn_impl: str = "blockwise") -> StepArtifacts:
    """The stateless full-sequence prefill (``chunk=None`` in the JAX
    package, ``step_builder.py:816-870``): one parallel forward of every
    layer with nothing kept for a backward, the final norm at the last
    position and the head. ``fn(params, batch)`` takes the parameter tree
    on ``device`` (CUDA unless told otherwise) and ``batch["tokens"]`` (B,
    S), with an encoder-decoder's ``frames`` or a vision-language model's
    ``patches`` (B, min(1024, S), D), and returns the (B, V) next-token
    logits under ``torch.inference_mode``; it touches no decode cache.
    Chunked prefill, which ingests a cache, is ``serve.prefill.ServeStep``."""
    if chunk is not None:
        raise ValueError(f"chunk={chunk}: chunked prefill into a decode cache is "
                         "serve.prefill.ServeStep (through serve.DecodeEngine)")
    device = resolve_device(device)
    check_serve_plan(plan)
    want = (shape.global_batch, shape.seq_len)

    def step_fn(params: dict, batch: dict) -> torch.Tensor:
        if tuple(batch["tokens"].shape) != want or batch["tokens"].device.type != device.type:
            raise ValueError(f"tokens {tuple(batch['tokens'].shape)} on "
                             f"{batch['tokens'].device}, want {want} on {device}")
        with torch.inference_mode():
            runs = [M.Run(params=params["blocks"], n_repeats=M.num_repeats(cfg))]
            h, _ = M.forward(params, batch, cfg, runs=runs, attn_impl=attn_impl)
            return M.lm_head(params, h[:, -1:].contiguous(), cfg)[:, 0]

    return StepArtifacts(fn=step_fn, plan=plan, runs=plan_runs(plan, M.num_repeats(cfg)))


def serve_layout(cfg: ModelConfig, plan: MemoryPlan, shape: ShapeConfig,
                 paging: PagingSpec | None = None) -> tuple[PagingSpec | None, Any]:
    """The serving step's cache layout: ``(paging, kv_io)``, the page
    geometry (None for a resident cache) and the cache hook the step threads
    through ``decode_forward``. Decode and chunked prefill are one step,
    ``serve.prefill.ServeStep``, which the engine binds to its state; the
    stateless full-sequence prefill is ``build_prefill_step``."""
    check_serve_plan(plan)
    if paging is None:
        paging = paging_from_plan(cfg, shape, plan)
    kv_io = KV.RESIDENT_KV if paging is None else PagedKV(paging)
    return paging, kv_io
