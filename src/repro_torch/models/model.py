"""Model assembly: parameter tree, superblocks, runs, the encoder, the
training forward, embedding and LM head.

Port of ``src/repro/models/model.py``: attention and Mamba-2 mixers
(``models/mamba2.py``), dense MLPs and MoE layers (``models/moe.py``), in
any superblock pattern (the hybrid's 8-layer period of Jamba), the
encoder-decoder family (``seamless-m4t-large-v2``) and the vision-language
family (``llava-next-34b``: a decoder whose image patches enter ahead of
the tokens). Parameters keep the
JAX package's tree: ``{"embed": {"tok"}, "blocks": {"pos<j>": {...}},
"final_norm": {...}, "head": {"w"}}`` plus, for an encoder-decoder,
``"encoder": {"blocks": {...}, "final_norm"}``; each block leaf stacked over
superblock repeats (the encoder's over its layers), ``(R, ...)``; the
training state splits ``blocks`` into
``"runs": [...]``, one stacked subtree per run of the plan
(``train/step_builder.py``). ``DecoderLM`` holds such a tree as an
``nn.Module`` whose parameter names are the tree paths joined by ``.``
(``blocks.pos0.attn.wq``, shape ``(R, d, nq)``).

The layer stack runs as a list of ``Run``s (``apply_runs``). JAX scans each
run over its stacked leaves; here a Python loop walks the leaves' first axis
(``unbind``, so the backward stacks the per-repeat gradients in one copy).
Each layer position tags three save sites -- norm1's output, the mixer's
output and the MLP's or MoE's output (``save_act``), and a fourth, the
cross-attention's output, in an encoder-decoder's decoder -- and the run's act policy
decides what lives FWD->BWD, as ``_remat_policy`` (``model.py:414-452``)
does: ``none`` keeps every activation; ``checkpoint`` keeps the position's
input and recomputes the rest in the backward (``torch.utils.checkpoint``
without reentrancy), or each region of ``ckpt_group`` superblocks;
``compress8`` / ``compress16`` / ``swap`` keep the input plus the sites
the backward reads (norm1's output, the mixer's and the cross-attention's;
the MLP output feeds only the residual add) -- as int8 rows with fp32 scales
(the ``fused_quantize_ef`` kernel, which runs at every site in the forward
and never in the replay), as bf16, or in pinned host memory -- and the
backward's replay takes the sites from there (``ActSites``) and recomputes
everything else. A run whose
weights live in host memory (``Run.proxies``) fetches them per repeat, one
repeat ahead, through ``offload.HostIO``; ``buffered`` keeps the fetched
copy FWD->BWD, else the backward fetches it again (inside the replay of a
recomputed position, as in JAX, where the gather sits inside the remat
region). A ZeRO-3 run of the manual sync (``Run.io``: the step's
``dist.collectives.LazyGather``, ``Run.proxies``: its shards) gathers its
weights the same way, per repeat (``Run.lazy_gather`` / ``prefetch`` in
``model.py:342-370, 470-510``): buffered, the gathered copy lives FWD->BWD;
unbuffered, the backward gathers it again (``_save_acts_not_lazy_gathers``,
``:392-430``); the backward of each gather is the reduce-scatter. The xla
path on several ranks runs its non-persistent chunks so too, with
``Run.proxies`` the device proxies of shards that lie in host memory
(``host_params``): their copies to the device run a repeat ahead.

Over the model axis (``tp``, a ``dist.tensor_parallel.TensorParallel``;
every family) each sublayer runs on this rank's shards of its weights --
attention and the MLPs column / row split, the experts over the axis, the
Mamba-2 mixer on its SSD heads -- and the hidden states between sublayers
are whole on every model rank, or this rank's rows of the sequence under
``seq_shard_acts`` (the reference's ``bsd`` sites, ``model.py:314, 333``,
gathered at a sublayer's ``enter``); the embedding is the vocab-parallel
lookup (``:628``) and the head's logits stay split over the vocab
(``:634``). The encoder splits so too, its boundaries over ``S_src``
(``:640, 658``); its output enters the decoder whole on every rank, its
gradient summed over the model group there. A VLM's boundary under
sequence sharding is this rank's rows of the ``P + S`` positions: the
tokens are embedded whole, the patches put ahead, and then split; after
the layers the token rows are split again. ``route`` (a
``dist.tensor_parallel.BatchGroup``: the xla path's ranks with other rows
of the batch) routes the MoE layers over the whole batch.

Each position returns ``(x, aux)``: an MoE position's load-balance loss
(``apply_moe``), 0.0 for a dense one. The aux losses are summed through
superblocks, checkpointed regions and runs, and ``forward`` returns them
beside the hidden states, as the JAX package does; recomputed, compressed,
swapped and host-weight runs carry them alike.

An encoder-decoder runs ``encode`` over ``batch["frames"]`` (B, S_src, D),
every encoder layer recomputed in the backward (the reference's
``_remat_policy("checkpoint", True)``), and each decoder position attends
over its output, ``memory``, after the mixer's residual. ``memory`` enters
every recomputed region, host-weight replay and grouped region as an
explicit input, so its gradient reaches the encoder from every decoder
layer.

A model fed by the vision frontend takes ``batch["patches"]`` (B, P, D),
precomputed patch embeddings: ``forward`` casts them to the model's dtype,
puts them ahead of the embedded tokens and slices their P positions off
the hidden states after the layer stack (``model.py:678-687``). The prefix
is P more positions to every layer -- its act policy, save sites, recomputed
regions and host-weight runs alike -- and RoPE runs over positions 0 ... P
+ S - 1. Patches are an input: nothing differentiates them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch import kernels as K
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models.offload import HostIO
from repro_torch.models.layers import LAYER, TP, ZERO, ParamDef

ACT_POLICIES = ("none", "checkpoint", "swap", "compress8", "compress16")
SITE_POLICIES = ("swap", "compress8", "compress16")  # keep the save sites the backward reads
XAux = tuple[torch.Tensor, "torch.Tensor | float"]  # hidden states, aux loss (0.0 if dense)


def superblock_period(cfg: ModelConfig) -> int:
    p = len(cfg.mixer_pattern)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    return p


def num_repeats(cfg: ModelConfig) -> int:
    p = superblock_period(cfg)
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return cfg.num_layers // p


# the model kind each frontend feeds: frames an encoder, patches a decoder's prefix
FRONTEND_KINDS = {"none": ("decoder", "encdec"), "audio_frames": ("encdec",),
                  "vision_patches": ("decoder",)}


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a frontend the model's kind has no input
    for: the port runs decoders of attention and Mamba-2 positions with
    dense MLPs or MoE layers, a decoder after image patches, and
    encoder-decoders over precomputed frames."""
    if cfg.kind not in FRONTEND_KINDS[cfg.frontend]:
        raise ValueError(f"{cfg.name}: the {cfg.frontend} frontend feeds no {cfg.kind}")


def _position_defs(cfg: ModelConfig, pos: int, cross_attention: bool = False) -> dict:
    """ParamDefs for one layer position within the superblock."""
    defs: dict[str, Any] = {"norm1": L.norm_defs(cfg.d_model, cfg.norm)}
    if cfg.mixer_at(pos) == "attention":
        defs["attn"] = L.attention_defs(cfg)
    else:
        defs["mamba"] = M2.mamba2_defs(cfg)
    if cross_attention:
        defs["norm_x"] = L.norm_defs(cfg.d_model, cfg.norm)
        defs["xattn"] = L.cross_attention_defs(cfg)
    if cfg.moe_at(pos):
        defs["norm2"] = L.norm_defs(cfg.d_model, cfg.norm)
        defs["moe"] = MOE.moe_defs(cfg)
    elif cfg.d_ff:
        defs["norm2"] = L.norm_defs(cfg.d_model, cfg.norm)
        defs["mlp"] = L.mlp_defs(cfg)
    return defs


def _stack_defs(defs, n: int):
    """Prepend a stacked LAYER axis of size n to every ParamDef."""
    return L.map_defs(
        lambda d: ParamDef((n,) + d.shape, (LAYER,) + d.axes, init=d.init,
                           scale=d.scale, dtype=d.dtype), defs)


def param_defs(cfg: ModelConfig) -> dict:
    """Full parameter ParamDef tree of the model."""
    check_family(cfg)
    p = superblock_period(cfg)
    r = num_repeats(cfg)
    encdec = cfg.kind == "encdec"
    defs: dict[str, Any] = {
        "embed": {"tok": ParamDef((cfg.vocab_size, cfg.d_model), (TP, ZERO), scale=0.02)},
        "blocks": {f"pos{j}": _stack_defs(_position_defs(cfg, j, cross_attention=encdec), r)
                   for j in range(p)},
        "final_norm": L.norm_defs(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["head"] = {"w": ParamDef((cfg.d_model, cfg.vocab_size), (ZERO, TP), scale=0.02)}
    if encdec:
        defs["encoder"] = {
            "blocks": _stack_defs(_position_defs(cfg, 0), cfg.encoder_layers),
            "final_norm": L.norm_defs(cfg.d_model, cfg.norm),
        }
    if cfg.dtype != "bfloat16":
        defs = L.map_defs(
            lambda d: dataclasses.replace(d, dtype=cfg.dtype) if d.dtype == "bfloat16" else d,
            defs)
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters from ``generator`` (which must live on ``device``)."""
    return L.init_tree(param_defs(cfg), generator, device)


def boundary_lengths(cfg: ModelConfig, seq_len: int) -> tuple[int, ...]:
    """Every sequence a block boundary holds in a training step of
    ``seq_len`` tokens: the tokens, a VLM's min(1024, S) patches and the
    tokens (``step_builder.py:255-259``), an encoder's frames (as many as
    the tokens)."""
    if cfg.frontend == "vision_patches":
        return seq_len, seq_len + min(1024, seq_len)
    return (seq_len,) * (2 if cfg.kind == "encdec" else 1)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                 tp=None) -> torch.Tensor:
    """The token embedding; ``tp``: the vocab-parallel lookup where the
    vocab splits over the model axis, in the block boundary's layout."""
    tok = params["embed"]["tok"]
    if tp is None:
        return tok[tokens]
    if tok.shape[0] != cfg.vocab_size:
        return tp.vocab_embed(tok, tokens)
    return tp.exit(tok[tokens], partial=False)


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The logits; ``tp``: this rank's slice of the vocab where the head
    splits over the model axis (``shard_act(..., "logits")``)."""
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]["w"]
    if tp is not None:
        x = tp.enter(x, partial=w.shape[-1] != cfg.vocab_size)
    return x @ w


def _to_module(tree) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _from_module(mod: nn.Module):
    if isinstance(mod, nn.ParameterDict):
        return {k: v for k, v in mod.items()}
    return {k: _from_module(v) for k, v in mod.items()}


class DecoderLM(nn.Module):
    """The model's parameters as a module, for serving (no gradients).

    ``DecoderLM(cfg, params)`` wraps an existing tree without copying;
    ``DecoderLM.init(cfg, generator, device)`` draws a random one. ``tree()``
    gives the nested dict the functional paths take.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_family(cfg)
        self.cfg = cfg
        for name, sub in params.items():
            self.add_module(name, _to_module(sub))

    @classmethod
    def init(cls, cfg: ModelConfig, generator: torch.Generator, device) -> "DecoderLM":
        return cls(cfg, init_params(cfg, generator, device))

    def tree(self) -> dict:
        return {name: _from_module(mod) for name, mod in self.named_children()}


# ---------------------------------------------------------------------------
# Training forward (model.py:178-266, 297-375, 414-560, 665-688)
# ---------------------------------------------------------------------------
def check_act_policy(policy: str) -> None:
    if policy not in ACT_POLICIES:
        raise ValueError(f"act policy {policy!r} not in {ACT_POLICIES}")


@torch.no_grad()
def _quantize_rows(x: torch.Tensor):
    """Per-row absmax int8 quantize of an activation's rows (its last axis)
    -> (q (rows, d), scale (rows,)): the ``fused_quantize_ef`` kernel on CUDA
    (it widens bf16 itself), its plain version on the CPU. The residual of
    chunk 0 is discarded. No gradient flows through the rounding."""
    q, s, _ = K.fused_quantize_ef(x.contiguous().reshape(-1, x.shape[-1]), 0)
    return q, s


@torch.no_grad()
def _dequantize(q: torch.Tensor, s: torch.Tensor, shape, dtype) -> torch.Tensor:
    return (q.float() * s[:, None]).reshape(shape).to(dtype)


class _Use(torch.autograd.Function):
    """``use(value, x)``: carries on with ``value`` (a stored site's payload
    brought back, e.g. dequantized), while the gradient goes straight
    through to x (``compress_act``'s ``use``, ``model.py:238-248``)."""

    @staticmethod
    def forward(ctx, value, x):
        return value

    @staticmethod
    def backward(ctx, ct):
        return None, ct


def _compressed(x: torch.Tensor, mode: str):
    """(the value a compressed save site carries on with, its payload)."""
    if mode == "compress16":
        v = x.to(torch.bfloat16)
        return v.to(x.dtype), v.detach()
    if mode != "compress8":
        raise ValueError(mode)
    q, s = _quantize_rows(x)
    return _Use.apply(_dequantize(q, s, x.shape, x.dtype), x), (q, s)


def compress_act(x: torch.Tensor, mode: str = "compress8") -> torch.Tensor:
    """The value a compressed save site carries on with (``model.py:197-258``).

    ``compress8``: the int8 rows dequantized, ``bf16(f32(q) * scale)`` in x's
    dtype, with the straight-through gradient; ``compress16``: a bf16 round
    trip. What is kept FWD->BWD is the run's business (``ActSites``)."""
    return _compressed(x, mode)[0]


class ActSites:
    """The save sites of one recomputed layer position under a ``swap`` /
    ``compress8`` / ``compress16`` run.

    In the forward each site carries on with the value ``compress_act``
    gives (``swap`` leaves it as it is) and stores its payload -- int8 rows
    and scales (one ``fused_quantize_ef`` launch), the bf16 tensor, or a
    pinned host copy (``HostIO.swap_out``) -- when the backward reads it
    (``keep``). Once the forward is over (``seal``), the position's replay
    calls the sites again in the same order (``begin`` at the top of the
    position); they return the value from the stored payload and quantize
    nothing. A site that is not kept (the MLP output, whose only consumer
    is the residual add: its gradient needs neither operand) is never
    reached by the replay, which stops once the backward's saved tensors
    are rebuilt; were it reached, it returns x, which only the discarded
    output of the position would see. This is what JAX keeps too: its
    remat saves a named value only when the backward reads it."""

    def __init__(self, mode: str, io: HostIO):
        self.mode, self.io = mode, io
        self.saved: list = []
        self._replay: int | None = None  # None while the forward runs

    def begin(self) -> None:
        if self._replay is not None:
            self._replay = 0

    def seal(self) -> None:
        self._replay = 0

    def __call__(self, x: torch.Tensor, keep: bool = True) -> torch.Tensor:
        if self._replay is None:
            return self._save(x, keep)
        if not keep:
            return x
        payload = self.saved[self._replay]
        self._replay += 1
        if self.mode == "compress8":
            value = _dequantize(*payload, x.shape, x.dtype)
        elif self.mode == "compress16":
            value = payload.to(x.dtype)
        else:
            value = self.io.swap_in(payload)
        return _Use.apply(value, x)

    def _save(self, x: torch.Tensor, keep: bool) -> torch.Tensor:
        if self.mode == "swap":
            if keep:
                self.saved.append(self.io.swap_out(x))
            return x
        value, payload = _compressed(x, self.mode)
        if self.mode == "compress8":
            self.io.quantized.inc()
        if keep:
            self.saved.append(payload)
        return value


def save_act(x: torch.Tensor, sites: ActSites | None = None, keep: bool = True):
    """A save site (``model.py:261-266``): through the run's ``sites`` when
    it has them (``keep``: the backward reads this one), else unchanged."""
    return x if sites is None else sites(x, keep)


def apply_position(pparams: dict, x: torch.Tensor, cfg: ModelConfig, pos_j: int, *,
                   positions=None, memory: torch.Tensor | None = None,
                   attn_impl: str = "blockwise", sites: ActSites | None = None,
                   tp=None, route=None) -> XAux:
    """One layer (superblock position): norm, the mixer (attention or
    Mamba-2), residual, with ``memory`` norm, cross-attention over it and
    residual, then norm, MLP or MoE (if the position has one), residual,
    with a save site at each output (``save_act``); the backward reads all
    but the last (the MLP or MoE output only feeds the residual add).
    Returns (x, aux): the MoE's aux loss, 0.0 without one. ``tp``: the
    model axis's split of each sublayer (``x`` this rank's rows under
    sequence parallelism, as the reference's ``enter`` / ``bsd`` sites lay
    them out, the norms on those rows). ``route``: the MoE's batch group."""
    aux = 0.0
    norm = (lambda p: p) if tp is None else tp.norm_params  # noqa: E731
    h = save_act(L.apply_norm(norm(pparams["norm1"]), x, cfg.norm), sites)
    if "attn" in pparams:
        mix = L.attention_block(pparams["attn"], h, cfg, positions=positions, impl=attn_impl,
                                tp=tp)
    else:
        mix = M2.apply_mamba2(pparams["mamba"], h, cfg, tp=tp)
    x = x + save_act(mix, sites)
    if memory is not None and "xattn" in pparams:
        hx = L.apply_norm(norm(pparams["norm_x"]), x, cfg.norm)
        x = x + save_act(L.cross_attention_block(pparams["xattn"], hx, memory, cfg,
                                                 impl=attn_impl, tp=tp), sites)
    if "moe" in pparams:
        h2 = L.apply_norm(norm(pparams["norm2"]), x, cfg.norm)
        out, aux = MOE.apply_moe(pparams["moe"], h2, cfg, tp=tp, route=route)
        x = x + save_act(out, sites, keep=False)
    elif "mlp" in pparams:
        h2 = L.apply_norm(norm(pparams["norm2"]), x, cfg.norm)
        x = x + save_act(L.apply_mlp(pparams["mlp"], h2, cfg.mlp, tp, cfg.d_ff), sites,
                         keep=False)
    return x, aux


def _checkpointed(fn, *args):
    # the layers draw no random numbers: no RNG state to keep for the replay
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def _weights(src: dict, proxies: dict | None, io: HostIO) -> dict:
    """A position's (or repeat's) weights on the device: ``src`` itself, or
    the fetched copy of host weights ``src`` with gradients to ``proxies``."""
    return src if proxies is None else io.fetch(proxies, src)


def _apply_layer(src, proxies, x, memory, cfg, pos_j, *, act_policy: str, buffered: bool,
                 io: HostIO, attn_impl: str, wio=None, tp=None, route=None) -> XAux:
    """One position under its run's act policy and weight buffering:
    (x, aux). ``wio``: where the weights come from (default ``io``)."""
    wio = wio if wio is not None else io
    fetch_again = proxies is not None and not buffered
    if act_policy == "none":
        pp = _weights(src, proxies, wio)
        if not fetch_again:
            return apply_position(pp, x, cfg, pos_j, memory=memory, attn_impl=attn_impl,
                                  tp=tp, route=route)
        with wio.refetch_saved(pp, src):
            return apply_position(pp, x, cfg, pos_j, memory=memory, attn_impl=attn_impl,
                                  tp=tp, route=route)
    sites = ActSites(act_policy, io) if act_policy in SITE_POLICIES else None
    # kept weights are fetched outside the recomputed region; the others
    # inside it, so the replay fetches them again
    if fetch_again:
        wio.will_fetch_again(src)
    kept = None if fetch_again else _weights(src, proxies, wio)

    def one(x, memory):
        if sites is not None:
            sites.begin()
        pp = _weights(src, proxies, wio) if fetch_again else kept
        return apply_position(pp, x, cfg, pos_j, memory=memory, attn_impl=attn_impl,
                              sites=sites, tp=tp, route=route)

    out = _checkpointed(one, x, memory)
    if sites is not None:
        sites.seal()
    return out


def apply_superblock(block_params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     memory: torch.Tensor | None = None, act_policy: str = "none",
                     buffered: bool = True, proxies: dict | None = None,
                     io: HostIO | None = None, attn_impl: str = "blockwise",
                     wio=None, tp=None, route=None) -> XAux:
    """block_params: {posJ: params of one repeat}, on the device or (with
    ``proxies``, the autograd stand-ins of the same tree) in host memory.
    ``act_policy`` applies per position (layer), the paper's per-block
    granularity; ``memory``: the encoder's output an encoder-decoder's
    positions attend over (None: no cross-attention, as the profile traces
    a block). ``wio``: the weights' source when it is not ``io`` (a ZeRO-3
    run's ``dist.collectives.LazyGather``). ``tp``: the model axis
    (``dist.tensor_parallel``); ``route``: the MoE's batch group. Returns
    (x, aux), aux summed over the positions."""
    aux = 0.0
    for j in range(superblock_period(cfg)):
        key = f"pos{j}"
        x, a = _apply_layer(block_params[key], None if proxies is None else proxies[key], x,
                            memory, cfg, j, act_policy=act_policy, buffered=buffered, io=io,
                            attn_impl=attn_impl, wio=wio, tp=tp, route=route)
        aux = aux + a
    return x, aux


@dataclasses.dataclass
class Run:
    """A contiguous range of superblock repeats sharing one policy."""

    params: dict  # stacked over this run's repeats, on the device or in host memory
    n_repeats: int
    act_policy: str = "none"  # none | checkpoint | swap | compress8 | compress16
    ckpt_group: int = 1  # remat region size in superblock repeats (checkpoint only)
    buffered: bool = True  # fetched weights kept FWD->BWD (else fetched again)
    proxies: dict | None = None  # fetched weights: their autograd stand-ins, stacked
    # where fetched weights come from when not the step's HostIO: a
    # gathered run's LazyGather (dist/collectives.py), with ``proxies`` its
    # shards, or their device proxies for shards in host memory
    io: Any = None
    # fetch the next unit's weights during this one: always for host
    # weights; the all-gathers of a gathered run when both units' runs set
    # it (a buffered ``none`` zero3 run, gather_prefetch_depth == 2)
    prefetch: bool = False


def _unstack(tree, n: int) -> list:
    """A stacked (n, ...) tree -> n per-repeat trees of views (``unbind``)."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    per = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: per[k][i] for k in per} for i in range(n)]


def _units(runs: list[Run]) -> list[tuple[Run, list, list]]:
    """The layer stack in forward order as (run, repeat params, repeat
    proxies) units: one repeat each, or one remat group of ``ckpt_group``."""
    units = []
    for run in runs:
        check_act_policy(run.act_policy)
        g = run.ckpt_group if run.act_policy == "checkpoint" else 1
        g = max(1, min(g, run.n_repeats))
        while run.n_repeats % g:
            g -= 1  # group must tile the run
        reps = _unstack(run.params, run.n_repeats)
        prox = ([None] * run.n_repeats if run.proxies is None
                else _unstack(run.proxies, run.n_repeats))
        units += [(run, reps[i:i + g], prox[i:i + g]) for i in range(0, run.n_repeats, g)]
    return units


def apply_runs(runs: list[Run], x: torch.Tensor, cfg: ModelConfig, *,
               memory: torch.Tensor | None = None, attn_impl: str = "blockwise",
               io: HostIO | None = None, tp=None, route=None) -> XAux:
    """Execute the layer stack as policy runs of superblocks: (x, aux), the
    aux losses summed. ``memory``: the encoder's output (encoder-decoders).
    ``io``: the step's host copies and counters (a fresh one on x's device
    if None)."""
    units = _units(runs)
    io = io if io is not None else HostIO(x.device)
    aux_total = 0.0
    for i, (run, reps, prox) in enumerate(units):
        io.begin_unit()
        wio = run.io if run.io is not None else io
        nxt = units[i + 1][0] if i + 1 < len(units) else None
        if nxt is not None and nxt.proxies is not None:
            for src in units[i + 1][1]:  # the next unit's weights, during this one
                if nxt.io is None:
                    io.prefetch(src)
                else:  # host shards' copies always; device gathers when both runs say so
                    nxt.io.prefetch(src, gather=run.prefetch and nxt.prefetch)
        if len(reps) == 1:
            x, aux = apply_superblock(reps[0], x, cfg, memory=memory,
                                      act_policy=run.act_policy, buffered=run.buffered,
                                      proxies=prox[0], io=io, attn_impl=attn_impl, wio=wio,
                                      tp=tp, route=route)
            aux_total = aux_total + aux
            continue
        # grouped remat: one checkpoint region spans the group's superblocks;
        # unbuffered fetched weights are fetched inside it, the rest outside
        kept = [None if px is not None and not run.buffered else _weights(src, px, wio)
                for src, px in zip(reps, prox)]
        for src, pp in zip(reps, kept):
            if pp is None:
                wio.will_fetch_again(src)

        def region(x, memory, _items=list(zip(reps, prox, kept))):
            aux = 0.0
            for src, px, pp in _items:
                pp = pp if pp is not None else _weights(src, px, wio)
                x, a = apply_superblock(pp, x, cfg, memory=memory, attn_impl=attn_impl, tp=tp,
                                        route=route)
                aux = aux + a
            return x, aux

        x, aux = _checkpointed(region, x, memory)
        aux_total = aux_total + aux
    return x, aux_total


def default_runs(cfg: ModelConfig, params: dict) -> list[Run]:
    """Single fully-resident run (no remat): the small-model default."""
    return [Run(params=params["blocks"], n_repeats=num_repeats(cfg))]


def _encoder_layer(pp: dict, x: torch.Tensor, cfg: ModelConfig,
                   attn_impl: str = "blockwise", tp=None) -> torch.Tensor:
    """One encoder layer (``encode``'s scan body, model.py:643-658): norm,
    non-causal self-attention with RoPE, residual, norm, MLP, residual.
    ``tp``: both sublayers column / row split (``x`` the boundary's layout)."""
    norm = (lambda p: p) if tp is None else tp.norm_params  # noqa: E731
    h = L.attn_enter(L.apply_norm(norm(pp["norm1"]), x, cfg.norm), cfg, tp)
    b, s, _ = h.shape
    q, k, v = L.qkv(pp["attn"], h, h, cfg, tp)
    pos = torch.arange(s, device=x.device)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    x = x + L.attn_exit(pp["attn"], L.full_attention(q, k, v, attn_impl).reshape(b, s, -1),
                        cfg, tp)
    h2 = L.apply_norm(norm(pp["norm2"]), x, cfg.norm)
    return x + L.apply_mlp(pp["mlp"], h2, cfg.mlp, tp, cfg.d_ff)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig, *,
           attn_impl: str = "blockwise", tp=None) -> torch.Tensor:
    """The encoder stack over precomputed frontend embeddings (B, S_src, D)
    (model.py:637-663): every layer keeps only its input and is recomputed
    in the backward, collectives and all, then the encoder's final norm.
    ``tp``: the output in the block boundary's layout (this rank's rows of
    ``S_src`` under sequence parallelism)."""
    enc = params["encoder"]
    x = frames if tp is None else tp.exit(frames, partial=False)
    for pp in _unstack(enc["blocks"], cfg.encoder_layers):
        if torch.is_grad_enabled():
            x = _checkpointed(_encoder_layer, pp, x, cfg, attn_impl, tp)
        else:
            x = _encoder_layer(pp, x, cfg, attn_impl, tp)
    norm = enc["final_norm"] if tp is None else tp.norm_params(enc["final_norm"])
    return L.apply_norm(norm, x, cfg.norm)


def forward(params: dict, batch: dict, cfg: ModelConfig, *, runs: list[Run] | None = None,
            attn_impl: str = "blockwise", io: HostIO | None = None, tp=None,
            route=None) -> XAux:
    """Training and prefill forward. ``batch["tokens"]``: (B, S) integer; an
    encoder-decoder's ``batch["frames"]``: (B, S_src, D) in the model's
    dtype; a vision-language model's ``batch["patches"]`` (B, P, D), if
    present, run ahead of the tokens. Returns the hidden states of the
    tokens (B, S, D) and the aux loss: the MoE layers' load-balance losses
    summed, an fp32 scalar (0.0 for a dense model, where JAX returns a zero
    array). ``io``: the host copies of runs with host weights and of
    swapped activations. ``tp``: the model axis (``dist.tensor_parallel``):
    the hidden states of the tokens come back in the block boundary's
    layout, this rank's rows under sequence parallelism, which must then
    split the tokens, the patches and tokens, and the frames alike
    (``boundary_lengths``). ``route``: the MoE layers' batch group."""
    check_family(cfg)
    patches = batch.get("patches") if cfg.frontend == "vision_patches" else None
    seq = tp is not None and tp.seq
    if patches is None:
        x = embed_tokens(params, batch["tokens"], cfg, tp)
    else:  # under sequence sharding the boundary splits the P + S positions
        x = embed_tokens(params, batch["tokens"], cfg,
                         dataclasses.replace(tp, seq=False) if seq else tp)
        x = torch.cat([patches.detach().to(x.dtype), x], dim=1)
        if seq:
            x = tp.exit(x, partial=False)
    memory = None
    if cfg.kind == "encdec":
        memory = encode(params, batch["frames"], cfg, attn_impl=attn_impl, tp=tp)
        if tp is not None:  # whole on every rank, entered as the cross-attentions use it:
            # their parts summed where the heads split, one rank's whole
            # gradient where the sublayer runs replicated
            memory = tp.enter(memory, L.heads_split(cfg, tp))
    if runs is None:
        runs = default_runs(cfg, params)
    x, aux = apply_runs(runs, x, cfg, memory=memory, attn_impl=attn_impl, io=io, tp=tp,
                        route=route)
    if patches is not None:
        p = patches.shape[1]
        if seq:  # this rank's rows of the tokens
            return tp.split(tp.gather(x, 1)[:, p:], 1), aux
        x = x[:, p:].contiguous()  # the kernels take whole rows
    return x, aux
