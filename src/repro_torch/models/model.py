"""Model assembly for the dense decoder: parameter tree, superblocks, runs,
the training forward, embedding and LM head.

Port of the dense part of ``src/repro/models/model.py``. Parameters keep the
JAX package's tree: ``{"embed": {"tok"}, "blocks": {"pos<j>": {...}},
"final_norm": {...}, "head": {"w"}}``, each block leaf stacked over
superblock repeats, ``(R, ...)``; the training state splits ``blocks`` into
``"runs": [...]``, one stacked subtree per run of the plan
(``train/step_builder.py``). ``DecoderLM`` holds such a tree as an
``nn.Module`` whose parameter names are the tree paths joined by ``.``
(``blocks.pos0.attn.wq``, shape ``(R, d, nq)``).

The layer stack runs as a list of ``Run``s (``apply_runs``). JAX scans each
run over its stacked leaves; here a Python loop walks the leaves' first axis
(``unbind``, so the backward stacks the per-repeat gradients in one copy).
Act policy ``"none"`` keeps every activation; ``"checkpoint"`` recomputes
each layer position in the backward (``torch.utils.checkpoint`` without
reentrancy), or each region of ``ckpt_group`` superblocks. The other
policies (``swap``, ``compress8``, ``compress16``) raise
``NotImplementedError``: ROADMAP.md, port queue.

MoE, Mamba-2 and encoder-decoder positions are queued in ROADMAP.md and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import LAYER, TP, ZERO, ParamDef

_FAMILIES_TODO = "ROADMAP.md, port queue: the MoE, Mamba-2 and encoder-decoder families"
_SWAP_TODO = "ROADMAP.md, port queue 1: host weight fetch with n_buffer, and the swap policy"
_COMPRESS_TODO = "ROADMAP.md, port queue 3: activation compression with fused_quantize_ef"
ACT_POLICIES = ("none", "checkpoint")


def superblock_period(cfg: ModelConfig) -> int:
    p = len(cfg.mixer_pattern)
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    return p


def num_repeats(cfg: ModelConfig) -> int:
    p = superblock_period(cfg)
    assert cfg.num_layers % p == 0, (cfg.name, cfg.num_layers, p)
    return cfg.num_layers // p


def check_dense(cfg: ModelConfig) -> None:
    """Raise for the families this slice does not run."""
    if cfg.kind == "encdec":
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models ({_FAMILIES_TODO})")
    if any(m != "attention" for m in cfg.mixer_pattern):
        raise NotImplementedError(f"{cfg.name}: Mamba-2 positions ({_FAMILIES_TODO})")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE positions ({_FAMILIES_TODO})")


def _position_defs(cfg: ModelConfig, pos: int) -> dict:
    """ParamDefs for one layer position within the superblock."""
    defs: dict[str, Any] = {"norm1": L.norm_defs(cfg.d_model, cfg.norm),
                            "attn": L.attention_defs(cfg)}
    if cfg.d_ff:
        defs["norm2"] = L.norm_defs(cfg.d_model, cfg.norm)
        defs["mlp"] = L.mlp_defs(cfg)
    return defs


def _stack_defs(defs, n: int):
    """Prepend a stacked LAYER axis of size n to every ParamDef."""
    return L.map_defs(
        lambda d: ParamDef((n,) + d.shape, (LAYER,) + d.axes, init=d.init,
                           scale=d.scale, dtype=d.dtype), defs)


def param_defs(cfg: ModelConfig) -> dict:
    """Full parameter ParamDef tree of the dense decoder."""
    check_dense(cfg)
    p = superblock_period(cfg)
    r = num_repeats(cfg)
    defs: dict[str, Any] = {
        "embed": {"tok": ParamDef((cfg.vocab_size, cfg.d_model), (TP, ZERO), scale=0.02)},
        "blocks": {f"pos{j}": _stack_defs(_position_defs(cfg, j), r) for j in range(p)},
        "final_norm": L.norm_defs(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        defs["head"] = {"w": ParamDef((cfg.d_model, cfg.vocab_size), (ZERO, TP), scale=0.02)}
    if cfg.dtype != "bfloat16":
        defs = L.map_defs(
            lambda d: dataclasses.replace(d, dtype=cfg.dtype) if d.dtype == "bfloat16" else d,
            defs)
    return defs


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> dict:
    """Random parameters from ``generator`` (which must live on ``device``)."""
    return L.init_tree(param_defs(cfg), generator, device)


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"]["tok"][tokens]


def lm_head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["head"]["w"]
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
    """The dense decoder's parameters as a module, for serving (no gradients).

    ``DecoderLM(cfg, params)`` wraps an existing tree without copying;
    ``DecoderLM.init(cfg, generator, device)`` draws a random one. ``tree()``
    gives the nested dict the functional paths take.
    """

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        check_dense(cfg)
        self.cfg = cfg
        for name, sub in params.items():
            self.add_module(name, _to_module(sub))

    @classmethod
    def init(cls, cfg: ModelConfig, generator: torch.Generator, device) -> "DecoderLM":
        return cls(cfg, init_params(cfg, generator, device))

    def tree(self) -> dict:
        return {name: _from_module(mod) for name, mod in self.named_children()}


# ---------------------------------------------------------------------------
# Training forward (model.py:297-375, 454-560, 665-688)
# ---------------------------------------------------------------------------
def check_act_policy(policy: str) -> None:
    """Raise ``NotImplementedError`` (naming the ROADMAP item) for an act
    policy this port does not run."""
    if policy not in ACT_POLICIES:
        todo = _SWAP_TODO if policy == "swap" else _COMPRESS_TODO
        raise NotImplementedError(f"act policy {policy!r} ({todo})")


def apply_position(pparams: dict, x: torch.Tensor, cfg: ModelConfig, pos_j: int, *,
                   positions=None, attn_impl: str = "blockwise") -> torch.Tensor:
    """One layer (superblock position): norm, attention, residual, norm, MLP,
    residual."""
    h = L.apply_norm(pparams["norm1"], x, cfg.norm)
    x = x + L.attention_block(pparams["attn"], h, cfg, positions=positions, impl=attn_impl)
    if "mlp" in pparams:
        h2 = L.apply_norm(pparams["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(pparams["mlp"], h2, cfg.mlp)
    return x


def _checkpointed(fn, *args):
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def apply_superblock(block_params: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     remat: bool = False, **kw) -> torch.Tensor:
    """block_params: {posJ: params of one repeat}. ``remat`` recomputes each
    position (layer) in the backward, the paper's per-block granularity."""
    for j in range(superblock_period(cfg)):
        def one(x, _j=j):
            return apply_position(block_params[f"pos{_j}"], x, cfg, _j, **kw)

        x = _checkpointed(one, x) if remat else one(x)
    return x


@dataclasses.dataclass
class Run:
    """A contiguous range of superblock repeats sharing one policy."""

    params: dict  # stacked over this run's repeats
    n_repeats: int
    act_policy: str = "none"  # none | checkpoint (swap / compress: not ported)
    ckpt_group: int = 1  # remat region size in superblock repeats


def _unstack(tree, n: int) -> list:
    """A stacked (n, ...) tree -> n per-repeat trees of views (``unbind``)."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    per = {k: _unstack(v, n) for k, v in tree.items()}
    return [{k: per[k][i] for k in per} for i in range(n)]


def apply_runs(runs: list[Run], x: torch.Tensor, cfg: ModelConfig, *,
               attn_impl: str = "blockwise") -> torch.Tensor:
    """Execute the layer stack as policy runs of superblocks."""
    for run in runs:
        check_act_policy(run.act_policy)
        g = run.ckpt_group if run.act_policy == "checkpoint" else 1
        g = max(1, min(g, run.n_repeats))
        while run.n_repeats % g:
            g -= 1  # group must tile the run
        reps = _unstack(run.params, run.n_repeats)
        if g == 1:
            remat = run.act_policy == "checkpoint"
            for bp in reps:
                x = apply_superblock(bp, x, cfg, remat=remat, attn_impl=attn_impl)
            continue
        # grouped remat: one checkpoint region spans g superblocks
        for start in range(0, run.n_repeats, g):
            def region(x, _bps=reps[start:start + g]):
                for bp in _bps:
                    x = apply_superblock(bp, x, cfg, attn_impl=attn_impl)
                return x

            x = _checkpointed(region, x)
    return x


def default_runs(cfg: ModelConfig, params: dict) -> list[Run]:
    """Single fully-resident run (no remat): the small-model default."""
    return [Run(params=params["blocks"], n_repeats=num_repeats(cfg))]


def forward(params: dict, batch: dict, cfg: ModelConfig, *, runs: list[Run] | None = None,
            attn_impl: str = "blockwise") -> torch.Tensor:
    """Training forward. ``batch["tokens"]``: (B, S) integer. Returns the
    hidden states (B, S, D); a dense model has no aux loss (JAX returns a
    zero one beside them)."""
    check_dense(cfg)
    x = embed_tokens(params, batch["tokens"], cfg)
    if runs is None:
        runs = default_runs(cfg, params)
    return apply_runs(runs, x, cfg, attn_impl=attn_impl)
