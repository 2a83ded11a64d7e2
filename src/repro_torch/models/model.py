"""Model assembly for the dense decoder: parameter tree, embedding, LM head.

Port of the dense part of ``src/repro/models/model.py``. Parameters keep the
JAX package's tree: ``{"embed": {"tok"}, "blocks": {"pos<j>": {...}},
"final_norm": {...}, "head": {"w"}}``, each block leaf stacked over
superblock repeats, ``(R, ...)``. ``DecoderLM`` holds that tree as an
``nn.Module`` whose parameter names are the tree paths joined by ``.``
(``blocks.pos0.attn.wq``, shape ``(R, d, nq)``).

MoE, Mamba-2 and encoder-decoder positions are queued in ROADMAP.md and raise
``NotImplementedError`` here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import LAYER, TP, ZERO, ParamDef

_FAMILIES_TODO = "ROADMAP.md, port queue: the MoE, Mamba-2 and encoder-decoder families"


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


def _to_module(tree: dict) -> nn.Module:
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in tree.items()})
    return nn.ModuleDict({k: _to_module(v) for k, v in tree.items()})


def _from_module(mod: nn.Module) -> dict:
    if isinstance(mod, nn.ParameterDict):
        return {k: v for k, v in mod.items()}
    return {k: _from_module(v) for k, v in mod.items()}


class DecoderLM(nn.Module):
    """The dense decoder's parameters as a module (serving: no gradients).

    ``DecoderLM(cfg, params)`` wraps an existing tree without copying;
    ``DecoderLM.init(cfg, generator, device)`` draws a random one.
    ``tree()`` gives the nested dict the functional decode path takes.
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
