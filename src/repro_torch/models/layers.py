"""Transformer layers for decoding: norms, RoPE, attention and MLP params.

Port of ``src/repro/models/layers.py`` (``:27-113`` and ``:293-385``). Layers
are plain functions of a parameter dict and tensors; parameter *definitions*
(shape, init, axis tags) sit beside them. RMSNorm runs through the port's
kernels package (the CUDA kernel on CUDA tensors, its plain version on CPU
tensors). The blockwise training attention (``_mea``) comes with the
training slice.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import fused_rmsnorm

# Sharding axis tags, kept so the definitions read like the JAX package's.
LAYER = "layer"  # stacked-layer leading axis
ZERO = "zero"  # ZeRO-shardable dim
TP = "tp"  # tensor-parallel dim
NONE = "none"  # never sharded

NEG_INF = -1e30

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float | None = None  # stddev; None -> 1/sqrt(fan_in)
    dtype: str = "bfloat16"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    def initialize(self, generator: torch.Generator, device) -> torch.Tensor:
        dt = torch_dtype(self.dtype)
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dt, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dt, device=device)
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        std = self.scale if self.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
        return x.mul_(std).to(dt)


def map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef of a nested dict, keys in sorted order
    (the order ``jax.tree`` flattens dicts in)."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    return {k: map_defs(fn, defs[k]) for k in sorted(defs)}


def init_tree(defs, generator: torch.Generator, device):
    """Initialise a nested dict of ParamDefs from one generator."""
    return map_defs(lambda d: d.initialize(generator, device), defs)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The Pallas kernel's rounding order: ``dtype(x * rsqrt(ms + eps)) * scale``."""
    return fused_rmsnorm(x, scale, eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1) / d
    ms = (xf * xf).sum(-1) / d
    var = ms - mu * mu
    rs = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    mu = mu[..., None].to(x.dtype)
    return (x - mu) * rs * scale + bias


def norm_defs(d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ParamDef((d,), (NONE,), init="ones")}
    return {
        "scale": ParamDef((d,), (NONE,), init="ones"),
        "bias": ParamDef((d,), (NONE,), init="zeros"),
    }


def apply_norm(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    return layernorm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# RoPE (fp32, as layers.py:104-113)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (hd/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention and MLP parameters
# ---------------------------------------------------------------------------
def attention_defs(cfg) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
    return {
        "wq": ParamDef((d, nq), (ZERO, TP)),
        "wk": ParamDef((d, nkv), (ZERO, TP)),
        "wv": ParamDef((d, nkv), (ZERO, TP)),
        "wo": ParamDef((nq, d), (TP, ZERO)),
    }


def mlp_defs(cfg, d_ff: int | None = None) -> dict:
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp in ("swiglu", "geglu"):
        return {
            "w1": ParamDef((d, ff), (ZERO, TP)),
            "w3": ParamDef((d, ff), (ZERO, TP)),
            "w2": ParamDef((ff, d), (TP, ZERO)),
        }
    return {
        "w1": ParamDef((d, ff), (ZERO, TP)),
        "w2": ParamDef((ff, d), (TP, ZERO)),
    }


def apply_mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    h = x @ params["w1"]
    if kind == "swiglu":
        h = F.silu(h) * (x @ params["w3"])
    elif kind == "geglu":
        h = F.gelu(h, approximate="tanh") * (x @ params["w3"])
    elif kind == "gelu":
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu defaults to the tanh form
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return h @ params["w2"]
