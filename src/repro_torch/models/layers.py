"""Transformer layers: norms, RoPE, self- and cross-attention and the MLP.

Port of ``src/repro/models/layers.py`` (``:27-385``).
Layers are plain functions of a parameter dict and tensors; parameter
*definitions* (shape, init, axis tags) sit beside them. RMSNorm runs
through the port's kernels package (the CUDA kernel on CUDA tensors, its
plain version on CPU tensors), with a gradient when one is needed. The
training attention is ``blockwise_attention``: on CUDA tensors its forward
and backward are the FlashAttention kernels; on CPU tensors they are the
plain block loops of ``_mea_forward`` / ``_mea_bwd``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch import kernels as K
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


# Largest fp32 draw of one leaf: llava-next-34b's stacked MLP leaves (60 x
# 7168 x 20480, 35.2 GB in fp32) are drawn a layer at a time, so its 68.8 GB
# of bf16 weights are drawn on an 80 GB card; every smaller leaf (17.2 GB
# and under, qwen2-moe-a2.7b's expert stacks among them) in one draw.
MAX_FP32_DRAW_BYTES = 16 << 30


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
        if 4 * math.prod(self.shape) <= MAX_FP32_DRAW_BYTES or dt == torch.float32:
            x = torch.randn(self.shape, generator=generator, dtype=torch.float32, device=device)
            return x.mul_(std).to(dt)
        # a leaf whose fp32 draw outgrows the bound: drawn slice by slice of
        # its first (stacked) axis into the weights' own dtype
        out = torch.empty(self.shape, dtype=dt, device=device)
        for part in out:
            x = torch.randn(part.shape, generator=generator, dtype=torch.float32, device=device)
            part.copy_(x.mul_(std))
        return out


def broadcast_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a * b``, broadcast: a product with no contracted axis, which the
    reference writes inside an einsum and so emits as a ``dot_general``
    (``core/profiler.profile_fn`` counts it as that dot)."""
    return a * b


@contextlib.contextmanager
def scan_iteration(i: int):
    """Iteration ``i`` of a Python loop the reference writes as one
    ``lax.scan`` body (``_mea_forward``'s loop over KV blocks). Nothing
    here: while ``core/profiler.profile_fn`` records, it counts the
    residuals such a loop makes once, as the reference walks a scan body
    once."""
    yield


def map_defs(fn, defs):
    """Apply ``fn`` to every ParamDef of a nested dict (or list), keys in
    sorted order (the order ``jax.tree`` flattens dicts in)."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, list):
        return [map_defs(fn, d) for d in defs]
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
# Attention (layers.py:122-329)
# ---------------------------------------------------------------------------
def naive_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0):
    """Reference attention. q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd). GQA
    broadcast; fp32 softmax, probs cast to v's dtype before P.V."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    qh = q.reshape(b, sq, hkv, groups, hd)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float())
    logits = logits * (1.0 / math.sqrt(hd))
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    logits = torch.where(mask, logits, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, hd)


def _attn_bias(sq, block_kv, blk_idx, sk, causal, window, q_offset, device):
    """Additive (sq, block_kv) fp32 bias: 0 where attendable, NEG_INF where masked."""
    kpos = blk_idx * block_kv + torch.arange(block_kv, device=device)
    qpos = torch.arange(sq, device=device) + q_offset
    mask = (kpos[None, :] < sk) & torch.ones(sq, 1, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return torch.where(mask, 0.0, NEG_INF).float()


def _mm32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation (``preferred_element_type=float32``):
    the inputs keep their values, widened to fp32."""
    return torch.einsum(eq, a.float(), b.float())


def _mea_forward(q, k, v, sk, causal, window, q_offset, block_kv):
    """Online-softmax forward over KV blocks. q: (B, Sq, Hkv, G, hd); k, v
    padded to a multiple of ``block_kv``. Returns (out fp32, lse fp32)."""
    b, sq, hkv, g, hd = q.shape
    nblk = k.shape[1] // block_kv
    scale = 1.0 / math.sqrt(hd)
    acc = torch.zeros(b, sq, hkv, g, hd, dtype=torch.float32, device=q.device)
    m = torch.full((b, sq, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros(b, sq, hkv, g, dtype=torch.float32, device=q.device)
    for j in range(nblk):
        with scan_iteration(j):
            kblk = k[:, j * block_kv:(j + 1) * block_kv]
            vblk = v[:, j * block_kv:(j + 1) * block_kv]
            logits = _mm32("bqkgd,bskd->bqkgs", q, kblk) * scale
            bias = _attn_bias(sq, block_kv, j, sk, causal, window, q_offset, q.device)
            logits = logits + bias[None, :, None, None, :]
            m_new = torch.maximum(m, logits.amax(dim=-1))
            scale_old = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            denom = denom * scale_old + p.sum(dim=-1)
            acc = acc * scale_old[..., None] + _mm32("bqkgs,bskd->bqkgd", p.to(vblk.dtype),
                                                     vblk)
            m = m_new
    denom = denom.clamp_min(1e-30)
    return acc / denom[..., None], m + torch.log(denom)


def _mea_bwd(q, k, v, out, lse, dout, sk, causal, window, q_offset, block_kv):
    """FlashAttention-style backward: p recomputed per KV block from lse."""
    b, sq, hkv, g, hd = q.shape
    nblk = k.shape[1] // block_kv
    scale = 1.0 / math.sqrt(hd)
    delta = (dout.float() * out.float()).sum(dim=-1)  # (b, sq, hkv, g)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for j in range(nblk):
        kblk = k[:, j * block_kv:(j + 1) * block_kv]
        vblk = v[:, j * block_kv:(j + 1) * block_kv]
        logits = _mm32("bqkgd,bskd->bqkgs", q, kblk) * scale
        bias = _attn_bias(sq, block_kv, j, sk, causal, window, q_offset, q.device)
        logits = logits + bias[None, :, None, None, :]
        p = torch.exp(logits - lse[..., None])
        dvs.append(_mm32("bqkgs,bqkgd->bskd", p.to(dout.dtype), dout))
        dp = _mm32("bqkgd,bskd->bqkgs", dout, vblk)
        dsd = (p * (dp - delta[..., None]) * scale).to(q.dtype)
        dq = dq + _mm32("bqkgs,bskd->bqkgd", dsd, kblk)
        dks.append(_mm32("bqkgs,bqkgd->bskd", dsd, q))
    dk = torch.cat(dks, dim=1).to(k.dtype)
    dv = torch.cat(dvs, dim=1).to(v.dtype)
    return dq.to(q.dtype), dk, dv


class _MEA(torch.autograd.Function):
    """``_mea`` (layers.py:209-259). q: (B, Sq, Hkv, G, hd). On CUDA the
    FlashAttention kernels (unpadded k, v; the kernel masks the edge); on
    the CPU the block loops over k, v padded to ``block_kv``. The
    log-sum-exp is an output (non-differentiable), so a recomputing
    checkpoint sees it as the forward's own result."""

    @staticmethod
    def forward(ctx, q, k, v, sk, causal, window, q_offset, block_kv):
        ctx.args = (sk, causal, window, q_offset, block_kv)
        if q.device.type == "cuda":
            b, sq, hkv, g, hd = q.shape
            out, lse = K.flash_attention(q.reshape(b, sq, hkv * g, hd), k, v, causal=causal,
                                         window=window, q_offset=q_offset, block_kv=block_kv)
            out = out.reshape(q.shape)
        else:
            out, lse = _mea_forward(q, k, v, sk, causal, window, q_offset, block_kv)
            out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        sk, causal, window, q_offset, block_kv = ctx.args
        if q.device.type == "cuda":
            b, sq, hkv, g, hd = q.shape
            flat = lambda t: t.reshape(b, sq, hkv * g, hd)  # noqa: E731
            dq, dk, dv = K.flash_attention_bwd(flat(q), k, v, flat(out), lse,
                                               flat(dout.contiguous()), causal=causal,
                                               window=window, q_offset=q_offset)
            dq = dq.reshape(q.shape)
        else:
            dq, dk, dv = _mea_bwd(q, k, v, out, lse, dout, sk, causal, window, q_offset,
                                  block_kv)
        return dq, dk, dv, None, None, None, None, None


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                        block_kv: int = 1024):
    """Memory-efficient online-softmax attention with a FlashAttention-style
    backward (layers.py:262-290). q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd)."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    block_kv = min(block_kv, max(128, sk))
    if q.device.type != "cuda" and sk % block_kv:
        pad = block_kv - sk % block_kv
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qh = q.reshape(b, sq, hkv, groups, hd)
    out, _ = _MEA.apply(qh, k, v, sk, causal, window, q_offset, block_kv)
    return out.reshape(b, sq, hq, hd)


def _attend(q, k, v, cfg, positions, impl: str, block_kv: int) -> torch.Tensor:
    """RoPE on q (B, S, Hq, hd) and k (B, S, Hkv, hd), then causal
    attention with the config's window: (B, S, Hq, hd)."""
    s = q.shape[1]
    if positions is None:
        positions = torch.arange(s, device=q.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=True, window=cfg.sliding_window,
                                   block_kv=min(block_kv, max(s, 128)))
    if impl == "naive":
        return naive_attention(q, k, v, causal=True, window=cfg.sliding_window)
    raise ValueError(f"attention impl {impl!r}: 'blockwise' or 'naive'")


def heads_split(cfg, tp) -> bool:
    """Whether attention splits its heads over ``tp``'s ranks: whole query
    heads a rank, each rank's query heads reading whole KV heads of their
    own -- those heads alone, or one KV head that several ranks read (fewer
    KV heads than ranks). Elsewhere -- the extent does not divide the query
    heads, or a rank's query heads straddle their KV heads -- the sublayer
    runs replicated: every rank takes its weights whole at use
    (``TensorParallel.replicated``) and computes every head, the function
    the reference's partitioned program computes there. False without
    ``tp``."""
    if tp is None:
        return False
    h, hkv, t = cfg.num_heads, cfg.num_kv_heads, tp.size
    if h % t:
        return False
    hl, g = h // t, h // hkv
    return not (hkv % t and g % hl)


def tp_heads(cfg, tp) -> tuple[int, int, int]:
    """(this rank's first query head, its query heads, its first KV head)
    where the heads split over ``tp.size`` model ranks (``heads_split``)."""
    hl = cfg.num_heads // tp.size
    q0 = tp.rank * hl
    return q0, hl, q0 // (cfg.num_heads // cfg.num_kv_heads)


def rank_kv_heads(cfg, tp) -> int:
    """The KV heads a rank's attention computes, and its decode cache holds:
    all of them without ``tp`` or where the sublayer runs replicated; its
    share where the heads split, or the one KV head its query heads read
    when ranks outnumber the KV heads (each such rank keeps that head's
    whole cache)."""
    if not heads_split(cfg, tp):
        return cfg.num_kv_heads
    return max(1, cfg.num_kv_heads // tp.size)


def kv_weights(params: dict, cfg, tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(wk, wv) of this rank's KV heads, (..., D, heads * hd): the column
    shards where the KV heads split whole, else the whole weights
    (``whole_weight``) and the columns of this rank's one KV head; the whole
    weights where the sublayer runs replicated. Leaves may be stacked over
    repeats."""
    if tp is None:
        return params["wk"], params["wv"]
    hd = cfg.resolved_head_dim
    nkv = cfg.num_kv_heads * hd
    if not heads_split(cfg, tp):
        return tp.replicated(params["wk"], -1, nkv), tp.replicated(params["wv"], -1, nkv)
    if cfg.num_kv_heads % tp.size == 0 and params["wk"].shape[-1] < nkv:
        return params["wk"], params["wv"]  # this rank's KV heads, whole
    kv0 = tp_heads(cfg, tp)[2]
    cols = slice(kv0 * hd, (kv0 + 1) * hd)
    return (tp.whole_weight(params["wk"], -1, nkv)[..., cols],
            tp.whole_weight(params["wv"], -1, nkv)[..., cols])


def q_weights(params: dict, cfg, tp=None) -> tuple[torch.Tensor, int]:
    """(wq, heads) of this rank's query heads: its column shard where the
    heads split, else the whole weight and every head."""
    if heads_split(cfg, tp):
        return params["wq"], tp_heads(cfg, tp)[1]
    wq = params["wq"]
    if tp is not None:
        wq = tp.replicated(wq, -1, cfg.num_heads * cfg.resolved_head_dim)
    return wq, cfg.num_heads


def qkv(params: dict, x: torch.Tensor, kv_in: torch.Tensor, cfg, tp=None):
    """The query heads of ``x`` (B, Sq, D) and the KV heads of ``kv_in``
    (B, Sk, D): (q (B, Sq, Hq, hd), k, v (B, Sk, Hkv, hd)). ``tp``: this
    rank's heads, from the column shards of ``wq`` / ``wk`` / ``wv``. With
    fewer KV heads than ranks ``wk`` / ``wv`` split into part-heads, or
    stay whole where the extent does not divide them: each rank then takes
    the whole weight (``whole_weight``) and uses the columns of its one KV
    head, as the reference's partitioned program computes the same
    function. Where the heads do not split (``heads_split``), every head."""
    hd = cfg.resolved_head_dim
    b, sq, _ = x.shape
    sk = kv_in.shape[1]
    wq, hq = q_weights(params, cfg, tp)
    wk, wv = kv_weights(params, cfg, tp)
    q = (x @ wq).reshape(b, sq, hq, hd)
    k = (kv_in @ wk).reshape(b, sk, -1, hd)
    v = (kv_in @ wv).reshape(b, sk, -1, hd)
    return q, k, v


def attn_enter(x: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """An attention sublayer's input (``tp.enter``): partial where its
    heads split, replicated otherwise."""
    return x if tp is None else tp.enter(x, heads_split(cfg, tp))


def attn_exit(params: dict, o: torch.Tensor, cfg, tp=None) -> torch.Tensor:
    """``o`` (B, S, this rank's heads * hd) times ``wo`` -- its row shard, or
    the whole ``wo`` where the sublayer runs replicated -- in the block
    boundary's layout (``tp.exit``: reduced over the model group where the
    heads split)."""
    if tp is None:
        return o @ params["wo"]
    if heads_split(cfg, tp):
        return tp.exit(o @ params["wo"])
    wo = tp.replicated(params["wo"], 0, cfg.num_heads * cfg.resolved_head_dim)
    return tp.exit(o @ wo, partial=False)


def attention_block(params: dict, x: torch.Tensor, cfg, *, positions=None,
                    impl: str = "blockwise", block_kv: int = 1024,
                    tp=None) -> torch.Tensor:
    """Full causal self-attention over x: (B, S, D) -> (B, S, D).

    ``tp`` (``dist.tensor_parallel.TensorParallel``): this rank computes
    its query heads (``qkv``) and multiplies by the row shard of ``wo``;
    the partial outputs are reduced over the model group (scattered over
    the sequence under sequence parallelism, where ``x`` is this rank's
    rows). Where the heads do not split (``heads_split``) every rank
    computes the whole sublayer from its whole weights."""
    h = attn_enter(x, cfg, tp)
    b, s, _ = h.shape
    q, k, v = qkv(params, h, h, cfg, tp)
    out = _attend(q, k, v, cfg, positions, impl, block_kv)
    return attn_exit(params, out.reshape(b, s, -1), cfg, tp)


def full_attention(q, k, v, impl: str = "blockwise") -> torch.Tensor:
    """Attention with no mask (the encoder's and the cross-attention's):
    ``blockwise_attention`` over KV blocks of ``min(1024, Sk)``, as the
    reference, or the whole-row plain version (``impl="naive"``: the plain
    path the kernels are measured against)."""
    if impl == "blockwise":
        return blockwise_attention(q, k, v, causal=False, block_kv=min(1024, k.shape[1]))
    if impl == "naive":
        return naive_attention(q, k, v, causal=False)
    raise ValueError(f"attention impl {impl!r}: 'blockwise' or 'naive'")


def cross_attention_block(params: dict, x: torch.Tensor, memory: torch.Tensor, cfg, *,
                          impl: str = "blockwise", tp=None) -> torch.Tensor:
    """x: (B, Sq, D) attends over the encoder's memory (B, Sk, D), with no
    mask and no RoPE (layers.py:343-352). ``tp``: column / row split as
    ``attention_block``; ``memory`` is whole on every rank, its gradient
    this rank's part (the caller sums it over the model group once, where
    the encoder's output enters the decoder)."""
    h = attn_enter(x, cfg, tp)
    b, sq, _ = h.shape
    q, k, v = qkv(params, h, memory, cfg, tp)
    return attn_exit(params, full_attention(q, k, v, impl).reshape(b, sq, -1), cfg, tp)


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


cross_attention_defs = attention_defs  # the same four projections (layers.py:332-340)


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


def _mlp(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
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


def apply_mlp(params: dict, x: torch.Tensor, kind: str, tp=None,
              d_ff: int | None = None) -> torch.Tensor:
    """The MLP. ``tp``: ``w1`` / ``w3`` column shards and the ``w2`` row
    shard, the partial outputs reduced over the model group; where the
    extent does not divide the hidden width (``d_ff``, the full one: the
    weights are then whole) every rank computes all of it."""
    if tp is None:
        return _mlp(params, x, kind)
    partial = params["w1"].shape[-1] != d_ff
    return tp.exit(_mlp(params, tp.enter(x, partial), kind), partial)
