"""Decode-time caches and the single-token decode forward.

Port of ``src/repro/models/kvcache.py``. Cache layout mirrors the superblock
structure: per superblock position an attention entry holds ``k``/``v`` of
shape (R, B, S_max, n_kv, hd), stacked over repeats (R); a sliding-window
config allocates only a window-sized ring. A Mamba-2 entry holds the
recurrent state, ``conv`` (R, B, d_conv - 1, conv_dim) in the model's dtype
and ``ssm`` (R, B, H, P, N) in fp32. An encoder-decoder's positions also
hold the cross-attention's keys and values over the encoded source, ``xk``
/ ``xv`` (R, B, S_max, n_kv, hd): decode reads them whole, with no mask, and
never writes them; ``prime_cross_cache`` fills them in place from the
encoder's output (no serving path does: the engine serves over the zeros
``init_cache`` makes, as the JAX engine does). The repeat scan of the JAX
package is a Python loop here.

**Cache writes are in place.** ``decode_step`` writes the decoded token into
the cache tensors it is given and returns that same dict, where the JAX
function returns a new tree.

**Indices are built on the device.** ``decode_forward`` takes ``pos`` and
``active`` as tensors on the model's device and builds every index and mask
the layers need from them with tensor ops (``ResidentKV.prepare``: the
RoPE positions, the fixed-shape ring write, the mask), once per step, shared
by all layers. Nothing in it reads a value back to the host, so the step can
be captured as a CUDA graph and replayed with new positions written into
the same buffers (``serve.prefill.ServeStep``). A Mamba-2 position writes
its new state into its entry in place, masked by the step's ``active`` (as
the JAX package's ``jnp.where`` keeps an inactive slot's state). What
depends on the data and cannot live in a graph -- the paged cache's page-boundary flush to its
host-memory cold store -- is the cache hook's ``commit``, issued after the
step from host positions; ``decode_step`` is the two together.

**On a mesh** a rank's cache holds its slots and heads (``cache_specs(...,
tp)``): its KV heads (the one KV head its query heads read, whole, where
ranks outnumber the KV heads; all of them where attention runs
replicated), its SSD heads' conv and SSM state. ``decode_forward`` then
runs each sublayer over the model axis (``tp``), routes an MoE over the
data ranks' slots (``route``) and, under a sharded-weight serve plan,
takes each layer's weights from an all-gather started a layer ahead
(``gather``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models.moe import apply_moe
from repro_torch.models.model import (
    check_family,
    embed_tokens,
    lm_head,
    num_repeats,
    superblock_period,
)


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    """Per-attention-layer cache length (ring-buffered for SWA)."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int, tp=None) -> dict:
    """``{pos<j>: {name: (shape, dtype)}}`` of the decode cache (no
    allocation). ``tp``: a model rank's, over its KV heads
    (``layers.rank_kv_heads``) and its SSD heads (``mamba2_state_defs``);
    ``batch`` is then the rank's slots."""
    check_family(cfg)
    r = num_repeats(cfg)
    hd = cfg.resolved_head_dim
    dt = L.torch_dtype(cfg.dtype)
    n_kv = L.rank_kv_heads(cfg, tp)
    kv = ((r, batch, cache_len(cfg, seq_len), n_kv, hd), dt)
    out = {}
    for j in range(superblock_period(cfg)):
        if cfg.mixer_at(j) == "attention":
            out[f"pos{j}"] = {"k": kv, "v": kv}
        else:
            (conv, conv_dt), (ssm, ssm_dt) = M2.mamba2_state_defs(cfg, batch, tp)
            out[f"pos{j}"] = {"conv": ((r,) + conv, conv_dt), "ssm": ((r,) + ssm, ssm_dt)}
    if cfg.kind == "encdec":  # cross-attention K/V over the encoded source
        xkv = ((r, batch, seq_len, n_kv, hd), dt)
        for entry in out.values():
            entry.update(xk=xkv, xv=xkv)
    return out


@torch.no_grad()
def prime_cross_cache(params: dict, memory: torch.Tensor, cache: dict,
                      cfg: ModelConfig, tp=None, gather=None) -> None:
    """Write every position's cross-attention keys and values, ``memory @
    wk`` and ``memory @ wv``, into the cache's ``xk`` / ``xv`` **in place**
    (a captured serving step reads those tensors). ``memory``: the
    encoder's output (B, S_max, D) for the cache's B slots and length.
    On a mesh: ``tp``, a model rank's KV heads (``layers.kv_weights``);
    ``gather``, a layer's weights made whole over the data ranks under a
    sharded-weight plan (``dist.collectives.ServeGather``)."""
    b, s, _ = memory.shape
    hd = cfg.resolved_head_dim
    for name, entry in cache.items():
        for r in range(entry["xk"].shape[0]):
            ap = _layer_slice(params["blocks"][name]["xattn"], r)
            if gather is not None:
                ap = gather.layer(ap)
            for leaf, w in zip(("xk", "xv"), L.kv_weights(ap, cfg, tp)):
                entry[leaf][r].copy_((memory @ w).reshape(b, s, -1, hd))


def attention_entries(cache: dict) -> list[dict]:
    """The cache entries of the attention positions (the others hold
    Mamba-2 state)."""
    return [e for e in cache.values() if "conv" not in e]


def batch_size(cache: dict) -> int:
    """The cache's batch: every leaf is (R, B, ...)."""
    return next(iter(next(iter(cache.values())).values())).shape[1]


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cpu", tp=None) -> dict:
    return {pos: {name: torch.zeros(shape, dtype=dt, device=device)
                  for name, (shape, dt) in entry.items()}
            for pos, entry in cache_specs(cfg, batch, seq_len, tp).items()}


def host_positions(pos) -> torch.Tensor:
    """``pos`` as a host int64 tensor: () shared, or (B,) per slot."""
    return torch.as_tensor(pos).to("cpu", torch.int64)


def device_positions(pos, device) -> torch.Tensor:
    """``pos`` as an int64 tensor on ``device`` (no copy if it lies there)."""
    return torch.as_tensor(pos).to(device, torch.int64)


def rope_positions(pos: torch.Tensor) -> torch.Tensor:
    """RoPE positions for the decoded token: (1,) for a shared scalar ``pos``,
    (B, 1) for per-slot positions (continuous batching)."""
    if pos.ndim == 0:
        return pos.reshape(1)
    return pos[:, None]


def decode_mask(pos: torch.Tensor, s_kv: int, sliding: bool) -> torch.Tensor:
    """Additive fp32 mask over cache slots at decode position ``pos``:
    (S_kv,) for scalar ``pos``, (B, S_kv) for per-slot positions. Ring caches
    are all valid once wrapped (pos >= s_kv); before that, slot order."""
    kpos = torch.arange(s_kv, device=pos.device)
    if pos.ndim:
        kpos = kpos[None, :]
        pos = pos[:, None]
    valid = (pos >= s_kv) | (kpos <= pos) if sliding else kpos <= pos
    return torch.where(valid, 0.0, L.NEG_INF).to(torch.float32)


@dataclasses.dataclass
class SlotWrite:
    """Where one step writes its token into (B, S, ...) buffers, as device
    tensors of a fixed shape: ``index`` (B,) is the flat row ``b * S +
    slot[b]`` of a (B * S, ...) view, kept inside row b; ``active`` (B,)
    bool masks the rows that write (the others write back the bytes they
    hold)."""

    index: torch.Tensor
    active: torch.Tensor

    @classmethod
    def build(cls, slot: torch.Tensor, active: torch.Tensor | None, batch: int,
              s_kv: int) -> "SlotWrite":
        """``slot``: () shared or (B,) per slot, on the device. A slot past
        the buffer (an inactive slot of a chunk step beyond the cache end)
        writes nothing, as the JAX one-hot write does."""
        rows = torch.arange(batch, device=slot.device) * s_kv
        inside = (slot < s_kv).expand(batch)
        return cls(index=rows + slot.clamp(max=s_kv - 1),
                   active=inside if active is None else active & inside)


def write_slot(buf: torch.Tensor, val: torch.Tensor, where: SlotWrite) -> None:
    """Write one decoded token (``val``: (B, 1, ...)) into a contiguous
    (B, S, ...) cache, in place, at ``where``: one row per batch row, rows of
    inactive slots rewritten with their own bytes."""
    b, s = buf.shape[:2]
    flat = buf.view(b * s, *buf.shape[2:])
    new = val[:, 0].to(buf.dtype)
    keep = where.active.reshape((-1,) + (1,) * (new.ndim - 1))
    new = torch.where(keep, new, flat.index_select(0, where.index))
    flat.index_copy_(0, where.index, new)


def write_state(buf: torch.Tensor, val: torch.Tensor, active: torch.Tensor | None) -> None:
    """Write a new (B, ...) recurrent state into ``buf`` in place, rows of
    inactive slots keeping theirs (``active``: device bool (B,), or None
    when every slot is)."""
    if active is not None:
        val = torch.where(active.view((-1,) + (1,) * (buf.dim() - 1)), val, buf)
    buf.copy_(val)


@dataclasses.dataclass
class ResidentStep:
    rope: torch.Tensor  # device RoPE positions
    write: SlotWrite | None  # None without an attention position
    mask: torch.Tensor | None  # device fp32 (S,) or (B, S); None without attention
    active: torch.Tensor | None  # device bool (B,), None if every slot is: the state's write


class ResidentKV:
    """Default decode cache I/O: the whole (B, S, kv, hd) cache lives on the
    device. ``update_and_fetch`` is the seam the paged serving subsystem
    replaces (``serve.paging.PagedKV``): write the decoded token, return the
    key/value views attention runs over and the mask. ``layer_entry`` gives
    the cache leaves the hook consumes for one layer of an attention
    position (or the state of a Mamba-2 position)."""

    def layer_entry(self, pos_cache: dict, r: int) -> dict:
        return {name: leaf[r] for name, leaf in pos_cache.items()}

    def prepare(self, cache: dict, pos, cfg: ModelConfig, device,
                active=None) -> ResidentStep:
        """Everything the layers need this step, built on ``device`` from
        ``pos`` and ``active`` with tensor ops."""
        pos = device_positions(pos, device)
        act = None if active is None else torch.as_tensor(active).to(device, torch.bool)
        step = ResidentStep(rope=rope_positions(pos), write=None, mask=None, active=act)
        attn = attention_entries(cache)
        if attn:
            s_kv = attn[0]["k"].shape[2]
            slot = pos % s_kv if cfg.sliding_window else pos
            step.write = SlotWrite.build(slot, act, batch_size(cache), s_kv)
            step.mask = decode_mask(pos, s_kv, bool(cfg.sliding_window))
        return step

    def update_and_fetch(self, entry: dict, k, v, step: ResidentStep):
        write_slot(entry["k"], k, step.write)
        write_slot(entry["v"], v, step.write)
        return entry["k"], entry["v"], step.mask

    def commit(self, cache: dict, pos, cfg: ModelConfig, active=None) -> None:
        """The step's host-side work: none for a resident cache."""


RESIDENT_KV = ResidentKV()


def _masked_decode_attn(q, k, v, logits_mask):
    """Single-query attention over the whole cache. q: (B,1,Hq,hd).
    ``logits_mask``: (S_kv,) shared, or (B, S_kv) per slot."""
    b, _, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qh = (q.float() / math.sqrt(hd)).reshape(b, hkv, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qh, k.float())
    if logits_mask.ndim == 2:
        logits = logits + logits_mask[:, None, None, :]
    else:
        logits = logits + logits_mask[None, None, None, :]
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _decode_attention(ap: dict, h, entry: dict, step, cfg: ModelConfig, kv_io, tp=None):
    """h: (B,1,D). Writes the cache entry in place; returns (B,1,D). ``tp``:
    this rank's query and KV heads (``layers.qkv``), ``wo`` row-parallel and
    the partial outputs reduced over the model group; every head where the
    sublayer runs replicated."""
    b = h.shape[0]
    h = L.attn_enter(h, cfg, tp)
    q, k, v = L.qkv(ap, h, h, cfg, tp)
    q = L.apply_rope(q, step.rope, cfg.rope_theta)
    k = L.apply_rope(k, step.rope, cfg.rope_theta)
    attend = getattr(kv_io, "attend", None)
    if attend is not None:
        # fused path: the kv_io owns the whole write+attend (the paged kernel
        # reads hot ring + cold store directly)
        out = attend(entry, q, k, v, step)
    else:
        full_k, full_v, mask = kv_io.update_and_fetch(entry, k, v, step)
        out = _masked_decode_attn(q, full_k, full_v, mask)
    return L.attn_exit(ap, out.reshape(b, 1, -1), cfg, tp)


def _decode_cross_attention(ap: dict, h, xk, xv, cfg: ModelConfig, tp=None):
    """h: (B,1,D) attends over the whole cross cache (B, S, n_kv, hd): this
    rank's heads under ``tp``, as ``_decode_attention``."""
    b = h.shape[0]
    wq, hq = L.q_weights(ap, cfg, tp)
    q = (L.attn_enter(h, cfg, tp) @ wq).reshape(b, 1, hq, cfg.resolved_head_dim)
    mask = torch.zeros((xk.shape[1],), dtype=torch.float32, device=h.device)
    return L.attn_exit(ap, _masked_decode_attn(q, xk, xv, mask).reshape(b, 1, -1), cfg, tp)


def _decode_mamba(mp: dict, h, pcache: dict, step, cfg: ModelConfig, tp=None):
    """h: (B,1,D). One step of the recurrence from the entry's state, whose
    new value is written in place (inactive slots keep theirs)."""
    mix, (conv, ssm) = M2.apply_mamba2(mp, h, cfg, state=(pcache["conv"], pcache["ssm"]),
                                       return_state=True, tp=tp)
    write_state(pcache["conv"], conv, step.active)
    write_state(pcache["ssm"], ssm, step.active)
    return mix


def decode_position(pparams: dict, x, pcache: dict, step, cfg: ModelConfig, kv_io, tp=None,
                    route=None):
    """One layer, one token. x: (B,1,D); ``pcache`` is this layer's cache
    entry (views, written in place; an encoder-decoder's cross cache only
    read). An MoE routes all B rows, inactive
    slots of a chunked-prefill step too, which take capacity as in the JAX
    package; its aux loss is dropped. ``tp``: the model axis's split of
    each sublayer (the hidden state whole on every model rank);
    ``route``: the data ranks whose slots make up the batch an MoE routes
    (``dist.tensor_parallel.BatchGroup``)."""
    h = L.apply_norm(pparams["norm1"], x, cfg.norm)
    if "attn" in pparams:
        x = x + _decode_attention(pparams["attn"], h, pcache, step, cfg, kv_io, tp)
    else:
        x = x + _decode_mamba(pparams["mamba"], h, pcache, step, cfg, tp)
    if "xattn" in pparams:
        hx = L.apply_norm(pparams["norm_x"], x, cfg.norm)
        x = x + _decode_cross_attention(pparams["xattn"], hx, pcache["xk"], pcache["xv"], cfg,
                                        tp)
    if "moe" in pparams:
        h2 = L.apply_norm(pparams["norm2"], x, cfg.norm)
        out, _ = apply_moe(pparams["moe"], h2, cfg, tp=tp, route=route)
        x = x + out
    elif "mlp" in pparams:
        h2 = L.apply_norm(pparams["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(pparams["mlp"], h2, cfg.mlp, tp, cfg.d_ff)
    return x


def _layer_slice(tree: dict, r: int) -> dict:
    return {k: (v[r] if isinstance(v, torch.Tensor) else _layer_slice(v, r))
            for k, v in tree.items()}


def decode_forward(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                   *, kv_io=None, active=None, tp=None, route=None,
                   gather=None) -> torch.Tensor:
    """One decode step's device work across the whole model: returns the
    logits (B, V) and writes the cache in place. No value is read back to
    the host, so a CUDA graph can capture it.

    tokens: (B, 1) on the model's device; pos: () shared or (B,) per slot;
    active: (B,) bool or None -- masks cache writes per slot (chunked
    prefill advances a subset of slots). Both are taken to the device if
    they lie elsewhere. ``kv_io`` swaps the attention-cache strategy
    (default ``RESIDENT_KV``; the paged serving path passes
    ``serve.paging.PagedKV``).

    On a mesh: ``tp`` splits each sublayer over the model ranks, the
    logits then this rank's slice of the vocab where the head splits;
    ``route`` is the MoE's batch group over the data ranks' slots;
    ``gather`` (``dist.collectives.ServeGather``) makes the weights whole
    over the data ranks under a sharded-weight plan -- the embedding and
    head once a step, each layer's weights through an all-gather started
    one layer ahead -- the serving twin of the reference's
    ``gather_weights`` in its decode scan.
    """
    kv_io = kv_io or RESIDENT_KV
    layers = [(r, f"pos{j}") for r in range(num_repeats(cfg))
              for j in range(superblock_period(cfg))]
    weights = lambda i: _layer_slice(params["blocks"][layers[i][1]], layers[i][0])  # noqa: E731
    if gather is not None:
        gather.prefetch(weights(0))
        params = gather.outer(params)
    x = embed_tokens(params, tokens, cfg, tp)
    step = kv_io.prepare(cache, pos, cfg, x.device, active=active)
    for i, (r, name) in enumerate(layers):
        pp = weights(i)
        if gather is not None:
            if i + 1 < len(layers):
                gather.prefetch(weights(i + 1))
            pp = gather.layer(pp)
        x = decode_position(pp, x, kv_io.layer_entry(cache[name], r), step, cfg, kv_io, tp,
                            route)
    logits = lm_head(params, x, cfg, tp)
    return logits[:, 0]


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                *, kv_io=None, active=None, tp=None, route=None, gather=None):
    """One decode step: ``decode_forward``, then the cache hook's host-side
    ``commit`` (the paged cache's page-boundary flush), with ``pos`` and
    ``active`` read on the host. Returns (logits (B, V), cache), the cache
    written in place."""
    kv_io = kv_io or RESIDENT_KV
    logits = decode_forward(params, cache, tokens, pos, cfg, kv_io=kv_io, active=active,
                            tp=tp, route=route, gather=gather)
    kv_io.commit(cache, pos, cfg, active=active)
    return logits, cache
