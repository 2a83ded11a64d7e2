"""Decode-time caches and the single-token decode forward.

Port of ``src/repro/models/kvcache.py``. Cache layout mirrors the superblock
structure: per superblock position an attention entry holds ``k``/``v`` of
shape (R, B, S_max, n_kv, hd), stacked over repeats (R); a sliding-window
config allocates only a window-sized ring. The repeat scan of the JAX
package is a Python loop here.

**Cache writes are in place.** ``decode_step`` writes the decoded token into
the cache tensors it is given and returns that same dict, where the JAX
function returns a new tree.

Positions come from the host (the engine's scheduler): ``pos`` and
``active`` are read once per step on the host, and every index and mask the
layers need is built once per step (``ResidentKV.prepare``) and shared by
all layers.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.model import (
    check_dense,
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


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """``{pos<j>: {name: (shape, dtype)}}`` of the decode cache (no allocation)."""
    check_dense(cfg)
    r = num_repeats(cfg)
    hd = cfg.resolved_head_dim
    dt = L.torch_dtype(cfg.dtype)
    kv = ((r, batch, cache_len(cfg, seq_len), cfg.num_kv_heads, hd), dt)
    return {f"pos{j}": {"k": kv, "v": kv} for j in range(superblock_period(cfg))}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device="cpu") -> dict:
    return {pos: {name: torch.zeros(shape, dtype=dt, device=device)
                  for name, (shape, dt) in entry.items()}
            for pos, entry in cache_specs(cfg, batch, seq_len).items()}


def host_positions(pos) -> torch.Tensor:
    """``pos`` as a host int64 tensor: () shared, or (B,) per slot."""
    return torch.as_tensor(pos).to("cpu", torch.int64)


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
    """Where one step writes its token into (B, S, ...) buffers on one device.

    ``slot`` is an int for a shared position (every row writes there), else
    ``rows``/``slots`` are device index tensors of the rows that write
    (masked-off slots already dropped) and the slot each writes.
    """

    slot: int | None = None
    rows: torch.Tensor | None = None
    slots: torch.Tensor | None = None

    @classmethod
    def build(cls, slot: torch.Tensor, active: torch.Tensor | None, device) -> "SlotWrite":
        """``slot``: host () or (B,) ints; ``active``: host (B,) bool or None."""
        if slot.ndim == 0:
            assert active is None, "write masking requires per-slot positions"
            return cls(slot=int(slot))
        rows = torch.arange(slot.shape[0])
        if active is not None:
            rows = rows[active]
        return cls(rows=rows.to(device), slots=slot[rows].to(device))


def write_slot(buf: torch.Tensor, val: torch.Tensor, where: SlotWrite) -> None:
    """Write one decoded token (``val``: (B, 1, ...)) into a (B, S, ...) cache,
    in place, at ``where``."""
    val = val.to(buf.dtype)
    if where.slot is not None:
        buf[:, where.slot] = val[:, 0]
    else:
        buf[where.rows, where.slots] = val[where.rows, 0]


@dataclasses.dataclass
class ResidentStep:
    rope: torch.Tensor  # device RoPE positions
    write: SlotWrite
    mask: torch.Tensor  # device fp32 (S,) or (B, S)


class ResidentKV:
    """Default decode cache I/O: the whole (B, S, kv, hd) cache lives on the
    device. ``update_and_fetch`` is the seam the paged serving subsystem
    replaces (``serve.paging.PagedKV``): write the decoded token, return the
    key/value views attention runs over and the mask. ``entry_keys`` names
    the cache leaves the hook consumes per attention position."""

    entry_keys = ("k", "v")

    def prepare(self, cache: dict, pos, cfg: ModelConfig, device,
                active=None) -> ResidentStep:
        """Everything the layers need this step, built once from host ``pos``."""
        pos = host_positions(pos)
        s_kv = next(iter(cache.values()))["k"].shape[2]
        slot = pos % s_kv if cfg.sliding_window else pos
        act = None if active is None else torch.as_tensor(active).to("cpu", torch.bool)
        return ResidentStep(
            rope=rope_positions(pos).to(device),
            write=SlotWrite.build(slot, act, device),
            mask=decode_mask(pos, s_kv, bool(cfg.sliding_window)).to(device))

    def update_and_fetch(self, entry: dict, k, v, step: ResidentStep):
        write_slot(entry["k"], k, step.write)
        write_slot(entry["v"], v, step.write)
        return entry["k"], entry["v"], step.mask


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


def _decode_attention(ap: dict, h, entry: dict, step, cfg: ModelConfig, kv_io):
    """h: (B,1,D). Writes the cache entry in place; returns (B,1,D)."""
    b = h.shape[0]
    hd = cfg.resolved_head_dim
    q = (h @ ap["wq"]).reshape(b, 1, cfg.num_heads, hd)
    k = (h @ ap["wk"]).reshape(b, 1, cfg.num_kv_heads, hd)
    v = (h @ ap["wv"]).reshape(b, 1, cfg.num_kv_heads, hd)
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
    return out.reshape(b, 1, -1) @ ap["wo"]


def decode_position(pparams: dict, x, pcache: dict, step, cfg: ModelConfig, kv_io):
    """One layer, one token. x: (B,1,D); ``pcache`` is this layer's cache
    entry (views, written in place)."""
    h = L.apply_norm(pparams["norm1"], x, cfg.norm)
    x = x + _decode_attention(pparams["attn"], h, pcache, step, cfg, kv_io)
    if "mlp" in pparams:
        h2 = L.apply_norm(pparams["norm2"], x, cfg.norm)
        x = x + L.apply_mlp(pparams["mlp"], h2, cfg.mlp)
    return x


def _layer_slice(tree: dict, r: int) -> dict:
    return {k: (v[r] if isinstance(v, torch.Tensor) else _layer_slice(v, r))
            for k, v in tree.items()}


def decode_step(params: dict, cache: dict, tokens: torch.Tensor, pos, cfg: ModelConfig,
                *, kv_io=None, active=None):
    """One decode step across the whole model. Returns (logits (B,V), cache),
    the cache written in place.

    tokens: (B, 1) on the model's device; pos: () shared or (B,) per slot,
    read on the host; active: (B,) bool or None -- masks cache writes per
    slot (chunked prefill advances a subset of slots). ``kv_io`` swaps the
    attention-cache strategy (default ``RESIDENT_KV``; the paged serving path
    passes ``serve.paging.PagedKV``).
    """
    kv_io = kv_io or RESIDENT_KV
    x = embed_tokens(params, tokens, cfg)
    step = kv_io.prepare(cache, pos, cfg, x.device, active=active)
    keys = kv_io.entry_keys
    for r in range(num_repeats(cfg)):
        for j in range(superblock_period(cfg)):
            name = f"pos{j}"
            pp = _layer_slice(params["blocks"][name], r)
            entry = {key: cache[name][key][r] for key in keys}
            x = decode_position(pp, x, entry, step, cfg, kv_io)
    logits = lm_head(params, x, cfg)
    return logits[:, 0], cache
