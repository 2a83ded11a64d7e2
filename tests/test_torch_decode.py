"""The port's decode step and chunked prefill against the JAX package's.

Same parameters (the JAX tree carried across by ``convert``) and the same
numpy-made tokens go through ``repro.models.kvcache.decode_step`` and the
port's, step by step, for logits and every cache leaf: resident caches and
paged ones (the JAX side ``PagedKV(use_kernel=False)``, driven directly,
without a mesh), page-boundary flush and write-through, full attention and
a sliding ring that wraps, shared and per-slot positions. Reduced
``mistral-7b`` keeps GQA (``num_kv_heads=2``: 4 query heads over 2).
Tolerances (``atol = rtol``, after casting to fp32): fp32 1e-4, bf16 2e-2.

In bf16 the port rounds RMSNorm in the order of the JAX package's Pallas
kernel (``kernels/rmsnorm.py:15-18``), which the JAX model path does not use
(``layers.rmsnorm`` rounds ``x * bf16(rsqrt)``); the bf16 cases therefore
route the JAX side's norms through that kernel's oracle, ``ref.rmsnorm_ref``,
and use one layer: XLA and torch round the residual stream's bf16 adds and
products at different places, and past the first layer the caches drift by
a few bf16 ulps (up to ~0.03 on unit-scale values after two layers), beyond
the 2e-2 bound; the fp32 cases cover depth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels import ref as JR
from repro.models import layers as JL
from repro.models import kvcache as JKV
from repro.models import model as JM
from repro.serve import PagedKV as JPagedKV
from repro.serve import choose_paging as jchoose
from repro.serve import init_paged_cache as jinit_paged
from repro.serve import paged_to_resident as jpaged_to_resident
from repro.serve import prefill_chunk as jprefill
from repro_torch.models import kvcache as TKV
from repro_torch.models.convert import tree_from_numpy
from repro_torch.serve import (
    PagedKV,
    choose_paging,
    init_paged_cache,
    paged_to_resident,
    prefill_chunk,
)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B = 2


def _cfg(dtype: str, sliding: bool):
    cfg = reduced(get_config("mistral-7b"), num_kv_heads=2)
    assert cfg.sliding_window and cfg.num_heads // cfg.num_kv_heads == 2
    return dataclasses.replace(cfg, dtype=dtype,
                               sliding_window=cfg.sliding_window if sliding else 0)


def _params(cfg):
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return jp, tree_from_numpy(jax.device_get(jp))


def _close(a, b, dtype) -> float:
    """Largest excess of |a - b| over the tolerance (<= 0 passes)."""
    a = np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a, np.float32)
    b = np.asarray(jnp.asarray(b).astype(jnp.float32))
    return float((np.abs(a - b) - TOL[dtype] * (1.0 + np.abs(b))).max())


def _caches(cfg, S, layout, flush):
    """(jax cache, jax kv_io, port cache, port kv_io maker) for a layout."""
    if layout == "resident":
        return (JKV.init_cache(cfg, B, S), None, TKV.init_cache(cfg, B, S),
                lambda use_kernel: None)
    spec = jchoose(JKV.cache_len(cfg, S), 8, 2)
    assert spec.n_cold > 0, "parity must exercise cold pages"
    tspec = choose_paging(TKV.cache_len(cfg, S), 8, 2)
    return (jinit_paged(cfg, B, S, spec), JPagedKV(spec, flush=flush, use_kernel=False),
            init_paged_cache(cfg, B, S, tspec),
            lambda use_kernel: PagedKV(tspec, flush=flush, use_kernel=use_kernel))


CASES = [
    # (layout, flush, sliding, per_slot, dtype)
    ("resident", True, False, False, "float32"),
    ("resident", True, True, True, "float32"),
    ("paged", True, False, True, "float32"),
    ("paged", True, True, False, "float32"),
    ("paged", True, True, True, "float32"),
    ("paged", False, False, False, "float32"),
    ("paged", False, True, True, "float32"),
    ("paged", True, True, True, "bfloat16"),
]


@pytest.mark.parametrize("layout,flush,sliding,per_slot,dtype", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_decode_matches_jax(layout, flush, sliding, per_slot, dtype, monkeypatch):
    """>= 24 steps; the ring case (cache_len 32 at S=32, 36 steps) wraps."""
    if dtype == "bfloat16":
        monkeypatch.setattr(JL, "rmsnorm", JR.rmsnorm_ref)
    cfg = _cfg(dtype, sliding)
    if dtype == "bfloat16":
        cfg = dataclasses.replace(cfg, num_layers=1)
    S, steps = (32, 36) if sliding else (40, 28)
    if sliding:
        cfg = dataclasses.replace(cfg, sliding_window=32)
    jp, tp = _params(cfg)
    jc, jio, tc, make_io = _caches(cfg, S, layout, flush)
    tio = make_io(True)
    step = jax.jit(lambda c, t, p: JKV.decode_step(jp, c, t, p, cfg, kv_io=jio))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, steps))
    for t in range(steps):
        pos = np.full((B,), t, np.int32) if per_slot else np.int32(t)
        lj, jc = step(jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos))
        lt, tc = TKV.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                 torch.from_numpy(np.asarray(pos)), cfg, kv_io=tio)
        assert _close(lt, lj, dtype) <= 0, f"logits diverged at step {t}"
    for pos_name, entry in tc.items():
        for name, leaf in entry.items():
            assert _close(leaf, jc[pos_name][name], dtype) <= 0, (pos_name, name)
    if layout == "paged":
        view, jview = paged_to_resident(tc), jpaged_to_resident(jc)
        for name in ("k", "v"):
            assert _close(view["pos0"][name], jview["pos0"][name], dtype) <= 0


def test_paged_kernel_path_matches_rebuild_path():
    """Inside the port: ``PagedKV`` through the kernels package (on the CPU,
    the plain ``paged_attention_ref``) and through the cache rebuild +
    ``_masked_decode_attn`` give the same logits (fp32, atol 1e-5: the two
    differ only in their einsum layouts)."""
    cfg = dataclasses.replace(_cfg("float32", True), sliding_window=32)
    _, tp = _params(cfg)
    spec = choose_paging(TKV.cache_len(cfg, 32), 8, 2)
    ca, cb = init_paged_cache(cfg, B, 32, spec), init_paged_cache(cfg, B, 32, spec)
    ka, kb = PagedKV(spec, use_kernel=True), PagedKV(spec, use_kernel=False)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 40)))
    for t in range(40):
        pos = torch.tensor([t, max(t - 5, 0)])
        la, ca = TKV.decode_step(tp, ca, toks[:, t:t + 1], pos, cfg, kv_io=ka)
        lb, cb = TKV.decode_step(tp, cb, toks[:, t:t + 1], pos, cfg, kv_io=kb)
        torch.testing.assert_close(la, lb, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sliding", [False, True])
def test_paged_h2d_bytes_count_attended_cold_rows(sliding):
    """``PagedKV.h2d_bytes`` counts K and V of the cold rows the kernel path
    attends -- before the ring wraps, the pages older than the hot window,
    ``wp - n_hot + 1`` of them at write page ``wp`` -- and the rebuild
    path's whole cold store, in every attention layer."""
    cfg = _cfg("float32", sliding)
    if sliding:
        cfg = dataclasses.replace(cfg, sliding_window=32)
    _, tp = _params(cfg)
    spec = choose_paging(TKV.cache_len(cfg, 32), 8, 2)
    pos = torch.tensor([5, 29])  # write pages 0 and 3
    cold_rows = sum(max(0, int(p) // 8 - spec.n_hot + 1) * 8 for p in pos)
    assert cold_rows == 16
    row = cfg.num_kv_heads * cfg.resolved_head_dim * 4  # fp32 bytes of one cache row
    toks = torch.ones((B, 1), dtype=torch.int64)
    for use_kernel, rows in ((True, cold_rows), (False, B * 32)):
        kv = PagedKV(spec, use_kernel=use_kernel)
        TKV.decode_step(tp, init_paged_cache(cfg, B, 32, spec), toks, pos, cfg, kv_io=kv)
        assert kv.h2d_bytes == cfg.num_layers * 2 * rows * row, use_kernel


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["resident", "paged"])
def test_prefill_chunk_matches_jax(layout):
    cfg = _cfg("float32", True)
    S, C = 64, 12
    jp, tp = _params(cfg)
    jc, jio, tc, make_io = _caches(cfg, S, layout, True)
    tio = make_io(True)
    toks = np.random.default_rng(3).integers(1, cfg.vocab_size, (B, C))
    pos, n_tok = np.array([0, 5], np.int32), np.array([12, 7], np.int32)
    if layout == "paged":
        # a first chunk so the second starts mid-page and crosses a flush
        jl0, jc = jprefill(jp, jc, jnp.asarray(toks), jnp.zeros(B, jnp.int32),
                           jnp.asarray(np.array([12, 5], np.int32)), cfg, kv_io=jio)
        tl0, tc = prefill_chunk(tp, tc, torch.from_numpy(toks), torch.zeros(B, dtype=torch.int64),
                                torch.tensor([12, 5]), cfg, kv_io=tio)
        assert _close(tl0, jl0, "float32") <= 0
        pos = np.array([12, 5], np.int32)
    lj, jc = jax.jit(lambda c, t, p, n: jprefill(jp, c, t, p, n, cfg, kv_io=jio))(
        jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(n_tok))
    lt, tc = prefill_chunk(tp, tc, torch.from_numpy(toks), torch.from_numpy(pos),
                           torch.from_numpy(n_tok), cfg, kv_io=tio)
    assert _close(lt, lj, "float32") <= 0
    for pos_name, entry in tc.items():
        for name, leaf in entry.items():
            assert _close(leaf, jc[pos_name][name], "float32") <= 0, (pos_name, name)


@pytest.mark.parametrize("layout", ["resident", "paged"])
def test_chunked_prefill_equals_token_replay(layout):
    """Inside the port, prefill in uneven chunks gives exactly the logits and
    caches of one decode step per token (same ops, same order), through a
    sliding ring that wraps (prompts longer than the 32-slot ring)."""
    cfg = dataclasses.replace(_cfg("float32", True), sliding_window=32)
    S = 32
    _, tp = _params(cfg)
    n_tok = torch.tensor([45, 38])
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, cfg.vocab_size, (B, 45)))
    _, _, cache_r, make_io = _caches(cfg, S, layout, True)
    _, _, cache_c, _ = _caches(cfg, S, layout, True)
    io = make_io(True)
    last_r = torch.zeros(B, cfg.vocab_size)
    for t in range(45):
        logits, cache_r = TKV.decode_step(tp, cache_r, toks[:, t:t + 1], torch.full((B,), t),
                                          cfg, kv_io=io, active=t < n_tok)
        last_r = torch.where((t == n_tok - 1)[:, None], logits, last_r)
    last_c, off = torch.zeros(B, cfg.vocab_size), 0
    for c in (7, 16, 9, 13):
        n = (n_tok - off).clamp(0, c)
        lg, cache_c = prefill_chunk(tp, cache_c, toks[:, off:off + c], torch.full((B,), off),
                                    n, cfg, kv_io=io)
        last_c = torch.where(((n_tok > off) & (n_tok <= off + c))[:, None], lg, last_c)
        off += c
    assert torch.equal(last_c, last_r)
    for pos_name, entry in cache_r.items():
        for name, leaf in entry.items():
            assert torch.equal(leaf, cache_c[pos_name][name]), (pos_name, name)
