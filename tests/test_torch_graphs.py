"""The serving step as a CUDA graph drives it, on the CPU.

The decode step builds its indices on the device from device positions, so
one captured step replays with new positions: the ring write of the active
slots, the mask, the paged cache's row residency (``sel``) and the RoPE
positions are tensor functions of ``pos`` / ``active``. They are held
**bitwise** (masks and indices exactly; written buffers byte for byte) to
the JAX package's traced ``decode_mask``, ``write_slot``, ``_hot_mask``,
``_take_hot_rows`` and ``_page_is_hot`` on the same positions. Then the step
driven the way the engine drives its graph -- one ``ServeStep`` whose
buffers are written in place, prefill chunks and decode ticks replaying the
same step, the paged cache's page-boundary flush issued between steps -- gives
bitwise the logits and caches of token-by-token ``decode_step``, across page
boundaries, a ring wrap, and a full cache whose last chunk ends at the
cache end. On the CPU the step is launched eagerly: a CUDA
graph replays the same work (tests/test_torch_cuda.py holds the two equal
on the card).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config, reduced
from repro.models import kvcache as JKV
from repro.serve import PagedKV as JPagedKV
from repro.serve import PagingSpec as JSpec
from repro_torch.kernels import build
from repro_torch.models import kvcache as TKV
from repro_torch.models.model import init_params
from repro_torch.serve import PagedKV, PagingSpec, choose_paging, init_paged_cache
from repro_torch.serve.prefill import ServeStep

import torch_cores

torch_cores.share_cores()


@st.composite
def _steps(draw):
    page_size = draw(st.integers(1, 4))
    n_hot = draw(st.integers(1, 3))
    n_pages = n_hot * draw(st.integers(1, 3))
    sliding = draw(st.booleans())
    batch = draw(st.integers(1, 3))
    s = page_size * n_pages
    # a ring decodes past its length; a full cache's inactive slot in a
    # prefill chunk can step past it too (its write lands nowhere)
    top = 3 * s if sliding else 2 * s
    pos = draw(st.lists(st.integers(0, top - 1), min_size=batch, max_size=batch))
    active = draw(st.lists(st.booleans(), min_size=batch, max_size=batch))
    return page_size, n_pages, n_hot, sliding, draw(st.booleans()), pos, active


@settings(max_examples=40, deadline=None)
@given(_steps())
def test_device_built_indices_match_jax(case):
    page_size, n_pages, n_hot, sliding, flush, pos, active = case
    spec = PagingSpec(page_size, n_pages, n_hot)
    jio = JPagedKV(JSpec(page_size, n_pages, n_hot), flush=flush, use_kernel=False)
    s, w, b = spec.cache_len, spec.hot_window, len(pos)
    tpos, tact = torch.tensor(pos), torch.tensor(active)
    jpos, jact = jnp.asarray(pos, jnp.int32), jnp.asarray(active)

    # the additive mask and the RoPE positions
    assert np.array_equal(TKV.decode_mask(tpos, s, sliding).numpy(),
                          np.asarray(JKV.decode_mask(jpos, s, sliding)))
    assert np.array_equal(TKV.rope_positions(tpos).numpy(), np.asarray(JKV.rope_positions(jpos)))

    # sel: the JAX package's per-page residency, concatenated over the pages
    slot = tpos % s if sliding else tpos
    jslot = jnp.asarray(slot.numpy(), jnp.int32)
    jwp = jslot // page_size
    if flush:
        pages = [jnp.broadcast_to(jio._take_hot_rows(jwp, jslot, p, sliding), (b, page_size))
                 for p in range(n_pages)]
        want = np.asarray(jnp.concatenate(pages, axis=1))
    else:
        want = np.concatenate([np.broadcast_to(np.asarray(jio._page_is_hot(jwp, p, sliding)),
                                               (b, page_size)) for p in range(n_pages)], axis=1)
    got = PagedKV(spec, flush=flush).residency(slot, sliding)
    assert np.array_equal(got.numpy(), want)

    # the ring write and the full cache's (resident, or write-through's cold
    # store) write: fixed-shape writes, inactive rows keep their bytes, and a
    # slot past the buffer writes nothing
    rng = np.random.default_rng(sum(pos))
    val = rng.standard_normal((b, 1, 2, 3)).astype(np.float32)
    for length, at in ((w, slot % w), (s, slot)):
        buf = rng.standard_normal((b, length, 2, 3)).astype(np.float32)
        jbuf = JKV.write_slot(jnp.asarray(buf), jnp.asarray(val),
                              jnp.asarray(at.numpy(), jnp.int32), mask=jact)
        tbuf = torch.from_numpy(buf.copy())
        TKV.write_slot(tbuf, torch.from_numpy(val), TKV.SlotWrite.build(at, tact, b, length))
        assert np.array_equal(tbuf.numpy().view(np.int32), np.asarray(jbuf).view(np.int32))


B, S = 2, 32


def _cfg():
    cfg = reduced(get_config("mistral-7b"), num_kv_heads=2)
    return dataclasses.replace(cfg, dtype="float32", sliding_window=S)


def _cache(cfg, layout: str):
    if layout == "resident":
        return TKV.init_cache(cfg, B, S), None
    spec = choose_paging(TKV.cache_len(cfg, S), 8, 2)
    assert spec.n_cold > 0
    return init_paged_cache(cfg, B, S, spec), PagedKV(spec, flush=layout == "paged_flush")


def _drive_as_graph_against_replay(cfg, layout, n_prompt, start, chunk, decode):
    """Slot b's prompt of ``n_prompt[b]`` tokens fed in chunks from tick
    ``start[b]`` on, then ``decode`` decode ticks, through one ``ServeStep``
    whose buffers are written in place; held bitwise to token-by-token
    ``decode_step``: each chunk's last logits, the greedy tokens and every
    cache leaf."""
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (B, max(n_prompt) + decode))
    total = [n + decode for n in n_prompt]

    # token by token through decode_step
    cache_r, io_r = _cache(cfg, layout)
    want = []
    for t in range(max(total)):
        active = torch.tensor([t < n for n in total])
        logits, _ = TKV.decode_step(params, cache_r, torch.from_numpy(toks[:, t:t + 1]),
                                    torch.full((B,), t), cfg, kv_io=io_r, active=active)
        want.append(logits)

    # one ServeStep, its buffers written in place: prefill chunks, then
    # decode ticks, each step the same program
    cache_g, io_g = _cache(cfg, layout)
    step = ServeStep(params, cache_g, cfg, io_g, batch=B, chunk=chunk, device="cpu")
    fed, tick = [0, 0], 0
    while fed != list(n_prompt):
        n = [min(chunk, n_prompt[b] - fed[b]) if tick >= start[b] else 0 for b in range(B)]
        tick += 1
        block = np.zeros((B, chunk), np.int64)
        for b in range(B):
            block[b, :n[b]] = toks[b, fed[b]:fed[b] + n[b]]
        step.run(block, fed, n)
        for b in range(B):
            if n[b]:
                assert torch.equal(step.last[b], want[fed[b] + n[b] - 1][b])
            fed[b] += n[b]
    for t in range(decode):
        block = np.zeros((B, chunk), np.int64)
        block[:, 0] = [toks[b, fed[b] + t] for b in range(B)]
        step.run(block, [f + t for f in fed], [1] * B)
        for b in range(B):
            assert torch.equal(step.last[b], want[fed[b] + t][b])
            assert int(step.next_tok[b]) == int(want[fed[b] + t][b].argmax())
    for pos_name, entry in cache_r.items():
        for name, leaf in entry.items():
            assert torch.equal(leaf, cache_g[pos_name][name]), (pos_name, name)
    if io_r is not None:  # inactive slots' rows count too, so the schedules differ
        assert io_g.h2d_bytes > 0 and io_r.h2d_bytes > 0


# (prompt lengths, chunk): slot 1 starts mid-page, so the two slots cross
# page boundaries at different steps of a chunk; 45 and 38 tokens pass the
# 32-slot ring, which wraps
@pytest.mark.parametrize("layout", ["resident", "paged_flush", "paged_write_through"])
def test_serve_step_driven_as_graph_equals_token_replay(layout):
    _drive_as_graph_against_replay(_cfg(), layout, (45, 38), (0, 0), 7, 5)


# full attention, S = 32 not a multiple of the 7-token chunk: slot 1's
# prompt ends in a 2-token chunk at positions 28-29 while slot 0, admitted
# two ticks later, takes 6; slot 1's inactive steps of that chunk run at
# positions 30-33, past the cache end, and must write nothing
@pytest.mark.parametrize("layout", ["resident", "paged_flush", "paged_write_through"])
def test_serve_step_full_cache_partial_last_chunk_equals_token_replay(layout):
    cfg = dataclasses.replace(_cfg(), sliding_window=0)
    _drive_as_graph_against_replay(cfg, layout, (20, 30), (2, 0), 7, 2)


def test_serve_step_reads_nothing_back():
    """The step's device work calls no op that reads a value to the host
    (``.item()``, ``.tolist()``, ``int(t)``, ``nonzero``): on CUDA each would
    synchronise the stream, and a CUDA graph cannot capture it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    host_reads = {"aten::_local_scalar_dense", "aten::nonzero", "aten::is_nonzero",
                  "aten::masked_select", "aten::item"}
    seen = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    cfg = _cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for layout in ("resident", "paged_flush", "paged_write_through"):
        cache, io = _cache(cfg, layout)
        step = ServeStep(params, cache, cfg, io, batch=B, chunk=4, device="cpu")
        step.tokens.fill_(3)
        step.pos.copy_(torch.tensor([7, 30]))
        step.n_tok.copy_(torch.tensor([4, 2]))
        with Watch(), torch.inference_mode():
            step.step()
    assert seen and not host_reads & set(seen), sorted(host_reads & set(seen))


def test_launch_counts_replayed():
    """A capture's launches are put back and added once per replay."""
    before = build.launch_counts()
    build.add_launches({"rmsnorm": 65, "paged_attention": 32})
    after = build.launch_counts()
    assert after["rmsnorm"] == before["rmsnorm"] + 65
    assert after["paged_attention"] == before["paged_attention"] + 32
    build.set_launch_counts(before)
    assert build.launch_counts() == before


def test_graphs_need_cuda():
    cfg = _cfg()
    cache, io = _cache(cfg, "resident")
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        ServeStep({}, cache, cfg, io, batch=B, chunk=1, device="cpu", graph=True)
