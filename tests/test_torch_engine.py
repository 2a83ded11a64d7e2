"""The port's scheduler and ``DecodeEngine`` against the JAX package's.

The scheduler property tests are those of tests/test_serve_paging.py:130-199,
run on the port's copy. The engine runs reduced ``mistral-7b`` (GQA kept,
``num_kv_heads=2``) in fp32 on the CPU, with the JAX engine's parameters
carried across: its greedy tokens equal the JAX engine's on a resident
1-device plan under chunked, whole and replay admission, and its paged plan
gives the tokens of its resident plan.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.plan import MemoryPlan as JPlan
from repro.launch.mesh import make_local_mesh
from repro.models import model as JM
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch import obs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.models.convert import tree_from_numpy
from repro_torch.serve import (
    ContinuousScheduler,
    DecodeEngine,
    PagePool,
    Request,
    choose_paging,
)

B, S, CHUNK = 2, 32, 8


# ---------------------------------------------------------------------------
# Scheduler properties: no slot/page leaks across admit/evict/finish cycles
# ---------------------------------------------------------------------------
def _check_invariants(sched: ContinuousScheduler, submitted: set[int]):
    pool = sched.pool
    held = sum(pool.held_by(b) for b in range(sched.n_slots))
    assert pool.n_free + held == pool.n_pages, "page leak"
    assert len(pool._owner) == held, "orphaned page ownership"
    for b, s in enumerate(sched.slots):
        if s is None:
            assert pool.held_by(b) == 0, f"freed slot {b} still owns pages"
        else:
            assert pool.held_by(b) >= 1, f"live slot {b} owns no pages"
    live = {s.rid for s in sched.slots if s is not None}
    queued = {r.rid for r in sched.queue}
    done = set(sched.finished) | set(sched.rejected)
    assert live | queued | done == submitted, "request leaked or invented"
    assert not (live & done) and not (queued & done), "request in two states"


@settings(max_examples=30, deadline=None)
@given(
    n_slots=st.integers(min_value=1, max_value=4),
    pool_pages=st.integers(min_value=1, max_value=12),
    page_size=st.integers(min_value=1, max_value=4),
    reqs=st.lists(
        st.tuples(st.integers(min_value=1, max_value=5),   # prompt len
                  st.integers(min_value=1, max_value=6)),  # max_new
        min_size=1, max_size=8),
    evict_every=st.integers(min_value=0, max_value=5),
)
def test_scheduler_no_slot_or_page_leaks(n_slots, pool_pages, page_size, reqs, evict_every):
    sched = ContinuousScheduler(n_slots, PagePool(pool_pages), page_size, 16)
    submitted = set()
    for i, (pl, mn) in enumerate(reqs):
        sched.submit([Request(i, list(range(1, pl + 1)), mn)])
        submitted.add(i)
    for step in range(200):
        if sched.idle:
            break
        sched.admit()
        _check_invariants(sched, submitted)
        toks, _, _ = sched.step_inputs()
        sched.advance([t + 1 for t in toks])
        if evict_every and step % evict_every == evict_every - 1:
            sched._evict_youngest()
        _check_invariants(sched, submitted)
    assert sched.idle, "scheduler failed to drain"
    assert set(sched.finished) | set(sched.rejected) == submitted


def test_scheduler_finishes_exact_token_counts():
    sched = ContinuousScheduler(2, PagePool(8), 4, 16)
    sched.submit([Request(0, [1, 2, 3], 4), Request(1, [5], 2), Request(2, [9, 9], 3)])
    for _ in range(100):
        if sched.idle:
            break
        sched.admit()
        toks, _, _ = sched.step_inputs()
        sched.advance([t + 1 for t in toks])
    assert {k: len(v) for k, v in sched.finished.items()} == {0: 4, 1: 2, 2: 3}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(reduced(get_config("mistral-7b"), num_kv_heads=2),
                              dtype="float32")
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, jp, tree_from_numpy(jax.device_get(jp))


def _prompts():
    rng = np.random.default_rng(5)
    return [(i, rng.integers(1, 512, int(n)).tolist(), 4 + i)
            for i, n in enumerate(rng.integers(3, 13, 4))]


def _port_engine(cfg, tp, paged=False, **kw):
    shape = ShapeConfig("serve", S, B, "decode")
    if not paged:
        return DecodeEngine(cfg, MemoryPlan(3, 2, n_persist=3), "cpu", shape, tp, **kw)
    spec = choose_paging(S, 8, 2)
    assert spec.n_cold > 0
    plan = MemoryPlan(3, 2, n_persist=3, n_host=spec.n_cold)
    return DecodeEngine(cfg, plan, "cpu", shape, tp, paging=spec, **kw)


@pytest.mark.parametrize("mode", ["chunked", "whole", "replay"])
def test_engine_tokens_match_jax_resident(model, mode):
    cfg, jp, tp = model
    jeng = JEngine(cfg, JPlan(3, 2, n_persist=3), make_local_mesh(),
                   JShape("serve", S, B, "decode"), jp, admission=mode,
                   prefill_chunk=CHUNK if mode != "replay" else None)
    jrep = jeng.run([JRequest(*r) for r in _prompts()])
    chunk = CHUNK if mode != "replay" else None
    rep = _port_engine(cfg, tp, admission=mode, prefill_chunk=chunk).run(
        [Request(*r) for r in _prompts()])
    assert rep.drained and jrep.drained
    assert set(rep.finished) == {0, 1, 2, 3}
    assert all(len(rep.finished[i]) == 4 + i for i in range(4))
    assert rep.finished == jrep.finished
    assert (rep.prefill_ticks, rep.decode_ticks) == (jrep.prefill_ticks, jrep.decode_ticks)


def test_engine_paged_plan_matches_resident_plan(model):
    cfg, _, tp = model
    reqs = lambda: [Request(*r) for r in _prompts()]  # noqa: E731
    res = _port_engine(cfg, tp, prefill_chunk=CHUNK).run(reqs())
    tel = obs.Telemetry()
    paged = _port_engine(cfg, tp, paged=True, prefill_chunk=CHUNK, telemetry=tel)
    paged.warmup()
    rep = paged.run(reqs())
    assert rep.finished == res.finished
    assert rep.host_cache_bytes > 0 and rep.hbm_cache_bytes < rep.resident_cache_bytes
    # the instrumentation emits the documented series, and spans per tick
    assert tel.registry.names() <= set(obs.DOCUMENTED_METRICS)
    snap = tel.registry.snapshot()
    assert snap["serve.h2d_bytes"]["value"] > 0
    assert snap["serve.generated_tokens"]["value"] == rep.generated_tokens
    spans = [e["name"] for e in tel.tracer.events]
    assert spans.count("serve.prefill_tick") == rep.prefill_ticks


def test_engine_stream_yields_every_token(model):
    cfg, _, tp = model
    eng = _port_engine(cfg, tp, paged=True, prefill_chunk=CHUNK)
    events = list(eng.stream([Request(*r) for r in _prompts()]))
    by_rid: dict[int, list] = {}
    for ev in events:
        by_rid.setdefault(ev.rid, []).append(ev)
    rep = eng.report()
    assert set(by_rid) == set(rep.finished)
    for rid, evs in by_rid.items():
        assert [e.index for e in evs] == list(range(len(rep.finished[rid])))
        assert [e.token for e in evs] == rep.finished[rid]
        assert [e.finished for e in evs] == [False] * (len(evs) - 1) + [True]


def test_engine_refuses_what_this_slice_lacks(model):
    cfg, _, tp = model
    shape = ShapeConfig("serve", S, B, "decode")
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(cfg, MemoryPlan(3, 2, n_persist=3), "cpu", shape, tp)
    with pytest.raises(NotImplementedError, match="all-persistent"):
        DecodeEngine(cfg, MemoryPlan(3, 2, n_persist=0), "cpu", shape, tp,
                     prefill_chunk=CHUNK)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeEngine(cfg, MemoryPlan(3, 2, n_persist=3), None, shape, tp,
                         prefill_chunk=CHUNK)
