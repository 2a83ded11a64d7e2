"""The port's hybrid (attention + Mamba-2, with MoE) against the JAX
package's, on the CPU.

Reduced ``jamba-1.5-large-398b``: one 8-layer period (Mamba-2 at positions
0-2 and 4-7, attention at 3, MoE at every second layer), d 128, 4 heads of
32 over 4 KV heads, 4 experts top 2, d_state 16, chunk 32, vocab 512; one
superblock, so a plan has 3 chunks and 1 block. Inputs from seeded numpy,
parameters from one JAX init carried across by ``repro_torch.models.convert``.
The helpers and tolerances are ``tests/test_torch_mamba.py``'s:

* the layer stack's hidden states within ``1e-4 * (1 + |jax|)`` (fp32,
  eight layers: measured 2.5e-5 at |h| 13), the aux loss within 1e-6, the
  gradients of every block leaf within ``1e-4 * (1 + max |jax|)``; the decode path's logits and every cache leaf (conv,
  ssm, k, v) within ``1e-5 * (1 + |jax|)``, some slots inactive;
* (training steps: ``tests/test_torch_hybrid_train.py`` and
  ``tests/test_torch_hybrid_offload.py``, split for the test run's workers);
* ``DecodeEngine`` tokens equal to the JAX engine's on a resident plan
  under chunked and replay admission; chunked prefill bitwise equal to
  token replay (logits and cache); the paged engine (the hot ring and cold
  store for the attention position, the Mamba-2 state on the device) equal
  to ``PagedKV(use_kernel=False)``'s and the resident engine's tokens --
  not to the JAX host-paged engine, which fails on the CPU (ROADMAP.md,
  queue 3 B);
* the profiler's matmul FLOPs of the 8-layer superblock exactly the
  reference's, reduced and at full width, and the search equal to the
  reference's on a shared profile.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_mamba import (
    TOL,
    _excess,
    _model,
    jax_trace,
    model_decode_case,
    model_forward_case,
    prompts,
    search_case,
)

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.plan import MemoryPlan as JPlan
from repro.launch.mesh import make_local_mesh
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import profiler as TP
from repro_torch.core.plan import MemoryPlan
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.serve import (
    DecodeEngine,
    PagedKV,
    Request,
    choose_paging,
    init_paged_cache,
    prefill_chunk,
)

import torch_cores

torch_cores.share_cores()

ARCH = "jamba-1.5-large-398b"


def test_hybrid_superblock_layout():
    tc = reduced(get_config(ARCH))
    assert TM.superblock_period(tc) == 8 and TM.num_repeats(tc) == 1
    defs = TM.param_defs(tc)["blocks"]
    assert ["attn" in defs[f"pos{j}"] for j in range(8)] == [j == 3 for j in range(8)]
    assert ["moe" in defs[f"pos{j}"] for j in range(8)] == [j % 2 == 1 for j in range(8)]
    specs = TKV.cache_specs(tc, 2, 16)
    assert set(specs["pos3"]) == {"k", "v"} and set(specs["pos0"]) == {"conv", "ssm"}
    assert specs["pos0"]["ssm"] == ((1, 2, 8, 32, 16), torch.float32)


def test_hybrid_forward_and_gradients_match_jax():
    # eight layers of fp32 sums in another order: 1e-4, the gradients' bound
    model_forward_case(ARCH, 80, h_tol=1e-4)


def test_hybrid_decode_matches_jax():
    model_decode_case(ARCH)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
B, S, CHUNK = 4, 32, 8
SHAPE, JSHAPE = ShapeConfig("serve", S, B, "decode"), JShape("serve", S, B, "decode")


@pytest.mark.parametrize("admission", ["chunked", "replay"])
def test_hybrid_engine_tokens_match_jax_resident(admission):
    jc, tc, jp, tp = _model(ARCH, seed=0)
    kw = dict(admission=admission, prefill_chunk=CHUNK if admission == "chunked" else None)
    jeng = JEngine(jc, JPlan(3, 1, n_persist=3), make_local_mesh(), JSHAPE, jp, **kw)
    jrep = jeng.run([JRequest(*r) for r in prompts()])
    eng = DecodeEngine(tc, MemoryPlan(3, 1, n_persist=3), "cpu", SHAPE, tp, **kw)
    rep = eng.run([Request(*r) for r in prompts()])
    assert rep.drained and jrep.drained
    assert all(len(rep.finished[i]) == 3 + i for i in range(4))
    assert rep.finished == jrep.finished
    assert (rep.prefill_ticks, rep.decode_ticks) == (jrep.prefill_ticks, jrep.decode_ticks)


def test_hybrid_chunked_prefill_equals_token_replay_bitwise():
    """One chunk of up to 8 tokens a slot (slots of 8, 5, 0 and 3) against
    the same tokens fed one decode step at a time with the slot mask: the
    last logits and every cache leaf, conv and ssm among them, bitwise."""
    _, tc, _, tp = _model(ARCH, seed=2)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(1, 512, (B, CHUNK)))
    pos, n_tok = [2, 0, 5, 1], [8, 5, 0, 3]
    a, b = TKV.init_cache(tc, B, S), TKV.init_cache(tc, B, S)
    for c in (a, b):  # a history in every slot first
        for t in range(6):
            TKV.decode_step(tp, c, torch.full((B, 1), 7 + t), torch.full((B,), t), tc)
    last, _ = prefill_chunk(tp, a, toks, pos, n_tok, tc)
    want = torch.zeros_like(last)
    for t in range(CHUNK):
        active = torch.tensor([t < n for n in n_tok])
        logits, _ = TKV.decode_step(tp, b, toks[:, t:t + 1], torch.tensor(pos) + t, tc,
                                    active=active)
        want = torch.where((torch.tensor(n_tok) - 1 == t)[:, None], logits, want)
    assert torch.equal(last, want)
    for p in a:
        for k in a[p]:
            assert torch.equal(a[p][k], b[p][k]), (p, k)


def test_hybrid_paged_engine_matches_plain_and_resident():
    """The paged decode (kernel path and ``PagedKV(use_kernel=False)``)
    against the resident cache step by step past the hot window, then the
    paged engine's tokens against the resident engine's. The Mamba-2 state
    stays in the resident layout on the device; only pos3 is paged."""
    _, tc, _, tp = _model(ARCH, seed=0)
    spec = choose_paging(S, 8, 2)
    assert spec.n_cold > 0
    res = TKV.init_cache(tc, B, S)
    paged = {k: init_paged_cache(tc, B, S, spec) for k in (True, False)}
    assert set(paged[True]["pos3"]) == {"k_hot", "v_hot", "k_cold", "v_cold"}
    assert set(paged[True]["pos0"]) == {"conv", "ssm"}
    ios = {k: PagedKV(spec, use_kernel=k) for k in (True, False)}
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, (B, 28))
    for t in range(28):
        tok, pos = torch.from_numpy(toks[:, t:t + 1]), torch.full((B,), t)
        want, _ = TKV.decode_step(tp, res, tok, pos, tc)
        got = {}
        for k in (True, False):
            got[k], _ = TKV.decode_step(tp, paged[k], tok, pos, tc, kv_io=ios[k])
            assert _excess(got[k], want, TOL["float32"]) <= 0, (t, k)
        assert _excess(got[True], got[False], TOL["float32"]) <= 0, t
    for k in (True, False):
        assert torch.equal(paged[k]["pos0"]["ssm"], paged[not k]["pos0"]["ssm"]) or \
            _excess(paged[k]["pos0"]["ssm"], res["pos0"]["ssm"], TOL["float32"]) <= 0
    reqs = lambda: [Request(*r) for r in prompts()]  # noqa: E731
    resident = DecodeEngine(tc, MemoryPlan(3, 1, n_persist=3), "cpu", SHAPE, tp,
                            prefill_chunk=CHUNK).run(reqs())
    for use_kernel in (True, False):
        eng = DecodeEngine(tc, MemoryPlan(3, 1, n_persist=3, n_host=spec.n_cold), "cpu", SHAPE,
                           tp, paging=spec, prefill_chunk=CHUNK)
        eng.kv_io.use_kernel = use_kernel
        eng.serve_step.kv_io = eng.kv_io
        rep = eng.run(reqs())
        assert rep.finished == resident.finished, use_kernel
        # hot rings and the Mamba-2 state on the device; the cold store on the host
        assert rep.host_cache_bytes == 2 * B * S * 4 * 32 * 4
        if use_kernel:  # (the rebuild path also holds a gathered transient)
            assert rep.hbm_cache_bytes < rep.resident_cache_bytes


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------
# reduced at (B 2, S 64); the full-width 8-layer period at B 1, S 4096 (fake
# tensors: d 8192, 64 over 8 heads, 16 experts of 24,576, SSD heads of 64
# with d_state 128, so the state-to-output einsum takes C times the states
# first, where the reduced config's takes decay times C)
@pytest.mark.parametrize("red,batch,seq", [(True, 2, 64), (False, 1, 4096)])
def test_hybrid_profile_matmul_flops_equal_reference(red, batch, seq):
    jc, tc = jget_config(ARCH), get_config(ARCH)
    if red:
        jc, tc = jreduced(jc), reduced(tc)
    jprof = jax_trace(jc, batch, seq)
    dots = [op.flops for op in jprof.ops if op.name == "dot_general"]
    assert TP.trace_superblock(tc, batch, seq).matmul_flops == sum(dots)


@pytest.mark.parametrize("red,seq,batch", [(True, 64, 2), (True, 256, 1)])
def test_hybrid_search_equals_reference_on_shared_profile(red, seq, batch):
    search_case(ARCH, seq, batch, red)


def test_jamba_full_width_does_not_fit_one_card():
    """One 8-layer period of full-width Jamba: its block chunk holds 44.07 B
    parameters, 88.14 GB of bf16 weights, more than the card's 85.0 GB; with
    the embedding and head 45.14 B, a training state of 722.3 GB at 16 B a
    parameter."""
    from repro_torch.core.chunks import chunk_inventory, model_state_bytes, total_param_count

    cfg = dataclasses.replace(get_config(ARCH), num_layers=8)
    chunks = chunk_inventory(cfg)
    assert len(chunks) == 3 and chunks[1].param_bytes == 88_142_879_232 > 85.0e9
    assert total_param_count(chunks) == 45_144_659_968
    assert model_state_bytes(chunks) == 722_316_678_144
    with pytest.raises(AssertionError):  # no depth below one period
        TM.num_repeats(dataclasses.replace(get_config(ARCH), num_layers=4))


def test_launchers_run_the_reduced_hybrid(capsys):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                              "--seq", "40", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert summary["final_loss"] > summary["final_ce"]  # the MoE layers' aux loss
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--seq-len", "64", "--requests",
                              "2", "--batch-slots", "2", "--max-new", "3", "--prompt-len", "34",
                              "40", "--page-size", "16", "--device", "cpu"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["arch"] == ARCH and served["generated_tokens"] == 6
    # prompts past the 2-page hot window: the attention position reads cold rows
    assert served["admission"] == "chunked" and served["plan"] == "paged"
    assert served["h2d_bytes"] > 0
