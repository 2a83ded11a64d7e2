"""Serving on a mesh: the decode step, the chunked prefill that admits
prompts (``DecodeEngine``), the stateless full-sequence prefill and
``launch.serve`` over data x model ranks, at 4 gloo ranks, against the
JAX package run on one device.

Every family in fp32 at reduced size, each model's parameters carried from
its JAX init by ``repro_torch.models.convert`` (``torch_dist_ranks``:
``DECODE_CASES``, ``ENGINE_CASES``, ``PREFILL_CASES``):

* the decode step's logits, teacher-forced over ``SERVE_STEPS`` tokens
  with per-slot active masks, against the JAX one-device decode
  (``repro.models.kvcache.decode_step``, the function
  ``build_decode_step`` runs) at ``TOL``: reduced ``mistral-7b`` (2 KV
  heads) at 1 x 4, 2 x 2 and 4 x 1 with a resident and a paged cache
  (``PagedKV(use_kernel=False)``), and at 4 x 1 and 2 x 2 under
  ``n_persist = 0`` (every chunk ZeRO-sharded over the data ranks and
  gathered at use: a weight placement does not change the function, so
  the reference is the resident decode); ``qwen2-moe-a2.7b``,
  ``mamba2-130m``, the reduced Jamba hybrid, ``seamless-m4t-large-v2``
  over a cross cache primed from ``encode`` and ``llava-next-34b`` at
  1 x 4 and 2 x 2; a llava with 6 query heads, a Mamba-2 with 6 SSD
  heads and a seamless with 6 heads at 1 x 4, where the sublayers run
  replicated;
* ``DecodeEngine`` on a mesh gives the JAX one-device engine's tokens on
  the resident plan: chunked admission at 2 x 2, also with 3 slots over 2
  data ranks (every data rank then holds every slot), and replay for
  ``mamba2-130m`` at 1 x 4;
* the stateless prefill's whole (B, V) logits at 2 x 2 for llava (its
  patches; also under ``n_persist = 0``) and seamless (its frames) against
  the JAX ``build_prefill_step`` at ``TOL``;
* the repairs in training: the 6-head llava, Mamba-2 and seamless (also
  under ``seq_shard_acts``) at 1 x 4 against the JAX one-device step
  (``test_torch_tp.py``'s machinery, 3 steps);
* the greedy argmax over the model group equals ``torch.argmax`` of the
  whole rows, ties included;
* ``launch.serve --nproc 4 --model 2 --device cpu`` prints one JSON line.

The 4 ranks (``torch_dist_ranks.serve_mesh``) start once for the module and
run while the JAX references are computed.
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.plan import MemoryPlan as JPlan
from repro.launch.mesh import make_local_mesh as j_local_mesh
from repro.models import kvcache as JKV
from repro.models import model as JM
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro.train.step_builder import build_prefill_step as j_prefill
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.serve.prefill import ServeStep

import torch_dist_ranks as R
from test_torch_dist_xla import TOL, _close, _masters_close
from test_torch_tp import _jax_ref, _jax_step

import torch_cores

torch_cores.share_cores()


def _jcfg(model: str):
    return R.tp_overrides(jreduced(jget_config(R.TP_MODELS[model][0]), dtype="float32"), model)


def _jax_decode(model: str, jp) -> np.ndarray:
    """The JAX one-device decode over ``serve_inputs``: (steps, B, V)."""
    jc = _jcfg(model)
    cache = JKV.init_cache(jc, R.SERVE_B, R.SERVE_S)
    if jc.kind == "encdec":  # prime the cross cache from the encoder's output
        memory = JM.encode(jp, jnp.asarray(R.serve_frames(jc)), jc)
        r, hd = JM.num_repeats(jc), jc.resolved_head_dim
        for name, entry in cache.items():
            ap = jp["blocks"][name]["xattn"]
            for leaf, w in (("xk", ap["wk"]), ("xv", ap["wv"])):
                entry[leaf] = jnp.einsum("bsd,rdk->rbsk", memory, w).reshape(
                    r, R.SERVE_B, R.SERVE_S, jc.num_kv_heads, hd)
    step = jax.jit(lambda p, c, tok, pos, act: JKV.decode_step(p, c, tok, pos, jc, active=act))
    toks, active = R.serve_inputs(jc.vocab_size)
    outs = []
    for t in range(R.SERVE_STEPS):
        logits, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.full((R.SERVE_B,), t), jnp.asarray(active[t]))
        outs.append(np.asarray(logits))
    return np.stack(outs)


def _jax_engine(model: str, jp, slots: int, admission: str) -> dict:
    jc = _jcfg(model)
    n = JM.num_repeats(jc)
    eng = JEngine(jc, JPlan(n + 2, n, n_persist=n + 2), j_local_mesh(),
                  JShape("serve", R.ENGINE_S, slots, "decode"), jp, admission=admission,
                  prefill_chunk=R.ENGINE_CHUNK if admission != "replay" else None)
    rep = eng.run([JRequest(*r) for r in R.prompts(4)])
    assert rep.drained
    return {"finished": rep.finished, "ticks": (rep.prefill_ticks, rep.decode_ticks)}


def _jax_prefill(model: str, jp) -> np.ndarray:
    jc = _jcfg(model)
    n = JM.num_repeats(jc)
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    art = j_prefill(jc, JPlan(n + 2, n, n_persist=n + 2), mesh,
                    JShape("p", R.PREFILL_S, R.PREFILL_B, "prefill"))
    return np.asarray(art.fn(jp, {k: jnp.asarray(v) for k, v in R.prefill_batch(jc).items()}))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The 4 ranks, started first, and the JAX references computed while
    they serve: (JAX results, ranks' results)."""
    d = str(tmp_path_factory.mktemp("serve_mesh"))
    jparams = {m: jax.device_get(JM.init_params(_jcfg(m), jax.random.PRNGKey(0)))
               for m in R.SERVE_MODELS}
    refs = {c: f"{R.REPAIR_CASES[c][0]}_{R.REPAIR_CASES[c][1]}" for c in R.REPAIR_CASES}
    steps = {r: _jax_step(r) for r in set(refs.values())}
    path = f"{d}/params.pt"
    torch.save({"serve": {m: convert.tree_from_numpy(p) for m, p in jparams.items()},
                "train": {c: convert.tree_from_numpy(jax.device_get(steps[r][2]["params"]))
                          for c, r in refs.items()}}, path)
    wait = R.start_ranks("serve_mesh", d, path)
    trained = {r: _jax_ref(*st) for r, st in steps.items()}
    ref = {"decode": {m: _jax_decode(m, jparams[m]) for m in R.SERVE_MODELS},
           "engine": {c: _jax_engine(m, jparams[m], slots, adm)
                      for c, (m, _, slots, adm) in R.ENGINE_CASES.items()},
           "prefill": {m: _jax_prefill(m, jparams[m])
                       for m in {m for m, _, _ in R.PREFILL_CASES.values()}},
           "train": {c: trained[r] for c, r in refs.items()}}
    return ref, wait()


@pytest.fixture(scope="module")
def jax_ref(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


@pytest.mark.parametrize("case", sorted(R.DECODE_CASES))
def test_decode_logits_hold_jax(ranks, jax_ref, case):
    """Each step's logits, made whole over the vocab and the slots, against
    the JAX one-device decode at ``TOL``; every rank holds the same."""
    model = R.DECODE_CASES[case][0]
    got = ranks[0]["decode"][case]["logits"]
    _close(got, jax_ref["decode"][model], TOL, case)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["decode"][case]["logits"], got)


@pytest.mark.parametrize("case", sorted(R.DECODE_CASES))
def test_decode_cache_is_the_ranks(ranks, case):
    """A rank's cache holds its slots (B / data) and its KV and SSD heads;
    only a sharded-weight plan gathers."""
    model, (data, m), kind = R.DECODE_CASES[case]
    cfg = R.tp_config(model)[0]
    tp = types.SimpleNamespace(size=m, rank=0)
    for rank, out in enumerate(ranks):
        run = out["decode"][case]
        n = R.SERVE_B // data
        assert run["slots"] == ((rank // m) * n, n)
        assert run["gathered"] == (kind == "sharded")
        for entry in run["cache_shapes"].values():
            for name, shape in entry.items():
                assert shape[1] == n, (name, shape)
                if name in ("k", "v", "k_cold", "v_cold", "k_hot", "xk"):
                    assert shape[3] == L.rank_kv_heads(cfg, tp if m > 1 else None)
                if name == "ssm":
                    heads = M2.mamba2_dims(cfg)[1]
                    split = M2.rank_heads(cfg, tp)
                    assert shape[2] == (heads if split is None else split[1])


@pytest.mark.parametrize("case", sorted(R.ENGINE_CASES))
def test_engine_tokens_equal_jax(ranks, jax_ref, case):
    """``DecodeEngine(mesh=...)``: every rank's greedy tokens and ticks are
    the JAX one-device engine's; no rank captures a graph."""
    ref = jax_ref["engine"][case]
    for out in ranks:
        run = out["engine"][case]
        assert run["drained"] and run["graph"] is None
        assert run["finished"] == ref["finished"]
        assert run["ticks"] == ref["ticks"]
    slots = R.ENGINE_CASES[case][2]
    data = R.ENGINE_CASES[case][1][0]
    rep = ranks[0]["engine"][case]["report"]
    assert rep["world"] == 4
    assert rep["hbm_cache_bytes_ranks"] == 4 * rep["hbm_cache_bytes_rank"]
    n = slots // data if slots % data == 0 else slots
    assert ranks[0]["engine"][case]["slots"] == (0, n)


@pytest.mark.parametrize("case", sorted(R.PREFILL_CASES))
def test_prefill_logits_hold_jax(ranks, jax_ref, case):
    """The stateless prefill's whole (B, V) logits on every rank against
    the JAX ``build_prefill_step`` at ``TOL``."""
    model = R.PREFILL_CASES[case][0]
    for out in ranks:
        got = out["prefill"][case]["logits"]
        assert got.shape == (R.PREFILL_B, R.tp_config(model)[0].vocab_size)
        _close(got, jax_ref["prefill"][model], TOL, case)


@pytest.mark.parametrize("case", sorted(R.REPAIR_CASES))
def test_repairs_train_hold_jax(ranks, jax_ref, case):
    """Heads the model extent does not divide run replicated: 3 training
    steps at 1 x 4 against the JAX one-device step at ``TOL`` (losses,
    grad norms, the fp32 masters made whole); every rank agrees bitwise."""
    runs = [r["train"][case] for r in ranks]
    ref = jax_ref["train"][case]
    _close(runs[0]["losses"], ref["losses"], TOL, "losses")
    _close(runs[0]["norms"], ref["norms"], TOL, "grad norms")
    _masters_close(runs[0]["master"], ref["master"], TOL, case)
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"] and r["norms"] == runs[0]["norms"]


def test_argmax_over_the_model_group_equals_torch_argmax(ranks):
    """``vocab_argmax`` over 2 and 4 model ranks: the largest value, the
    lowest index on ties, as ``torch.argmax`` of the whole rows."""
    for out in ranks:
        for m, (got, want) in out["argmax"].items():
            np.testing.assert_array_equal(got, want, err_msg=f"model {m}")


def test_heads_that_do_not_split_no_longer_raise():
    """At the production mesh's model extent of 16, llava-next-34b's 56
    query heads and mamba2-130m's 24 SSD heads do not split: the sublayers
    run replicated (and mistral-7b's 32 over 8 split, 2 a rank over one
    shared KV head)."""
    tp = types.SimpleNamespace(size=16, rank=3)
    llava, mamba = get_config("llava-next-34b"), get_config("mamba2-130m")
    assert not L.heads_split(llava, tp) and L.rank_kv_heads(llava, tp) == 8
    assert M2.rank_heads(mamba, tp) is None
    mistral = get_config("mistral-7b")
    assert L.heads_split(mistral, tp) and L.tp_heads(mistral, tp) == (6, 2, 1)
    assert L.rank_kv_heads(mistral, tp) == 1
    six = dataclasses.replace(llava, num_heads=6, num_kv_heads=2)
    assert not L.heads_split(six, types.SimpleNamespace(size=4, rank=0))


def test_serve_step_graph_needs_one_rank():
    """A CUDA graph is captured only at a world of one."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeStep({}, {}, None, None, batch=4, chunk=1, device="cpu", graph=True,
                  layout=types.SimpleNamespace(world=2))


@pytest.mark.parametrize("plan", ["paged", "auto"])
def test_launch_serve_nproc_prints_one_json_line(capsys, plan):
    """``launch.serve --nproc 4 --model 2 --device cpu``: 4 spawned gloo
    ranks at data 2 x model 2 serve the reduced mistral-7b, paged or under
    ``core.serve_plan``'s choice for a device whose memory (``--hbm-gb``)
    the weights overflow: every chunk ZeRO-sharded over the data ranks
    (n_persist=0); rank 0 prints one JSON line."""
    extra = ["--hbm-gb", "0.0005"] if plan == "auto" else []
    rc = launch_serve.main(["--arch", "mistral-7b", "--reduced", "--nproc", "4", "--model",
                            "2", "--seq-len", "64", "--prompt-len", "34", "40",
                            "--page-size", "16", "--max-new", "4", "--device", "cpu",
                            "--plan", plan, *extra])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("{") for line in lines) == 1
    summary = json.loads(lines[-1])
    assert summary["world"] == 4 and summary["model"] == 2 and summary["drained"]
    assert summary["plan"] == plan and summary["generated_tokens"] == 16
    if plan == "paged":  # prompts past the 2-page hot window: cold reads on every rank
        assert summary["h2d_bytes_ranks"] >= summary["h2d_bytes_rank"] > 0
    else:
        assert summary["n_persist"] == 0 and summary["host_cache_bytes"] == 0
