"""The encoder-decoder family (``seamless-m4t-large-v2``) and the LayerNorm /
GELU models (``starcoder2-15b``, ``gpt2-1b``) of the port against the JAX
package, at reduced size on the CPU.

Inputs come from seeded numpy or from the JAX ``init``, carried over bit
for bit by ``repro_torch.models.convert``. Comparisons are in fp32, where
the two frameworks differ only in the order of their sums. Tolerances, as
``|port - jax| <= tol * (1 + |jax|)``:

* the forward, the loss and every gradient (the encoder's included): 1e-4
  (cross-attention and ``encode`` alone and the training steps are in
  ``test_torch_encdec_train.py`` and ``test_torch_encdec_offload.py``);
* token-by-token decode over a primed cross cache against the teacher-
  forced forward: 1e-4, resident and paged;
* the planner: chunk inventory and search equal, cost-model floats to
  1e-12, the block profile's matmul FLOPs exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core import autotuner as JA
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.models import kvcache as JKV
from repro.models import layers as JL
from repro.models import model as JM
from repro.train.losses import chunked_cross_entropy as j_ce
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import autotuner as TA
from repro_torch.core import chunks as TCH
from repro_torch.core import profiler as TP
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import kvcache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim.adam import tree_leaves
from repro_torch.serve.paging import PagedKV, choose_paging, init_paged_cache
from repro_torch.train.losses import chunked_cross_entropy

import torch_cores

torch_cores.share_cores()

TOL = 1e-4
SEAMLESS = "seamless-m4t-large-v2"
LR = 3e-3


def _cfgs(arch: str, **kw):
    j = dataclasses.replace(jreduced(jget_config(arch), **kw), dtype="float32")
    t = dataclasses.replace(reduced(get_config(arch), **kw), dtype="float32")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, tol=TOL, what=""):
    a, b = _np(out), _np(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    excess = (np.abs(a - b) - tol * (1.0 + np.abs(b))).max()
    assert excess <= 0.0, f"{what}: max |diff| {np.abs(a - b).max()} beyond {tol}"


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    return {k: _rebuild(tree[k], it) for k in sorted(tree)}


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------
def _def_leaves(defs, prefix=""):
    if hasattr(defs, "shape"):
        return {prefix: (tuple(defs.shape), tuple(defs.axes), defs.init, defs.scale, defs.dtype)}
    out = {}
    for k in sorted(defs):
        out.update(_def_leaves(defs[k], f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("arch", [SEAMLESS, "starcoder2-15b", "gpt2-1b"])
def test_param_defs_equal_jax(arch):
    jc, tc = _cfgs(arch)
    jd, td = _def_leaves(JM.param_defs(jc)), _def_leaves(TM.param_defs(tc))
    assert jd == td
    if arch == SEAMLESS:
        assert "/encoder/blocks/attn/wq" in td and "/blocks/pos0/xattn/wk" in td
        assert td["/encoder/blocks/attn/wq"][0][0] == tc.encoder_layers
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(0)))
    tp = convert.tree_from_numpy(jp)
    back = dict(jax.tree_util.tree_leaves_with_path(convert.tree_to_numpy(tp)))
    for path, a in jax.tree_util.tree_leaves_with_path(jp):  # bit-exact, encoder included
        assert np.array_equal(a.view(np.uint8), back[path].view(np.uint8)), path


def test_full_width_seamless_param_count():
    cfg = get_config(SEAMLESS)
    defs = TM.param_defs(cfg)
    n = sum(np.prod(d[0]) for d in _def_leaves(defs).values())
    assert n == sum(np.prod(d[0]) for d in _def_leaves(JM.param_defs(jget_config(SEAMLESS)))
                    .values()) == 1_632_256_000
    inv = TCH.chunk_inventory(cfg)
    assert [c.name for c in inv[:2]] == ["embed", "superblock0"] and len(inv) == 26
    enc = sum(np.prod(d[0]) for k, d in _def_leaves(defs).items() if k.startswith("/encoder"))
    assert inv[0].param_count == cfg.vocab_size * cfg.d_model + enc


# ---------------------------------------------------------------------------
# Forward, loss and every gradient
# ---------------------------------------------------------------------------
FORWARD_CASES = [  # (arch, S, S_src or None)
    ("starcoder2-15b", 24, None),
    ("gpt2-1b", 24, None),
    (SEAMLESS, 24, None),
    (SEAMLESS, 20, 33),
]


def _batch(jc, s, s_src, seed=1):
    batch = JPipe(jc, JShape("t", s, 2, "train"), seed=seed).next_sync()
    batch = {k: np.asarray(v) for k, v in batch.items()}
    if s_src is not None:
        batch["frames"] = np.random.default_rng(seed).standard_normal(
            (2, s_src, jc.d_model)).astype(np.float32)
    return batch


def _jax_loss(jc):
    def loss(p, b):
        h, _ = JM.forward(p, b, jc)
        h = JL.apply_norm(p["final_norm"], h, jc.norm)
        w = p["embed"]["tok"].T if jc.tie_embeddings else p["head"]["w"]
        return j_ce(h, w, b["labels"], ce_chunk=8), h
    return loss


def _torch_loss(tc, params, batch, runs=None):
    h, _ = TM.forward(params, batch, tc, runs=runs)
    hn = TL.apply_norm(params["final_norm"], h, tc.norm)
    w = params["embed"]["tok"].T if tc.tie_embeddings else params["head"]["w"]
    return chunked_cross_entropy(hn, w, batch["labels"], ce_chunk=8), hn


@pytest.mark.parametrize("arch,s,s_src", FORWARD_CASES)
def test_forward_loss_and_grads_match_jax(arch, s, s_src):
    jc, tc = _cfgs(arch)
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(4)))
    batch = _batch(jc, s, s_src)
    (jloss, jh), jgrads = jax.value_and_grad(_jax_loss(jc), has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.tree_from_numpy(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, hn = _torch_loss(tc, params, tb)
    grads = torch.autograd.grad(loss, leaves)
    _close(hn, jh, what="normed hidden")
    _close(loss, jloss, what="loss")
    want = tree_leaves(convert.tree_from_numpy(jax.device_get(jgrads)))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        _close(g, w, what="grad")
    if arch == SEAMLESS:  # the encoder learns from the decoder
        enc = tree_leaves(_rebuild(params, iter(grads))["encoder"])
        assert all(float(g.abs().max()) > 0 for g in enc)


# ---------------------------------------------------------------------------
# Decode over a primed cross cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["resident", "paged"])
def test_decode_over_primed_cache_equals_teacher_forced_forward(layout):
    jc, tc = _cfgs(SEAMLESS)
    seq = 16
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(7)))
    batch = _batch(jc, seq, None, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jh, _ = JM.forward(jp, jbatch, jc, attn_impl="naive")
    jlogits = JM.lm_head(jp, jh, jc)
    params = convert.tree_from_numpy(jp)
    memory = TM.encode(params, torch.from_numpy(batch["frames"]), tc)
    _close(memory, JM.encode(jp, jbatch["frames"], jc), what="memory")
    if layout == "resident":
        cache, kv_io = TKV.init_cache(tc, 2, seq), None
    else:
        spec = choose_paging(seq, 4, 2)
        cache, kv_io = init_paged_cache(tc, 2, seq, spec), PagedKV(spec)
        assert cache["pos0"]["xk"].shape == (2, 2, seq, tc.num_kv_heads, 32)
    xk = {name: e["xk"] for name, e in cache.items()}
    TKV.prime_cross_cache(params, memory, cache, tc)
    assert all(cache[n]["xk"] is t for n, t in xk.items())  # written in place
    # the priming of tests/test_models_smoke.py, in JAX
    r = JM.num_repeats(jc)
    ap = jp["blocks"]["pos0"]["xattn"]
    want = jnp.einsum("bsd,rdk->rbsk", JM.encode(jp, jbatch["frames"], jc), ap["wk"])
    _close(cache["pos0"]["xk"], want.reshape(r, 2, seq, jc.num_kv_heads, 32), what="xk")
    outs = []
    with torch.inference_mode():
        for t in range(seq):
            logits, cache = TKV.decode_step(params, cache, torch.from_numpy(
                batch["tokens"][:, t:t + 1].astype(np.int64)), t, tc, kv_io=kv_io)
            outs.append(logits)
    _close(torch.stack(outs, 1), jlogits, what="decode vs teacher-forced")


def test_jax_cache_specs_equal_port():
    jc, tc = _cfgs(SEAMLESS)
    jspecs = JKV.cache_specs(jc, 3, 40)
    tspecs = TKV.cache_specs(tc, 3, 40)
    assert {p: {k: tuple(v.shape) for k, v in e.items()} for p, e in jspecs.items()} == \
        {p: {k: shape for k, (shape, _) in e.items()} for p, e in tspecs.items()}


# ---------------------------------------------------------------------------
# Data, planner, launchers
# ---------------------------------------------------------------------------
def test_pipeline_frames_equal_jax():
    jc, tc = _cfgs(SEAMLESS)
    bf = dataclasses.replace(tc, dtype="bfloat16")
    jp = JPipe(jc, JShape("t", 12, 2, "train"), seed=5)
    tp = SyntheticTokenPipeline(tc, ShapeConfig("t", 12, 2, "train"), seed=5)
    tpb = SyntheticTokenPipeline(bf, ShapeConfig("t", 12, 2, "train"), seed=5)
    for _ in range(2):
        jb, tb, tbb = jp.next_sync(), tp.next_sync(), tpb.next_sync()
        assert set(tb) == {"tokens", "labels", "frames"}
        for key in tb:
            np.testing.assert_array_equal(_np(tb[key]), np.asarray(jb[key]))
        assert tbb["frames"].dtype == torch.bfloat16
        assert torch.equal(tbb["frames"], tb["frames"].to(torch.bfloat16))


PLANNER_CASES = [(True, 64, 2, "cpu-host"), (False, 32768, 1, "h100-sxm")]


@pytest.mark.parametrize("red,seq,batch,hw", PLANNER_CASES)
def test_seamless_chunks_profile_and_search_equal_reference(red, seq, batch, hw):
    """The front chunk holds the embedding and the encoder, as the
    reference's; the block profile leaves out the cross-attention and the
    encoder, as the reference's does (``apply_superblock`` without
    ``memory``), and the search on the reference's profile picks the
    reference's plan."""
    from test_torch_planner import _close as close_12, _jax_trace, _pair, _result

    jw, tw = _pair(SEAMLESS, seq, batch, "gpu1", hw, red)
    assert tw.chunks[0].param_count == jw.chunks[0].param_count
    if red:
        jc, tc = jw.cfg, tw.cfg
        jprof, tprof = _jax_trace(jc, batch, seq), TP.trace_superblock(tc, batch, seq)
        assert tprof.matmul_flops == sum(op.flops for op in jprof.ops
                                         if op.name == "dot_general")
    close_12(_result(JA.search(jw, compress="off", sync="xla")),
             _result(TA.search(tw, compress="off", sync="xla")))


def test_launchers_run_seamless_on_the_cpu(capsys):
    rc = launch_train.main(["--arch", SEAMLESS, "--reduced", "--steps", "2", "--batch", "2",
                            "--seq", "32", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[train] searched plan:" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    rc = launch_serve.main(["--arch", SEAMLESS, "--reduced", "--seq-len", "64", "--prompt-len",
                            "5", "20", "--page-size", "16", "--max-new", "4", "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["drained"] and summary["plan"] == "paged"


def test_engine_tokens_match_jax_engine_over_zero_cross_cache():
    """The engines serve an encoder-decoder's decoder over the cross cache
    ``init_cache`` makes, zeros (admission zeroes every leaf of a slot, and
    nothing fills it from frames), and give the same greedy tokens."""
    from repro.launch.mesh import make_local_mesh
    from repro.serve import DecodeEngine as JEngine
    from repro.serve import Request as JRequest
    from repro_torch.serve import DecodeEngine, Request

    jc, tc = _cfgs(SEAMLESS)
    jp = JM.init_params(jc, jax.random.PRNGKey(8))
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(1, 512, int(n)).tolist(), 3 + i)
            for i, n in enumerate(rng.integers(3, 13, 3))]
    jrep = JEngine(jc, JPlan(4, 2, n_persist=4), make_local_mesh(),
                   JShape("serve", 32, 2, "decode"), jp, admission="chunked",
                   prefill_chunk=8).run([JRequest(*r) for r in reqs])
    eng = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu",
                       ShapeConfig("serve", 32, 2, "decode"),
                       convert.tree_from_numpy(jax.device_get(jp)), admission="chunked",
                       prefill_chunk=8)
    assert eng.state["cache"]["pos0"]["xk"].shape == (2, 2, 32, tc.num_kv_heads, 32)
    rep = eng.run([Request(*r) for r in reqs])
    assert rep.drained and jrep.drained and rep.finished == jrep.finished
    assert not any(float(e["xk"].abs().max()) for e in eng.state["cache"].values())


@pytest.mark.parametrize("seq", [64, 300])
def test_seamless_block_keeps_no_more_than_reference_residuals(seq):
    """What autograd keeps for one decoder block with its cross-attention
    (``scripts/saved_bytes_census.py``, memory of ``seq`` rows) is no more
    than the reference's residuals of the same block with ``memory``
    (``profile_fn`` of ``apply_superblock``): the port keeps no copy the
    reference's remat does not."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "scripts"))
    from saved_bytes_census import census

    from repro.core import profiler as JP

    jc, tc = jreduced(jget_config(SEAMLESS)), reduced(get_config(SEAMLESS))
    defs = JM.param_defs(jc)["blocks"]
    one = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape[1:], jnp.dtype(d.dtype)), defs,
                       is_leaf=lambda x: hasattr(x, "axes"))
    x = jax.ShapeDtypeStruct((1, seq, jc.d_model), jnp.dtype(jc.dtype))
    ref = JP.profile_fn(lambda p, x, m: JM.apply_superblock(p, x, jc, memory=m)[0], one, x, x,
                        weight_args=(0,)).residual_act_bytes
    got = census(tc, 1, seq)
    assert 0 < got["kept_bytes"] <= ref, (got, ref)


def test_full_width_block_profile_at_32k():
    """seamless-m4t-large-v2's block at B 1, S 32,768 (``encdec_plan``'s
    shape): the port's matmul FLOPs equal the reference's, its residuals
    come within the stated band of the reference's, and the reference's
    profile is the one ``chip_smoke.py`` prints beside the port's."""
    import importlib.util
    import pathlib

    from repro.core import profiler as JP
    from test_torch_planner import _jax_trace

    jc, tc = jget_config(SEAMLESS), get_config(SEAMLESS)
    tprof = TP.trace_superblock(tc, 1, 32768)
    assert tprof.matmul_flops == sum(
        op.flops for op in _jax_trace(jc, 1, 32768).ops if op.name == "dot_general")
    # the plain attention's 32 KV blocks count their residuals once, as the
    # reference's scan body: port (activations + weights) over reference
    # measured 0.901 (19.3 while each block's counted apart)
    resid = tprof.residual_act_bytes + tprof.residual_weight_bytes
    assert 0.85 <= resid / JP.profile_superblock(jc, 1, 32768).act_residual_bytes <= 1.1
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert dataclasses.asdict(JP.profile_superblock(jc, 1, 32768)) == \
        smoke.REFERENCE_ENCDEC_PROFILE
