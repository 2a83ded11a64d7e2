"""The port's MoE family against the JAX package's, on the CPU.

Reduced ``qwen2-moe-a2.7b`` (4 experts, top 2, 4 shared experts, d 128, 2
layers, vocab 512): inputs from seeded numpy, parameters from one JAX init
carried across bit for bit by ``repro_torch.models.convert``. Tolerances:

* ``apply_moe``: routing indices and dropped choices equal; outputs within
  ``1e-5 * (1 + |jax|)`` in fp32 and ``2e-2 * (1 + |jax|)`` in bf16 (the
  expert products round to bf16 in each framework's order); the aux loss
  within 1e-6; the gradients of x, the router and every expert weight
  within ``1e-5 * (1 + max |jax|)`` of each leaf in fp32 and ``2e-2 * (1 +
  max |jax|)`` in bf16. At ``capacity_factor`` 8.0 (the drop-free setting
  of ``reduced()``), at the real config's 1.25 with choices dropped, where
  the cumsum's token-major order decides which, and on ties, where
  ``lax.top_k`` puts the lower index first; reduced ``mixtral-8x22b`` (no
  shared experts, a sliding window): the layer stack's hidden states and
  aux loss as above, its gradients within ``1e-4 * (1 + max |jax|)`` (two
  layers of fp32 sums in another order);
* two training steps against the JAX step (fp32) under ``none``,
  ``checkpoint`` (2 microbatches), ``compress8``, ``swap`` and host-weight
  plans: losses, cross-entropies and gradient norms within ``1e-4 * (1 +
  |jax|)``, each leaf's Adam update within ``UPDATE_TOL`` in relative L2
  (a quantizing plan's looser bound, as in tests/test_torch_policies.py);
* ``DecodeEngine`` tokens equal to the JAX engine's on a resident plan, at
  the drop-free capacity and at a capacity of one row an expert (the real
  config's at decode: ``ceil(4 * 4 * 1.25 / 60)`` = 1), where inactive
  slots of a chunked-prefill step take capacity; the paged cache gives the
  resident cache's logits within 1e-5 through ``PagedKV`` and
  ``PagedKV(use_kernel=False)``;
* the profiler's matmul FLOPs of a MoE superblock exactly the reference's,
  and the cost models and search equal to the reference's on a shared
  profile (1e-12 relative).
"""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core import autotuner as JA
from repro.core import cost_model as JCM
from repro.core import hardware as JH
from repro.core import profiler as JP
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.launch.mesh import make_local_mesh
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim.adam import AdamConfig as JAdam
from repro.serve import DecodeEngine as JEngine
from repro.serve import Request as JRequest
from repro.train.step_builder import build_train_step as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import autotuner as TA
from repro_torch.core import cost_model as TCM
from repro_torch.core import hardware as TH
from repro_torch.core import profiler as TP
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.offload import proxy_like
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.serve import DecodeEngine, PagedKV, Request, choose_paging, init_paged_cache
from repro_torch.train.step_builder import build_train_step

import torch_cores

torch_cores.share_cores()

ARCH = "qwen2-moe-a2.7b"
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STEP_TOL = 1e-4
UPDATE_TOL = {True: 1e-1, False: 1e-3}
LR = 3e-3


def _cfgs(dtype="float32", cf=None):
    jc, tc = jreduced(jget_config(ARCH), dtype=dtype), reduced(get_config(ARCH), dtype=dtype)
    if cf is not None:
        jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=cf))
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=cf))
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _excess(out, ref, tol, scale=None) -> float:
    """Largest |out - ref| beyond ``tol * (1 + scale)`` (<= 0 passes);
    ``scale`` defaults to |ref| elementwise."""
    a, b = _np(out), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.abs(b) if scale is None else scale
    return float((np.abs(a - b) - tol * (1.0 + scale)).max())


# ---------------------------------------------------------------------------
# apply_moe: routing, drops, output, aux loss, gradients
# ---------------------------------------------------------------------------
def _moe_params(jc, seed=0, router_bias=0.0):
    """One MoE layer's JAX parameters (fp32 router, the rest in the config's
    dtype) and the port's copy. ``router_bias`` adds to the router's weight
    from x's feature 0 to expert 0, so that with that feature set, more
    choices go to expert 0 than its capacity holds."""
    jp = JL.init_tree(JMOE.moe_defs(jc), jax.random.PRNGKey(seed))
    jp = {k: v if k == "router" else v.astype(jnp.dtype(jc.dtype)) for k, v in jp.items()}
    if router_bias:
        jp["router"] = jp["router"].at[0, 0].add(router_bias)
    return jp, convert.tree_from_numpy(jax.device_get(jp))


def _routing(jc, jp, x):
    """The reference's routing of x: (indices (T, k), within-capacity mask
    (T, k, E)), as ``apply_moe`` computes them."""
    t = x.shape[0] * x.shape[1]
    logits = jnp.asarray(x).reshape(t, -1).astype(jnp.float32) @ jp["router"]
    _, idx, one_hot, _ = JMOE._top_k_gating(logits, jc.moe.top_k)
    cap = max(math.ceil(jc.moe.top_k * t * jc.moe.capacity_factor / jc.moe.num_experts), 1)
    pos = jnp.cumsum(one_hot.reshape(t * jc.moe.top_k, -1), axis=0).reshape(one_hot.shape) - 1
    return np.asarray(idx), np.asarray((pos < cap) & (one_hot > 0))


def _port_routing(tc, tp, x):
    t = x.shape[0] * x.shape[1]
    logits = torch.from_numpy(np.asarray(x, np.float32)).reshape(t, -1) @ tp["router"]
    _, idx, one_hot, _ = TMOE._top_k_gating(logits, tc.moe.top_k)
    cap = TMOE.expert_capacity(tc, t)
    pos = torch.cumsum(one_hot.reshape(t * tc.moe.top_k, -1), 0).reshape(one_hot.shape) - 1
    return idx.numpy(), ((pos < cap) & (one_hot > 0)).numpy()


def _moe_case(dtype, cf, x, router_bias=0.0, zero_router=False):
    jc, tc = _cfgs(dtype, cf)
    jp, tp = _moe_params(jc, router_bias=router_bias)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
        tp["router"] = torch.zeros_like(tp["router"])
    tdt = TM.L.torch_dtype(dtype)
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    # the objective: <out, ct> + 10 * aux (the aux term's weight makes its
    # gradient show beside the output's)
    def jloss(p, xx):
        out, aux = JMOE.apply_moe(p, xx, jc)
        return jnp.sum(out.astype(jnp.float32) * ct) + 10.0 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x).astype(jnp.dtype(dtype)))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    out, aux = TMOE.apply_moe(leaves, tx, tc)
    loss = (out.float() * torch.from_numpy(ct)).sum() + 10.0 * aux
    grads = torch.autograd.grad(loss, [tx] + [leaves[k] for k in sorted(leaves)])
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, jout=jout, jaux=jaux, out=out, aux=aux,
                jgrads=[jgx] + [jgp[k] for k in sorted(jgp)], grads=grads,
                names=["x"] + sorted(leaves))


def _x(seed=1, shape=(2, 16, 128)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_jax(dtype, cf):
    x = _x()
    if cf != 8.0:  # expert 0 takes most tokens: its 20 rows (ceil(2 * 32 * 1.25 / 4)) overflow
        x[..., 0] = 3.0
    r = _moe_case(dtype, cf, x, router_bias=0.0 if cf == 8.0 else 1.0)
    jidx, jwithin = _routing(r["jc"], r["jp"], x)
    tidx, twithin = _port_routing(r["tc"], r["tp"], x)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(twithin, jwithin)
    dropped = int(r["jc"].moe.top_k * x.shape[0] * x.shape[1] - jwithin.sum())
    assert (dropped == 0) == (cf == 8.0), dropped
    tol = TOL[dtype]
    assert _excess(r["out"], r["jout"], tol) <= 0
    assert abs(r["aux"].detach().item() - float(r["jaux"])) <= 1e-6
    for name, g, jg in zip(r["names"], r["grads"], r["jgrads"]):
        scale = float(np.abs(_np(jg)).max())
        assert _excess(g, jg, tol, scale) <= 0, (name, np.abs(_np(g) - _np(jg)).max(), scale)


def test_top_k_ties_take_the_lower_index_first():
    """A zero router: every probability ties, so ``lax.top_k`` routes every
    token to experts 0 and 1, and at capacity 1.25 the cumsum keeps the
    first tokens and drops the rest. Rows with partial ties too."""
    x = _x(2)
    r = _moe_case("float32", 1.25, x, zero_router=True)
    jidx, jwithin = _routing(r["jc"], r["jp"], x)
    tidx, twithin = _port_routing(r["tc"], r["tp"], x)
    assert (jidx == [0, 1]).all()
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(twithin, jwithin)
    assert 0 < jwithin.sum() < jwithin.shape[0] * 2
    assert _excess(r["out"], r["jout"], TOL["float32"]) <= 0
    for name, g, jg in zip(r["names"], r["grads"], r["jgrads"]):
        assert _excess(g, jg, TOL["float32"], float(np.abs(_np(jg)).max())) <= 0, name
    # partial ties: two of four logits equal and largest, the rest apart
    logits = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0], [0.0, 1.0, 0.0, 1.0],
                       [5.0, -1.0, 5.0, 5.0]], np.float32)
    _, jtop, _, jaux = JMOE._top_k_gating(jnp.asarray(logits), 2)
    _, ttop, _, taux = TMOE._top_k_gating(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(ttop.numpy(), np.asarray(jtop))
    assert abs(float(taux) - float(jaux)) <= 1e-6


def test_convert_carries_the_fp32_router_bit_exactly():
    jc, tc = _cfgs("bfloat16")
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(0)))
    tp = convert.tree_from_numpy(jp)
    moe = tp["blocks"]["pos0"]["moe"]
    assert moe["router"].dtype == torch.float32 and moe["w1"].dtype == torch.bfloat16
    assert moe["router"].shape == (2, 128, 4) and moe["w1"].shape == (2, 4, 128, 128)
    back = convert.tree_to_numpy(tp)
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        b = dict(jax.tree_util.tree_leaves_with_path(back))[path]
        assert b.dtype == a.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), path
    # the port's own tree has the reference's shapes and dtypes, leaf for leaf
    defs = []
    TM.L.map_defs(defs.append, TM.param_defs(tc))
    assert [(d.shape, d.dtype) for d in defs] == [
        (tuple(a.shape), str(a.dtype)) for a in jax.tree_util.tree_leaves(jp)]


# ---------------------------------------------------------------------------
# Training steps against the JAX step
# ---------------------------------------------------------------------------
SHAPE, JSHAPE = ShapeConfig("tiny", 32, 4, "train"), JShape("tiny", 32, 4, "train")
PLANS = {  # name: (plan keywords, quantizes)
    "none": (dict(n_persist=4), False),
    "checkpoint_2mb": (dict(n_persist=4, n_checkpoint=2, microbatch=2), False),
    "compress8": (dict(n_persist=4, act_policies=("compress8", "compress8")), True),
    "swap": (dict(n_persist=4, n_swap=2), False),
    "host_weights": (dict(n_persist=2, n_host=2, host_params=True, n_buffer=1), False),
}


def _jax_steps(jc, plan_kw, steps=2):
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    art = j_build(jc, JPlan(4, 2, **plan_kw), mesh, JSHAPE, adam=JAdam(lr=LR))
    state = art.init(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    fn = jax.jit(art.fn)
    pipe = JPipe(jc, JSHAPE, seed=0)
    metrics = []
    for _ in range(steps):
        state, m = fn(state, pipe.next_sync())
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm")})
    return init, jax.device_get(state), metrics


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_moe_train_steps_match_jax(plan_name):
    plan_kw, quantizes = PLANS[plan_name]
    jc, tc = _cfgs("float32")
    jinit, jfinal, jmetrics = _jax_steps(jc, plan_kw)
    plan = MemoryPlan(4, 2, **plan_kw)
    art = build_train_step(tc, plan, "cpu", SHAPE, adam=AdamConfig(lr=LR))
    state = art.place_state(convert.tree_from_numpy(jinit["params"]))
    pipe = SyntheticTokenPipeline(tc, SHAPE, seed=0)
    metrics = []
    for _ in range(2):
        state, m = art.fn(state, pipe.next_sync())
        metrics.append({k: float(m[k]) for k in ("loss", "ce", "grad_norm")})
    for step, (got, want) in enumerate(zip(metrics, jmetrics)):
        # the loss carries the aux loss: two MoE layers' of about 0.01 * E *
        # (k / E) * (1 / E) * E = 0.02 each (balanced routing)
        assert 0.03 < got["loss"] - got["ce"] < 0.05, got
        keys = ("loss", "grad_norm") if plan.microbatch > 1 else ("loss", "ce", "grad_norm")
        tol = STEP_TOL if step == 0 or not quantizes else 1e-3
        for k in keys:  # (with microbatches the reference reports its total as ce)
            assert abs(got[k] - want[k]) <= tol * (1 + abs(want[k])), (step, k, got, want)
    init = tree_leaves(convert.tree_from_numpy(jinit["opt"]["master"]))
    want = tree_leaves(convert.tree_from_numpy(jfinal["opt"]["master"]))
    got = tree_leaves(state["opt"]["master"])
    assert len(got) == len(want) == len(init)
    for a, b, i in zip(got, want, init):
        rel = float((a - b).norm() / (b - i).norm())
        assert rel <= UPDATE_TOL[quantizes], f"{plan_name}: an update {rel} from JAX's"


def test_moe_forward_returns_aux_under_every_policy_and_host_weights():
    """The hidden states and the aux loss of the layer stack, and their
    gradients, are the same under every act policy and with host weights
    (bitwise: the same ops replayed, the same values fetched)."""
    _, tc = _cfgs("float32")
    params = TM.init_params(tc, torch.Generator().manual_seed(4), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, 512, (2, 16)))
    ref = None
    defs = TM.param_defs(tc)["blocks"]
    for pol in ("none", "checkpoint", "compress16", "swap", "host"):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params["blocks"])]
        it = iter(leaves)
        blocks = TM.L.map_defs(lambda _: next(it), defs)
        if pol == "host":  # every weight fetched from "host" memory, again for the backward
            flat = [proxy_like(t, "cpu") for t in leaves]
            it = iter(flat)
            proxies = TM.L.map_defs(lambda _: next(it), defs)
            run = TM.Run(params=blocks, n_repeats=2, buffered=False, proxies=proxies)
            wrt = flat
        else:
            run = TM.Run(params=blocks, n_repeats=2, act_policy=pol)
            wrt = leaves
        h, aux = TM.forward({**params, "blocks": blocks}, {"tokens": tokens}, tc, runs=[run])
        assert aux.shape == () and aux.dtype == torch.float32 and aux.detach().item() > 0
        grads = torch.autograd.grad((h.float() ** 2).mean() + aux, wrt)
        if ref is None:
            ref = (h.detach(), aux.detach(), grads)
            continue
        if pol == "compress16":  # fp32 sites rounded to bf16: values move
            assert torch.allclose(h, ref[0], rtol=2e-2, atol=2e-2)
            continue
        assert torch.equal(h, ref[0]) and torch.equal(aux, ref[1]), pol
        assert all(torch.equal(a, b) for a, b in zip(grads, ref[2])), pol


def test_mixtral_forward_and_aux_match_jax():
    """Reduced ``mixtral-8x22b`` (no shared experts, a sliding window) in
    fp32: the hidden states and the aux loss of the layer stack, and the
    gradient of both, against ``repro.models.model.forward``."""
    jc = jreduced(jget_config("mixtral-8x22b"), dtype="float32")
    tc = reduced(get_config("mixtral-8x22b"), dtype="float32")
    assert tc.moe.num_shared_experts == 0 and tc.sliding_window
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(8).integers(0, jc.vocab_size, (2, 96))

    def jobj(p):
        h, aux = JM.forward(p, {"tokens": jnp.asarray(tokens)}, jc)
        return jnp.mean(h ** 2) + aux, (h, aux)

    (_, (jh, jaux)), jg = jax.jit(jax.value_and_grad(jobj, has_aux=True))(jp)
    tp = convert.tree_from_numpy(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(tp["blocks"])]
    h, aux = TM.forward(tp, {"tokens": torch.from_numpy(tokens)}, tc)
    grads = torch.autograd.grad((h ** 2).mean() + aux, leaves)
    assert _excess(h, jh, TOL["float32"]) <= 0
    assert abs(aux.detach().item() - float(jaux)) <= 1e-6
    for g, want in zip(grads, jax.tree_util.tree_leaves(jg["blocks"])):
        assert _excess(g, want, 1e-4, float(np.abs(_np(want)).max())) <= 0


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
B, S, CHUNK = 4, 32, 8


def _prompts():
    rng = np.random.default_rng(5)
    return [(i, rng.integers(1, 512, int(n)).tolist(), 3 + i)
            for i, n in enumerate(rng.integers(3, 13, 4))]


@functools.lru_cache(maxsize=None)
def _engine_params(cf):
    """The engine cases' JAX init (cf only changes the config), drawn once
    a module."""
    jc, _ = _cfgs("float32", cf)
    return JM.init_params(jc, jax.random.PRNGKey(0))


def _engine_model(cf):
    jc, tc = _cfgs("float32", cf)
    jp = _engine_params(cf)
    return jc, tc, jp, convert.tree_from_numpy(jax.device_get(jp))


# cf 0.5: one capacity row an expert at B 4 (ceil(2 * 4 * 0.5 / 4) = 1),
# the full config's decode capacity
@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_engine_tokens_match_jax_resident(cf):
    jc, tc, jp, tp = _engine_model(cf)
    assert TMOE.expert_capacity(tc, B) == (16 if cf == 8.0 else 1)
    jeng = JEngine(jc, JPlan(4, 2, n_persist=4), make_local_mesh(),
                   JShape("serve", S, B, "decode"), jp, admission="chunked",
                   prefill_chunk=CHUNK)
    jrep = jeng.run([JRequest(*r) for r in _prompts()])
    eng = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu", ShapeConfig("serve", S, B,
                       "decode"), tp, admission="chunked", prefill_chunk=CHUNK)
    rep = eng.run([Request(*r) for r in _prompts()])
    assert rep.drained and jrep.drained
    assert all(len(rep.finished[i]) == 3 + i for i in range(4))
    assert rep.finished == jrep.finished
    assert (rep.prefill_ticks, rep.decode_ticks) == (jrep.prefill_ticks, jrep.decode_ticks)


def test_moe_paged_decode_matches_resident():
    """Paged decode (through ``PagedKV`` and ``PagedKV(use_kernel=False)``)
    against the resident cache, step by step, 28 steps past the hot window,
    at a capacity of one row an expert; then the paged engine's tokens."""
    _, tc, _, tp = _engine_model(0.5)
    spec = choose_paging(S, 8, 2)
    assert spec.n_cold > 0
    res = TKV.init_cache(tc, B, S)
    paged = {k: init_paged_cache(tc, B, S, spec) for k in (True, False)}
    ios = {k: PagedKV(spec, use_kernel=k) for k in (True, False)}
    toks = np.random.default_rng(6).integers(0, tc.vocab_size, (B, 28))
    for t in range(28):
        tok, pos = torch.from_numpy(toks[:, t:t + 1]), torch.full((B,), t)
        want, _ = TKV.decode_step(tp, res, tok, pos, tc)
        for k in (True, False):
            got, _ = TKV.decode_step(tp, paged[k], tok, pos, tc, kv_io=ios[k])
            assert _excess(got, want, 1e-5) <= 0, (t, k)
    shape = ShapeConfig("serve", S, B, "decode")
    reqs = lambda: [Request(*r) for r in _prompts()]  # noqa: E731
    resident = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4), "cpu", shape, tp,
                            prefill_chunk=CHUNK).run(reqs())
    eng = DecodeEngine(tc, MemoryPlan(4, 2, n_persist=4, n_host=spec.n_cold), "cpu", shape, tp,
                       paging=spec, prefill_chunk=CHUNK)
    assert eng.run(reqs()).finished == resident.finished


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------
def _jax_trace(cfg, batch, seq):
    defs = JM.param_defs(cfg)["blocks"]
    one = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape[1:], jnp.dtype(d.dtype)), defs,
                       is_leaf=lambda x: hasattr(x, "shape") and not hasattr(x, "aval"))
    x = jax.ShapeDtypeStruct((batch, seq, cfg.d_model), jnp.dtype(cfg.dtype))
    return JP.profile_fn(lambda p, x: JM.apply_superblock(p, x, cfg)[0], one, x,
                         weight_args=(0,))


# reduced at (B 2, S 64); full width at B 1 and chip_smoke.py's S 4096
@pytest.mark.parametrize("red,batch,seq", [(True, 2, 64), (False, 1, 4096)])
def test_moe_profile_matmul_flops_equal_reference(red, batch, seq):
    jc, tc = jget_config(ARCH), get_config(ARCH)
    if red:
        jc, tc = jreduced(jc), reduced(tc)
    jprof = _jax_trace(jc, batch, seq)
    dots = [op.flops for op in jprof.ops if op.name == "dot_general"]
    # attention's 4 projections and 2 products, the 2 norms' statistics
    # (einsums in the reference) and the MoE's 11: router, 4 dispatch and
    # combine, 3 expert, 3 shared
    assert len(dots) == 8 + 11
    tprof = TP.trace_superblock(tc, batch, seq)
    assert tprof.matmul_flops == sum(dots)
    if not red:
        # 2 x 344 GFLOP of fp32 dispatch and combine a layer, beside 355 of
        # bf16 expert products (60 experts x 342 capacity rows)
        c = TMOE.expert_capacity(tc, seq)
        assert c == 342
        fp32, expert = 2 * seq * 60 * c * 2048, 2 * 60 * c * 2048 * 1408
        assert (fp32, 3 * expert) == (344_268_472_320, 355_026_862_080)
        assert dots.count(fp32) == 2 and dots.count(expert) == 3


def _pair(seq, batch, red):
    jc, tc = jget_config(ARCH), get_config(ARCH)
    if red:
        jc, tc = jreduced(jc), reduced(tc)
    hw_t = TH.H100_SXM if not red else TH.LOCAL_CPU_HW
    hw_j = (JH.HardwareSpec(**dataclasses.asdict(TH.H100_SXM)) if not red
            else JH.LOCAL_CPU_HW)
    jw = JCM.build_workload(jc, JShape("t", seq, batch, "train"), JH.MeshSpec((1,), ("data",)),
                            hw_j)
    tw = TCM.build_workload(tc, ShapeConfig("t", seq, batch, "train"), TH.ONE_CHIP, hw_t)
    assert [dataclasses.asdict(c) for c in tw.chunks] == [dataclasses.asdict(c)
                                                         for c in jw.chunks]
    return jw, dataclasses.replace(tw, block=TP.BlockProfile(**dataclasses.asdict(jw.block)))


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("red,seq,batch", [(False, 4096, 1), (True, 64, 2)])
def test_moe_search_equals_reference_on_shared_profile(red, seq, batch):
    jw, tw = _pair(seq, batch, red)
    jres, tres = JA.search(jw, compress="off", sync="xla"), TA.search(tw, compress="off",
                                                                     sync="xla")
    _same({"plan": dataclasses.asdict(jres.plan), "runtime": vars(jres.runtime),
           "memory": vars(jres.memory), "feasible": jres.feasible},
          {"plan": dataclasses.asdict(tres.plan), "runtime": vars(tres.runtime),
           "memory": vars(tres.memory), "feasible": tres.feasible})
    for plan in (jres.plan, dataclasses.replace(jres.plan, act_policies=None, n_checkpoint=0)):
        tplan = MemoryPlan(**dataclasses.asdict(plan))
        _same(vars(JCM.estimate_runtime(jw, plan)), vars(TCM.estimate_runtime(tw, tplan)))
        _same(vars(JCM.estimate_memory(jw, plan)), vars(TCM.estimate_memory(tw, tplan)))
    if not red:  # the full model's state: 14.3 B parameters, 229 GB at 16 B each
        from repro_torch.core.chunks import model_state_bytes, total_param_count

        assert 14.2e9 < total_param_count(tw.chunks) < 14.4e9
        assert 228e9 < model_state_bytes(tw.chunks) < 230e9


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------
def test_launchers_run_the_reduced_moe(capsys):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
                              "--seq", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert "ce=" in out
    assert launch_serve.main(["--arch", ARCH, "--reduced", "--seq-len", "64", "--requests",
                              "2", "--batch-slots", "2", "--max-new", "3", "--prompt-len", "5",
                              "20", "--page-size", "16", "--device", "cpu"]) == 0
    served = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert served["arch"] == ARCH and served["generated_tokens"] == 6
