"""The encoder-decoder's encoder and training path against the JAX package,
at reduced ``seamless-m4t-large-v2`` in fp32 on the CPU (the rest of the
family's checks, and the tolerances, are in ``test_torch_encdec.py``, whose
helpers this file shares; the two files split the family's checks so that
neither runs much past a minute on one worker).

* ``cross_attention_block`` (query and key rows apart) and ``encode``:
  output and every gradient (the frames', the memory's and the
  encoder's), 1e-4;
* recomputed and swapped runs: bitwise equal to a run that keeps
  everything, the encoder's gradients included;
* three training steps under a resident and a checkpointed plan (a
  compress8 plan and one whose front chunk, embedding and encoder, is
  ``host`` in ``test_torch_encdec_offload.py``): losses 1e-4 (1e-3
  quantized), each fp32 master's update within 1e-3 of JAX's (1e-1
  quantized), the host traffic and quantizer calls the plan's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShape
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JAdam
from repro.train.step_builder import build_train_step as j_build
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.train.step_builder import build_train_step
from test_torch_encdec import LR, SEAMLESS, _batch, _cfgs, _close, _rebuild, _torch_loss

import torch_cores

torch_cores.share_cores()


# ---------------------------------------------------------------------------
# Cross-attention and the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk", [(24, 40), (40, 24), (130, 130)])
def test_cross_attention_block_and_grads_match_jax(sq, sk):
    jc, tc = _cfgs(SEAMLESS)
    rng = np.random.default_rng(sq * 7 + sk)
    d = tc.d_model
    w = {k: (rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)
         for k in ("wq", "wk", "wv", "wo")}
    x = rng.standard_normal((2, sq, d)).astype(np.float32)
    mem = rng.standard_normal((2, sk, d)).astype(np.float32)
    dy = rng.standard_normal((2, sq, d)).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, x, m: JL.cross_attention_block(p, x, m, jc),
                        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
                        jnp.asarray(mem))
    jgp, jgx, jgm = vjp(jnp.asarray(dy))
    tw = {k: torch.from_numpy(v).requires_grad_() for k, v in w.items()}
    tx, tm = (torch.from_numpy(a).requires_grad_() for a in (x, mem))
    out = TL.cross_attention_block(tw, tx, tm, tc)
    grads = torch.autograd.grad(out, [tw[k] for k in sorted(tw)] + [tx, tm],
                                torch.from_numpy(dy))
    _close(out, jout, what="out")
    for k, g in zip(sorted(tw), grads):
        _close(g, jgp[k], what=f"d{k}")
    _close(grads[-2], jgx, what="dx")
    _close(grads[-1], jgm, what="dmemory")


def _encode_inputs(jc, s_src, seed=3):
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(seed)))
    frames = np.random.default_rng(seed).standard_normal(
        (2, s_src, jc.d_model)).astype(np.float32)
    return jp, frames


@pytest.mark.parametrize("s_src", [16, 37])
def test_encode_and_grads_match_jax(s_src):
    jc, tc = _cfgs(SEAMLESS)
    jp, frames = _encode_inputs(jc, s_src)
    dy = np.random.default_rng(9).standard_normal(frames.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda p, f: JM.encode(p, f, jc), jp, jnp.asarray(frames))
    jgp, jgf = vjp(jnp.asarray(dy))
    params = convert.tree_from_numpy(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(params["encoder"])]
    tf = torch.from_numpy(frames).requires_grad_()
    out = TM.encode(params, tf, tc)
    grads = torch.autograd.grad(out, leaves + [tf], torch.from_numpy(dy))
    _close(out, jout, what="memory")
    want = tree_leaves(convert.tree_from_numpy(jax.device_get(jgp["encoder"])))
    assert len(want) == len(grads) - 1
    for g, w in zip(grads, want):
        _close(g, w, what="encoder grad")
    _close(grads[-1], jgf, what="dframes")


# ---------------------------------------------------------------------------
# Recomputed runs take memory as an input
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("policy,group", [("checkpoint", 1), ("checkpoint", 2), ("swap", 1)])
def test_seamless_recomputed_runs_equal_kept_activations(policy, group):
    """Recomputed and swapped runs take ``memory`` as an input of their
    regions: the encoder's gradients (and every other) equal those of a run
    that keeps everything, bitwise."""
    _, tc = _cfgs(SEAMLESS)
    params = TM.init_params(tc, torch.Generator().manual_seed(6), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in _batch(_cfgs(SEAMLESS)[0], 16, 21).items()}
    results = []
    for pol in ("none", policy):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
        p = _rebuild(params, iter(leaves))
        runs = [TM.Run(params=p["blocks"], n_repeats=TM.num_repeats(tc), act_policy=pol,
                       ckpt_group=group)]
        loss, _ = _torch_loss(tc, p, tb, runs)
        results.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------------------
# Training steps against the JAX step
# ---------------------------------------------------------------------------
STEP_PLANS = {  # name: (plan keywords, quantizes)
    "resident": (dict(n_persist=4), False),
    "checkpoint_mb2": (dict(n_persist=4, n_checkpoint=2, microbatch=2), False),
    "compress8": (dict(n_persist=4, act_policies=("compress8", "compress8")), True),
    "front_chunk_host": (dict(n_persist=0, n_host=4, host_params=True, n_buffer=2,
                              act_policies=("swap", "none")), False),
}
LOSS_TOL = {True: 1e-3, False: 1e-4}
UPDATE_TOL = {True: 1e-1, False: 1e-3}
STEP_SHAPE = (24, 4)  # seq, global batch


def _jax_steps(jc, plan_kw, steps=3):
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shape = JShape("tiny", *STEP_SHAPE, "train")
    art = j_build(jc, JPlan(4, 2, **plan_kw), mesh, shape, adam=JAdam(lr=LR))
    state = art.init(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    fn = jax.jit(art.fn)
    pipe = JPipe(jc, shape, seed=0)
    losses = []
    for _ in range(steps):
        state, metrics = fn(state, pipe.next_sync())
        losses.append(float(metrics["loss"]))
    return init, jax.device_get(state), losses


@pytest.mark.parametrize("plan_name", ["checkpoint_mb2", "resident"])
def test_seamless_train_steps_match_jax(plan_name):
    check_steps_match_jax(plan_name)


def check_steps_match_jax(plan_name):
    """Three steps of ``STEP_PLANS[plan_name]`` against the JAX step (the
    compress8 and front-chunk-host plans run in
    ``test_torch_encdec_offload.py``)."""
    from repro_torch import obs

    plan_kw, quantizes = STEP_PLANS[plan_name]
    jc, tc = _cfgs(SEAMLESS)
    jinit, jfinal, jlosses = _jax_steps(jc, plan_kw)
    plan = MemoryPlan(4, 2, **plan_kw)
    shape = ShapeConfig("tiny", *STEP_SHAPE, "train")
    tel = obs.Telemetry()
    art = build_train_step(tc, plan, "cpu", shape, adam=AdamConfig(lr=LR), telemetry=tel)
    assert len(jinit["params"]["runs"]) == len(art.runs)
    state = art.place_state(convert.tree_from_numpy(jinit["params"]))
    pipe = SyntheticTokenPipeline(tc, shape, seed=0)
    losses = [float(art.fn(state, pipe.next_sync())[1]["loss"]) for _ in range(3)]
    _close(losses[0], jlosses[0], what="first loss")
    _close(np.array(losses), np.array(jlosses), tol=LOSS_TOL[quantizes], what="losses")
    init = tree_leaves(convert.tree_from_numpy(jinit["opt"]["master"]))
    want = tree_leaves(convert.tree_from_numpy(jfinal["opt"]["master"]))
    got = tree_leaves(state["opt"]["master"])
    assert len(got) == len(want) == len(init)
    for a, b, i in zip(got, want, init):
        rel = float((a - b).norm() / (b - i).norm())
        assert rel <= UPDATE_TOL[quantizes], f"{plan_name}: an update {rel} from JAX's"
    snap = tel.registry.snapshot()
    if plan_kw.get("host_params"):
        # the front chunk (embedding and encoder), both blocks and the head
        # fetched once a step, the unbuffered first block (swap) once more
        # for its replay
        def nbytes(*keys):
            return sum(np.asarray(x).nbytes for x in jax.tree_util.tree_leaves(
                [jinit["params"][k] for k in keys]))

        front, tail = nbytes("embed", "encoder"), nbytes("final_norm", "head")
        per_block = nbytes("runs") // 2
        assert snap["train.weight_fetch_bytes"]["value"] == 3 * (front + 3 * per_block + tail)
        site = STEP_SHAPE[0] * STEP_SHAPE[1] * tc.d_model * 4
        # norm1's, the mixer's and the cross-attention's outputs
        assert snap["train.act_swap_out_bytes"]["value"] == 3 * 3 * site
    if quantizes:  # every site of both layers, once a step: the cost model's four
        assert snap["train.act_quantize_launches"]["value"] == 3 * 2 * 4
