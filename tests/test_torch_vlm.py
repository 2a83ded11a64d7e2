"""The vision-language family (``llava-next-34b``) of the port against the JAX
package, at reduced size on the CPU, with the heads overridden to 14 query
over 2 KV heads of 32: group 7, llava's own (56 over 8), which ``reduced``
alone would make group 1.

Inputs come from seeded numpy or from the JAX ``init``, carried over bit
for bit by ``repro_torch.models.convert``. Comparisons are in fp32.
Tolerance, as in ``test_torch_encdec.py``: ``|port - jax| <= 1e-4 * (1 +
|jax|)`` for the forward with its patch prefix, the loss, every gradient,
the stateless prefill's logits and token-by-token decode against the
teacher-forced forward. Two training steps under a searched plan that
compresses, offloads and accumulates: the first loss within 1e-4, both
within 1e-3, and each fp32 master's update within 1e-1 of JAX's in
relative L2 norm (``test_torch_policies.py``'s bounds for plans that
quantize). The pipeline's patches are bitwise equal.
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
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JAdam
from repro.train.losses import chunked_cross_entropy as j_ce
from repro.train.step_builder import build_prefill_step as j_prefill
from repro.train.step_builder import build_train_step as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import autotuner as TA
from repro_torch.core import cost_model as TCM
from repro_torch.core import hardware as TH
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import kvcache as TKV
from repro_torch.models import model as TM
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.serve.paging import PagedKV, choose_paging, init_paged_cache
from repro_torch.train.step_builder import build_prefill_step, build_train_step
from test_torch_encdec import _close, _torch_loss

import torch_cores

torch_cores.share_cores()

LLAVA = "llava-next-34b"
HEADS = dict(num_heads=14, num_kv_heads=2)  # group 7, head_dim 32 (reduced's)
LR = 3e-3


def _cfgs():
    j = dataclasses.replace(jreduced(jget_config(LLAVA), **HEADS), dtype="float32")
    t = dataclasses.replace(reduced(get_config(LLAVA), **HEADS), dtype="float32")
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.num_heads // t.num_kv_heads == 7 and t.resolved_head_dim == 32
    return j, t


def _batch(jc, s, batch=2, seed=1):
    """The JAX pipeline's batch: tokens, labels and (B, min(1024, S), D) patches."""
    return {k: np.asarray(v) for k, v in
            JPipe(jc, JShape("t", s, batch, "train"), seed=seed).next_sync().items()}


def test_pipeline_patches_equal_jax():
    jc, tc = _cfgs()
    bf = dataclasses.replace(tc, dtype="bfloat16")
    for s in (12, 1030):  # S patches, and 1024 once S passes 1024
        shape = ShapeConfig("t", s, 2, "train")
        jb = JPipe(jc, JShape("t", s, 2, "train"), seed=5).next_sync()
        tb = SyntheticTokenPipeline(tc, shape, seed=5).next_sync()
        tbb = SyntheticTokenPipeline(bf, shape, seed=5).next_sync()
        assert set(tb) == {"tokens", "labels", "patches"}
        assert tb["patches"].shape == (2, min(1024, s), tc.d_model)
        for key in tb:
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
        assert tbb["patches"].dtype == torch.bfloat16
        assert torch.equal(tbb["patches"], tb["patches"].to(torch.bfloat16))


# ---------------------------------------------------------------------------
# Forward with the patch prefix, loss and every gradient
# ---------------------------------------------------------------------------
def _per_repeat(tree, i):
    """Repeat i of a stacked tree, still stacked: (1, ...) slices."""
    if isinstance(tree, dict):
        return {k: _per_repeat(v, i) for k, v in tree.items()}
    return tree[i:i + 1]


@pytest.mark.parametrize("policies", [("none", "none"), ("checkpoint", "compress8")])
def test_forward_loss_and_grads_with_patches_match_jax(policies):
    """One run a layer, each under its policy: the prefix's positions go
    through the recomputed region and the compressed sites with the
    tokens'; the hidden states come back for the tokens alone."""
    jc, tc = _cfgs()
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(4)))
    batch = _batch(jc, 20)
    assert batch["patches"].shape == (2, 20, jc.d_model)

    def jloss(p, b):
        runs = [JM.Run(params=_per_repeat(p["blocks"], i), n_repeats=1, act_policy=pol,
                       persistent=True) for i, pol in enumerate(policies)]
        h, _ = JM.forward(p, b, jc, runs=runs)
        h = JL.apply_norm(p["final_norm"], h, jc.norm)
        return j_ce(h, p["head"]["w"], b["labels"], ce_chunk=8), h

    (jl, jh), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = convert.tree_from_numpy(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["patches"].requires_grad_()  # an input: nothing differentiates it
    runs = [TM.Run(params=_per_repeat(params["blocks"], i), n_repeats=1, act_policy=pol)
            for i, pol in enumerate(policies)]
    loss, hn = _torch_loss(tc, params, tb, runs)
    assert hn.shape == (2, 20, tc.d_model)
    grads = torch.autograd.grad(loss, leaves)
    _close(hn, jh, what="normed hidden")
    _close(loss, jl, what="loss")
    want = tree_leaves(convert.tree_from_numpy(jax.device_get(jg)))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        _close(g, w, what="grad")
    assert tb["patches"].grad is None


# ---------------------------------------------------------------------------
# Training steps under a searched plan
# ---------------------------------------------------------------------------
STEP_SHAPE = (24, 4)  # seq (and patches), global batch


def _searched_plan(tc) -> MemoryPlan:
    """The port's search for reduced llava at STEP_SHAPE on a TPU v5e spec
    cut to 1/1000 of its memory: it offloads the head chunk's states,
    compresses the first block's activations and accumulates 4
    microbatches."""
    hw = TH.HARDWARE["tpu-v5e"]
    hw = dataclasses.replace(hw, hbm_capacity_fraction=hw.hbm_capacity_fraction * 1e-3)
    w = TCM.build_workload(tc, ShapeConfig("t", *STEP_SHAPE, "train"), TH.ONE_CHIP, hw)
    res = TA.search(w, compress="off", sync="xla")
    assert res.feasible
    return res.plan


def test_train_steps_under_searched_plan_match_jax():
    jc, tc = _cfgs()
    plan = _searched_plan(tc)
    assert "compress8" in plan.block_policies() and plan.n_host and plan.microbatch > 1, \
        plan.describe()
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jshape = JShape("t", *STEP_SHAPE, "train")
    jart = j_build(jc, JPlan(**dataclasses.asdict(plan)), mesh, jshape, adam=JAdam(lr=LR))
    jstate = jart.init(jax.random.PRNGKey(0))
    jinit = jax.device_get(jstate)
    fn = jax.jit(jart.fn)
    jpipe = JPipe(jc, jshape, seed=0)
    jlosses = []
    for _ in range(2):
        jstate, metrics = fn(jstate, jpipe.next_sync())
        jlosses.append(float(metrics["loss"]))
    jfinal = jax.device_get(jstate)

    shape = ShapeConfig("t", *STEP_SHAPE, "train")
    art = build_train_step(tc, plan, "cpu", shape, adam=AdamConfig(lr=LR))
    state = art.place_state(convert.tree_from_numpy(jinit["params"]))
    pipe = SyntheticTokenPipeline(tc, shape, seed=0)
    losses = [float(art.fn(state, pipe.next_sync())[1]["loss"]) for _ in range(2)]
    _close(losses[0], jlosses[0], what="first loss")
    _close(np.array(losses), np.array(jlosses), tol=1e-3, what="losses")
    init = tree_leaves(convert.tree_from_numpy(jinit["opt"]["master"]))
    want = tree_leaves(convert.tree_from_numpy(jfinal["opt"]["master"]))
    got = tree_leaves(state["opt"]["master"])
    assert len(got) == len(want) == len(init)
    for a, b, i in zip(got, want, init):
        rel = float((a - b).norm() / (b - i).norm())
        assert rel <= 1e-1, f"an update {rel} from JAX's"


# ---------------------------------------------------------------------------
# Stateless prefill and decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_patches", [True, False])
def test_prefill_logits_match_jax(with_patches):
    """``build_prefill_step(chunk=None)``: the (B, V) logits at the last
    position, the patches run ahead of the tokens or absent."""
    jc, tc = _cfgs()
    seq, b = 20, 3
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(2)))
    batch = _batch(jc, seq, batch=b, seed=3)
    keys = ("tokens", "patches") if with_patches else ("tokens",)
    jplan = JPlan(4, 2, n_persist=4)
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jart = j_prefill(jc, jplan, mesh, JShape("p", seq, b, "prefill"))
    want = jart.fn(jp, {k: jnp.asarray(batch[k]) for k in keys})
    art = build_prefill_step(tc, MemoryPlan(4, 2, n_persist=4), "cpu",
                             ShapeConfig("p", seq, b, "prefill"))
    got = art.fn(convert.tree_from_numpy(jp), {k: torch.from_numpy(batch[k]) for k in keys})
    assert got.shape == (b, tc.vocab_size)
    _close(got, want, what="prefill logits")
    with pytest.raises(ValueError, match="ServeStep"):
        build_prefill_step(tc, MemoryPlan(4, 2, n_persist=4), "cpu",
                           ShapeConfig("p", seq, b, "prefill"), chunk=8)


@pytest.mark.parametrize("layout", ["resident", "paged"])
def test_decode_equals_teacher_forced_forward(layout):
    """The engine's path serves llava's tokens, as the JAX engine does:
    token-by-token decode at group 7 (the paged cache through the plain
    version on the CPU) against the JAX teacher-forced forward."""
    jc, tc = _cfgs()
    seq = 16
    jp = jax.device_get(JM.init_params(jc, jax.random.PRNGKey(7)))
    tokens = _batch(jc, seq, seed=2)["tokens"]
    jlogits = JM.lm_head(jp, JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jc,
                                        attn_impl="naive")[0], jc)
    params = convert.tree_from_numpy(jp)
    if layout == "resident":
        cache, kv_io = TKV.init_cache(tc, 2, seq), None
    else:
        spec = choose_paging(seq, 4, 2)
        cache, kv_io = init_paged_cache(tc, 2, seq, spec), PagedKV(spec)
    outs = []
    with torch.inference_mode():
        for t in range(seq):
            logits, cache = TKV.decode_step(params, cache, torch.from_numpy(
                tokens[:, t:t + 1].astype(np.int64)), t, tc, kv_io=kv_io)
            outs.append(logits)
    _close(torch.stack(outs, 1), jlogits, what="decode vs teacher-forced")


def test_launchers_run_llava_on_the_cpu(capsys):
    rc = launch_train.main(["--arch", LLAVA, "--reduced", "--steps", "2", "--batch", "2",
                            "--seq", "32", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[train] searched plan:" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    rc = launch_serve.main(["--arch", LLAVA, "--reduced", "--seq-len", "64", "--prompt-len",
                            "5", "20", "--page-size", "16", "--max-new", "4", "--device", "cpu"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["drained"] and summary["plan"] == "paged"
