"""The port's training path against the JAX package's, on the CPU.

Inputs come from seeded numpy (or from the JAX ``init`` state, carried over
bit for bit by ``repro_torch.models.convert``) and go through both. All
comparisons are in fp32, where the two frameworks differ only in the order
of their sums. Tolerances, as ``|port - jax| <= tol * (1 + |jax|)``:

* attention, cross-entropy and their gradients: 1e-4 (one layer of fp32
  sums over at most a few hundred terms);
* forward hidden states and losses through the model: 1e-4;
* three training steps: losses 1e-4, fp32 master weights 1e-4 (Adam's
  normalised update moves each weight by about lr = 3e-3 a step, so a
  relative gradient difference of 1e-6 moves it by far less).

The act policies of one forward agree with each other exactly: they run the
same ops, and recomputation repeats them.
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
from repro.train.step_builder import build_train_step as j_build
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.train.losses import chunked_cross_entropy
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step_builder import build_train_step

import torch_cores

torch_cores.share_cores()

TOL = 1e-4
JCFG = jreduced(jget_config("mistral-7b"), num_kv_heads=2, dtype="float32")
CFG = reduced(get_config("mistral-7b"), num_kv_heads=2, dtype="float32")
SHAPE = ShapeConfig("tiny", 32, 4, "train")
JSHAPE = JShape("tiny", 32, 4, "train")
LR = 3e-3


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(out, ref, tol=TOL, what=""):
    a, b = _np(out), _np(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    excess = (np.abs(a - b) - tol * (1.0 + np.abs(b))).max()
    assert excess <= 0.0, f"{what}: max |diff| {np.abs(a - b).max()} beyond {tol}"


# ---------------------------------------------------------------------------
# Attention: the _mea Function (plain block loops on the CPU) against jax.vjp
# ---------------------------------------------------------------------------
ATTN_CASES = [  # (b, s, hq, hkv, hd, window, block_kv)
    (2, 200, 4, 2, 16, 0, 128),   # GQA 2:1, S not a multiple of block_kv
    (1, 160, 4, 1, 16, 48, 128),  # MQA, sliding window
    (1, 256, 2, 2, 32, 0, 128),   # MHA, two whole blocks
    (2, 64, 4, 2, 16, 16, 1024),  # one padded block, window
]


@pytest.mark.parametrize("b,s,hq,hkv,hd,window,block_kv", ATTN_CASES)
def test_blockwise_attention_and_grads_match_jax(b, s, hq, hkv, hd, window, block_kv):
    rng = np.random.default_rng(s + hq)
    q, do = (rng.standard_normal((b, s, hq, hd)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, hd)).astype(np.float32) for _ in range(2))
    jfn = lambda q, k, v: JL.blockwise_attention(q, k, v, causal=True, window=window,  # noqa: E731
                                                 block_kv=block_kv)
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = TL.blockwise_attention(tq, tk, tv, causal=True, window=window, block_kv=block_kv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    _close(out, jout, what="out")
    for name, got, want in zip("qkv", grads, jgrads):
        _close(got, want, what=f"d{name}")
    # the whole-row plain versions (the kernels package's CPU route) agree too
    naive = TL.naive_attention(tq, tk, tv, causal=True, window=window)
    _close(naive, JL.naive_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                     window=window), what="naive")
    _close(out, naive, what="blockwise vs naive")


# ---------------------------------------------------------------------------
# Chunked cross-entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,ce_chunk", [(32, 8), (30, 8)])
def test_chunked_cross_entropy_and_grads_match_jax(s, ce_chunk):
    rng = np.random.default_rng(s)
    h = rng.standard_normal((2, s, 16)).astype(np.float32)
    w = (rng.standard_normal((16, 50)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 50, (2, s)).astype(np.int32)
    jloss, vjp = jax.vjp(lambda h, w: j_ce(h, w, jnp.asarray(labels), ce_chunk=ce_chunk),
                         jnp.asarray(h), jnp.asarray(w))
    jdh, jdw = vjp(jnp.ones((), jnp.float32))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = chunked_cross_entropy(th, tw, torch.from_numpy(labels), ce_chunk=ce_chunk)
    dh, dw = torch.autograd.grad(loss, (th, tw))
    _close(loss, jloss, what="loss")
    _close(dh, jdh, what="dh")
    _close(dw, jdw, what="dw")


# ---------------------------------------------------------------------------
# The forward under each act policy
# ---------------------------------------------------------------------------
def _jax_params():
    return jax.device_get(JM.init_params(JCFG, jax.random.PRNGKey(3)))


def test_forward_and_loss_match_jax_under_each_act_policy():
    jparams = _jax_params()
    pipe = JPipe(JCFG, JSHAPE, seed=1)
    batch = pipe.next_sync()
    jh, _ = jax.jit(lambda p, b: JM.forward(p, b, JCFG))(jparams, batch)
    jloss = j_ce(JL.apply_norm(jparams["final_norm"], jh, JCFG.norm), jparams["head"]["w"],
                 batch["labels"], ce_chunk=16)
    params = convert.tree_from_numpy(jparams)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    results = {}
    for name, pol, group in (("none", "none", 1), ("checkpoint", "checkpoint", 1),
                             ("checkpoint_g2", "checkpoint", 2)):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
        p = _rebuild(params, iter(leaves))
        runs = [TM.Run(params=p["blocks"], n_repeats=TM.num_repeats(CFG), act_policy=pol,
                       ckpt_group=group)]
        h, _ = TM.forward(p, tbatch, CFG, runs=runs)
        hn = TL.apply_norm(p["final_norm"], h, CFG.norm)
        loss = chunked_cross_entropy(hn, p["head"]["w"], tbatch["labels"], ce_chunk=16)
        grads = torch.autograd.grad(loss, leaves)
        results[name] = (h.detach(), loss.detach(), grads)
        _close(h, jh, what=f"hidden ({name})")
        _close(loss, jloss, what=f"loss ({name})")
    base = results["none"]
    for name in ("checkpoint", "checkpoint_g2"):
        h, loss, grads = results[name]
        assert torch.equal(h, base[0]) and torch.equal(loss, base[1]), name
        assert all(torch.equal(a, b) for a, b in zip(grads, base[2])), name


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    return {k: _rebuild(tree[k], it) for k in sorted(tree)}


# ---------------------------------------------------------------------------
# The step: three plans, three steps, against the JAX step on one device
# ---------------------------------------------------------------------------
PLANS = {
    "resident": dict(n_persist=4),
    "checkpoint_all_mb2": dict(n_persist=4, n_checkpoint=2, microbatch=2),
    "host_optimizer": dict(n_host=1, host_params=False),
}


def _jax_steps(plan_kw, steps=3):
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    art = j_build(JCFG, JPlan(4, 2, **plan_kw), mesh, JSHAPE, adam=JAdam(lr=LR))
    state = art.init(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    fn = jax.jit(art.fn)
    pipe = JPipe(JCFG, JSHAPE, seed=0)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = fn(state, pipe.next_sync())
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return init, jax.device_get(state), losses, norms


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_train_steps_match_jax(plan_name):
    plan_kw = PLANS[plan_name]
    jinit, jfinal, jlosses, jnorms = _jax_steps(plan_kw)
    art = build_train_step(CFG, MemoryPlan(4, 2, **plan_kw), "cpu", SHAPE,
                           adam=AdamConfig(lr=LR))
    assert [r.placement for r in art.runs] == [
        {"resident": "persist", "checkpoint_all_mb2": "persist",
         "host_optimizer": "hbm"}[plan_name]]
    state = art.place_state(convert.tree_from_numpy(jinit["params"]))
    pipe = SyntheticTokenPipeline(CFG, SHAPE, seed=0)
    losses, norms = [], []
    for _ in range(3):
        state, metrics = art.fn(state, pipe.next_sync())
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    _close(np.array(losses), np.array(jlosses), what="losses")
    _close(np.array(norms), np.array(jnorms), what="grad norms")
    assert state["step"] == 3 and state["opt"]["count"] == 3
    want = tree_leaves(convert.tree_from_numpy(jfinal["opt"]["master"]))
    got = tree_leaves(state["opt"]["master"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, what="master")
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(convert.tree_from_numpy(jfinal["params"]))):
        _close(a, b, what="params")


# ---------------------------------------------------------------------------
# Data, checkpoints, entry points
# ---------------------------------------------------------------------------
def test_pipeline_tokens_equal_jax():
    jp, tp = JPipe(JCFG, JSHAPE, seed=5), SyntheticTokenPipeline(CFG, SHAPE, seed=5)
    for _ in range(2):
        jb, tb = jp.next_sync(), tp.next_sync()
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(), np.asarray(jb[key]))
    assert tp.state().step == 2


def _loop(tmp, steps, ckpt_dir=None):
    art = build_train_step(CFG, MemoryPlan(4, 2, n_persist=4, n_checkpoint=1), "cpu", SHAPE,
                           adam=AdamConfig(lr=LR))
    mgr = CheckpointManager(str(ckpt_dir), keep=2) if ckpt_dir else None
    return train_loop(art, SyntheticTokenPipeline(CFG, SHAPE, seed=0, device="cpu"), mgr,
                      LoopConfig(total_steps=steps, checkpoint_every=2, log_every=0),
                      generator=torch.Generator().manual_seed(0), log=lambda s: None)


def test_checkpoint_resume_equals_straight_run(tmp_path):
    straight = _loop(tmp_path, 4)
    first = _loop(tmp_path, 2, tmp_path / "ck")
    assert first.resumed_from is None and CheckpointManager(str(tmp_path / "ck")).steps() == [2]
    second = _loop(tmp_path, 4, tmp_path / "ck")
    assert second.resumed_from == 2 and second.steps_run == 2
    assert first.losses + second.losses == straight.losses
    for key in ("params", "opt"):
        trees = [{k: v for k, v in st[key].items() if k != "count"} for st in
                 (second.state, straight.state)]
        for a, b in zip(*(tree_leaves(t) for t in trees)):
            assert torch.equal(a, b)
    assert second.state["opt"]["count"] == 4 and second.state["step"] == 4


def test_fused_adam_gets_dense_grads_with_tied_embeddings(monkeypatch):
    """The CUDA kernel takes contiguous tensors only; a tied embedding's
    gradient (lookup + transposed head) comes out strided."""
    from repro_torch import kernels as K

    seen = []
    plain = K.fused_adam_update
    monkeypatch.setattr(K, "fused_adam_update",
                        lambda p, g, *rest: seen.append(g.is_contiguous()) or plain(p, g, *rest))
    cfg = reduced(get_config("gpt2-1b"), dtype="float32")
    assert cfg.tie_embeddings
    art = build_train_step(cfg, MemoryPlan(4, 2, n_persist=4), "cpu", SHAPE)
    state, metrics = art.fn(art.init(), SyntheticTokenPipeline(cfg, SHAPE).next_sync())
    assert seen and all(seen) and np.isfinite(float(metrics["loss"]))


def test_loop_records_train_metrics():
    from repro_torch import obs

    tel = obs.Telemetry()
    art = build_train_step(CFG, MemoryPlan(4, 2, n_persist=4), "cpu", SHAPE)
    res = train_loop(art, SyntheticTokenPipeline(CFG, SHAPE, seed=0), None,
                     LoopConfig(total_steps=2, log_every=0), log=lambda s: None, telemetry=tel)
    snap = tel.registry.snapshot()
    assert tel.registry.names() <= set(obs.DOCUMENTED_METRICS)
    assert snap["train.steps"]["value"] == 2 and snap["train.loss"]["value"] == res.losses[-1]
    assert len([e for e in tel.tracer.events if e["name"] == "train.step"]) == 2


def test_launcher_prints_json_summary(capsys):
    rc = launch_train.main(["--arch", "mistral-7b", "--reduced", "--steps", "2", "--batch",
                            "2", "--seq", "32", "--device", "cpu", "--plan", "fsdp"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
    assert summary["device"] == "cpu"


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_train_step(CFG, MemoryPlan(4, 2, n_persist=4), None, SHAPE)


OUT_OF_SCOPE = {  # (plan, ranks, the error and what it names)
    # the xla path runs on several ranks; a global batch of 4 rows does not
    # split over 4 ranks and 2 microbatches
    "xla_sync_on_ranks": (dict(n_persist=0, microbatch=2), 4, ValueError, "does not split"),
    "manual_sync_with_swap": (dict(n_persist=4, n_swap=1, sync_mode="manual",
                                   grad_compress="int8_ef"), 1, ValueError, "manual"),
}


@pytest.mark.parametrize("name", sorted(OUT_OF_SCOPE))
def test_out_of_scope_plans_raise(name):
    """Manual sync, gradient compression and the xla path on several ranks
    run now (``tests/test_torch_dist*.py``); what still raises: a batch
    that does not split over the ranks and the microbatches, and a manual
    plan no kind lowers (swap blocks: the reference's ``ValueError``)."""
    from repro_torch.launch.mesh import LocalMesh

    plan_kw, world, err, match = OUT_OF_SCOPE[name]
    mesh = LocalMesh(0, world, None, torch.device("cpu"))
    with pytest.raises(err, match=match):
        build_train_step(CFG, MemoryPlan(4, 2, **plan_kw), "cpu", SHAPE, mesh=mesh)


@pytest.mark.parametrize("argv", [["--plan", "auto"], ["--target-hw", "h100-sxm"]])
def test_launcher_planner_options_raise(argv, capsys):
    """The planner's options no longer raise: ``--plan auto`` (the default)
    searches against the local spec, ``--target-hw`` against a named one,
    and the run prints its searched plan and trains (chunks parked on the
    CPU device, as the JAX launcher parks them)."""
    rc = launch_train.main(["--arch", "mistral-7b", "--reduced", "--steps", "2", "--batch",
                            "2", "--seq", "64", "--device", "cpu", *argv])
    assert rc == 0
    out = capsys.readouterr().out
    hw = "h100-sxm" if "--target-hw" in argv else "cpu-host"
    assert "[train] searched plan: persist=" in out and f" on {hw}," in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])


def test_train_state_params_require_grad_in_run_layout():
    art = build_train_step(CFG, MemoryPlan(4, 2, n_persist=4), "cpu", SHAPE)
    state = art.init(torch.Generator().manual_seed(0))
    params = state["params"]
    assert all(p.requires_grad for p in tree_leaves(params))
    assert params["runs"][0]["pos0"]["attn"]["wq"].shape == (2, CFG.d_model, CFG.num_heads * 32)
    assert dataclasses.asdict(art.plan)["n_chunks"] == 4
