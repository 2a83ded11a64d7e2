"""The port's act policies and host-resident weights against the JAX package's,
on the CPU.

Inputs come from seeded numpy or from one JAX ``init`` (carried over bit for
bit by ``repro_torch.models.convert``). Comparisons are in fp32. Tolerances:

* ``compress_act``: the forward value bitwise (the same quantizer, the same
  casts), the gradient bitwise straight through;
* the port against itself: a recomputed ``swap`` / ``compress8`` /
  ``compress16`` position gives the same hidden states and gradients,
  bitwise, as the same position with every activation kept (the replay
  reads the stored sites); host weights give the same step, bitwise, as
  device weights;
* three steps against the JAX step, from one JAX init: the first loss and
  gradient norm within ``1e-4 * (1 + |jax|)`` (the same ops on the same
  state, summed in another order); the three losses within ``LOSS_TOL``
  and each leaf's Adam update (final master less initial) within
  ``UPDATE_TOL`` in relative L2 norm. Plans that quantize (``compress8``,
  ``compress16``) get the looser pair: the two frameworks' activations
  differ by fp32 rounding, which flips a rounding of an int8 step or a bf16
  ulp now and then, and Adam's first updates are about ``lr * sign(g)``
  per element, so a gradient element near 0 can move either way (measured:
  losses 6e-4 apart after three steps, updates 5e-2 apart, while the
  first step agrees to 2e-6). Plans that only move bytes (``swap``, host
  weights) stay at 1e-4 and 1e-3.
"""
import gc

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
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JAdam
from repro.train.step_builder import build_train_step as j_build
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.models.offload import HostIO
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.train.step_builder import build_train_step

import torch_cores

torch_cores.share_cores()

JCFG = jreduced(jget_config("mistral-7b"), num_kv_heads=2, dtype="float32")
CFG = reduced(get_config("mistral-7b"), num_kv_heads=2, dtype="float32")
SHAPE = ShapeConfig("tiny", 32, 4, "train")
JSHAPE = JShape("tiny", 32, 4, "train")
LR = 3e-3
TOL = 1e-4


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
# The save-site seam against JAX's compress_act
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["compress8", "compress16"])
def test_compress_act_value_and_straight_through_grad_match_jax(mode):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 24, 64)) * np.exp(rng.standard_normal((2, 24, 1)))
         ).astype(np.float32)
    x[0, 3] = 0.0  # a zero row
    ct = rng.standard_normal(x.shape).astype(np.float32)
    JM.set_act_quant_kernel(False)  # the JAX oracle: the kernel needs a TPU
    try:
        jy, vjp = jax.vjp(lambda t: JM.compress_act(t, mode), jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(ct))
    finally:
        JM.set_act_quant_kernel(None)
    tx = torch.from_numpy(x).requires_grad_()
    y = TM.compress_act(tx, mode)
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(ct))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(jdx))
    if mode == "compress8":  # straight through: the cotangent itself
        np.testing.assert_array_equal(dx.numpy(), ct)
        assert not np.array_equal(y.detach().numpy(), x)  # the value is quantized


# ---------------------------------------------------------------------------
# Replay from stored sites == keeping everything (the port against itself)
# ---------------------------------------------------------------------------
def _model_params(dtype="float32"):
    cfg = reduced(get_config("mistral-7b"), num_kv_heads=2, dtype=dtype)
    params = TM.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    return cfg, params


def _stack_grads(cfg, params, x, policy, *, kept: bool):
    """Hidden states and gradients of two layers under ``policy``: through
    ``apply_runs`` (recomputed from stored sites), or with ``kept`` through
    plain ``apply_position`` calls that keep every activation (their sites
    never sealed: each acts as in the forward, and nothing is replayed)."""
    leaves = [t.clone().requires_grad_() for t in tree_leaves(params["blocks"])]
    it = iter(leaves)
    blocks = convert_tree(params["blocks"], it)
    xx = x.clone().requires_grad_()
    if kept:
        h = xx
        for rep in TM._unstack(blocks, TM.num_repeats(cfg)):
            h, _ = TM.apply_position(rep["pos0"], h, cfg, 0,
                                     sites=TM.ActSites(policy, HostIO("cpu")))
    else:
        h, _ = TM.apply_runs([TM.Run(params=blocks, n_repeats=TM.num_repeats(cfg),
                                     act_policy=policy)], xx, cfg)
    grads = torch.autograd.grad((h.float() ** 2).sum(), [xx] + leaves)
    return h.detach(), grads


def convert_tree(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    return {k: convert_tree(tree[k], it) for k in sorted(tree)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["swap", "compress8", "compress16"])
def test_recomputed_sites_equal_kept_activations_bitwise(policy, dtype):
    cfg, params = _model_params(dtype)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, cfg.d_model))
                         .astype(np.float32)).to(params["embed"]["tok"].dtype)
    h_kept, g_kept = _stack_grads(cfg, params, x, policy, kept=True)
    h_re, g_re = _stack_grads(cfg, params, x, policy, kept=False)
    assert torch.equal(h_kept, h_re)
    assert all(torch.equal(a, b) for a, b in zip(g_kept, g_re))


# ---------------------------------------------------------------------------
# Census: what one position keeps FWD->BWD under each policy
# ---------------------------------------------------------------------------
def _storages() -> dict:
    out = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.device.type == "cpu" and o.layout == torch.strided:
            st = o.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return out


def _census(cfg, rep, x, policy):
    """(bytes one position keeps for its backward beside its input, bytes
    it swapped out), from the tensors alive after its forward: those the
    recomputed paths hold in Python, and those autograd saves, held by a
    pass-through saved-tensor hook."""
    tel = obs.Telemetry()
    io = HostIO("cpu", tel.registry)
    kept = []
    gc.collect()
    before = _storages()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: kept.append(t) or t, lambda t: t):
        y, _ = TM.apply_superblock(rep, x, cfg, act_policy=policy, io=io)
    gc.collect()
    new = {p: n for p, n in _storages().items()
           if p not in before and p != y.untyped_storage().data_ptr()}
    swapped = int(tel.registry.snapshot()["train.act_swap_out_bytes"]["value"])
    return sum(new.values()), swapped


def test_saved_census_per_policy_matches_byte_arithmetic():
    cfg, params = _model_params("bfloat16")
    rep = TM._unstack(params["blocks"], TM.num_repeats(cfg))[0]
    for t in tree_leaves(rep):
        t.requires_grad_(True)
    b, s, d = 2, 32, cfg.d_model
    rows = b * s
    site = rows * d * 2  # one bf16 site tensor (norm1 out, mixer out, MLP out)
    x = torch.randn(b, s, d, dtype=torch.bfloat16).requires_grad_()
    got = {pol: _census(cfg, rep, x, pol) for pol in TM.ACT_POLICIES}
    # beside the input x, which the caller holds under every policy
    # two sites kept: norm1's output and the mixer's (the MLP output only
    # feeds the residual add, whose gradient reads neither operand)
    assert got["checkpoint"] == (0, 0)
    assert got["compress8"] == (2 * (rows * d + 4 * rows), 0)  # int8 rows + fp32 scales
    assert got["compress16"] == (2 * site, 0)
    assert got["swap"] == (2 * site, 2 * site)  # all of it in (pinned) host memory
    assert got["none"][0] > got["compress16"][0] and got["none"][1] == 0


# ---------------------------------------------------------------------------
# Three steps against the JAX step
# ---------------------------------------------------------------------------
PLANS = {  # name: (plan keywords, quantizes)
    "compress8": (dict(n_persist=4, act_policies=("compress8", "compress8")), True),
    "compress16_checkpoint": (dict(n_persist=4, act_policies=("compress16", "checkpoint"),
                                   microbatch=2), True),
    "swap": (dict(n_persist=4, n_swap=2, microbatch=2), False),
    "host_params_nbuffer0": (dict(n_persist=2, n_host=2, host_params=True, n_buffer=0), False),
    "host_params_nbuffer1": (dict(n_persist=2, n_host=2, host_params=True, n_buffer=1,
                                  microbatch=2), False),
    "mixed": (dict(n_persist=1, n_host=2, host_params=True, n_buffer=1,
                   act_policies=("compress8", "swap")), True),
}
LOSS_TOL = {True: 1e-3, False: 1e-4}
UPDATE_TOL = {True: 1e-1, False: 1e-3}


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


def _torch_steps(plan, params, steps=3, telemetry=None):
    art = build_train_step(CFG, plan, "cpu", SHAPE, adam=AdamConfig(lr=LR), telemetry=telemetry)
    state = art.place_state(params)
    pipe = SyntheticTokenPipeline(CFG, SHAPE, seed=0)
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = art.fn(state, pipe.next_sync())
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return art, state, losses, norms


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_plan_steps_match_jax(plan_name):
    plan_kw, quantizes = PLANS[plan_name]
    jinit, jfinal, jlosses, jnorms = _jax_steps(plan_kw)
    plan = MemoryPlan(4, 2, **plan_kw)
    art, state, losses, norms = _torch_steps(plan, convert.tree_from_numpy(jinit["params"]))
    assert [r.act_policy for r in art.runs for _ in range(r.length)] == plan.block_policies()
    _close(losses[0], jlosses[0], what="first loss")
    _close(norms[0], jnorms[0], what="first grad norm")
    _close(np.array(losses), np.array(jlosses), tol=LOSS_TOL[quantizes], what="losses")
    assert state["step"] == 3 and state["opt"]["count"] == 3
    init = tree_leaves(convert.tree_from_numpy(jinit["opt"]["master"]))
    want = tree_leaves(convert.tree_from_numpy(jfinal["opt"]["master"]))
    got = tree_leaves(state["opt"]["master"])
    assert len(got) == len(want) == len(init)
    for a, b, i in zip(got, want, init):
        rel = float((a - b).norm() / (b - i).norm())
        assert rel <= UPDATE_TOL[quantizes], f"{plan_name}: an update {rel} from JAX's"
    # the bf16 weights are the masters' cast, wherever they live
    for p, m in zip(tree_leaves(state["params"]), got):
        assert torch.equal(p.detach(), m.to(p.dtype))


# ---------------------------------------------------------------------------
# Host weights: the same step as device weights; bytes fetched per buffering
# ---------------------------------------------------------------------------
def _chunk_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _as_runs(jparams, plan):
    """The JAX init as the port's state tree for ``plan``'s run layout."""
    from repro_torch.train.step_builder import plan_runs

    params = convert.tree_from_numpy(jparams)
    blocks = params.pop("blocks")
    params["runs"] = [_slice(blocks, r.start, r.length) for r in plan_runs(plan, 2)]
    return params


def _slice(tree, start, length):
    if isinstance(tree, torch.Tensor):
        return tree[start:start + length].clone()
    return {k: _slice(v, start, length) for k, v in tree.items()}


@pytest.mark.parametrize("n_buffer,policies,group", [(0, ("none", "none"), 1),
                                                     (1, ("checkpoint", "none"), 1),
                                                     (0, ("compress8", "swap"), 1),
                                                     (0, ("checkpoint", "checkpoint"), 2)])
def test_host_weights_step_equals_device_weights_and_counts_fetches(n_buffer, policies, group):
    jparams = jax.device_get(JM.init_params(JCFG, jax.random.PRNGKey(2)))
    base_kw = dict(n_persist=1, act_policies=policies, microbatch=2, ckpt_group=group)
    dev_plan = MemoryPlan(4, 2, **base_kw)
    _, dev_state, dev_losses, _ = _torch_steps(dev_plan, _as_runs(jparams, dev_plan), 2)
    tel = obs.Telemetry()
    plan = MemoryPlan(4, 2, n_host=3, host_params=True, n_buffer=n_buffer, **base_kw)
    art, state, losses, _ = _torch_steps(plan, _as_runs(jparams, plan), 2, telemetry=tel)
    assert losses == dev_losses
    for a, b in zip(tree_leaves(state["params"]["runs"]) + tree_leaves(state["params"]["head"]),
                    tree_leaves(dev_state["params"]["runs"])
                    + tree_leaves(dev_state["params"]["head"])):
        assert torch.equal(a, b)
    # every host chunk (both blocks and the head) is fetched once per
    # microbatch in the forward, an unbuffered block once more for its backward
    per_block = _chunk_bytes(_slice(convert.tree_from_numpy(jparams["blocks"]), 0, 1))
    head = _chunk_bytes(convert.tree_from_numpy(jparams["final_norm"])) + _chunk_bytes(
        convert.tree_from_numpy(jparams["head"]))
    refetched = sum(1 for c in (1, 2) if not plan.chunk_buffered(c)) * per_block
    steps, mbs = 2, 2
    snap = tel.registry.snapshot()
    assert snap["train.weight_fetch_bytes"]["value"] == steps * mbs * (
        2 * per_block + head + refetched)
    site = SHAPE.global_batch // mbs * SHAPE.seq_len * CFG.d_model * 4  # one fp32 site
    n_swap, n_c8 = policies.count("swap"), policies.count("compress8")
    assert snap["train.act_swap_out_bytes"]["value"] == steps * mbs * 2 * n_swap * site
    assert snap["train.act_swap_in_bytes"]["value"] == steps * mbs * 2 * n_swap * site
    assert snap["train.act_quantize_launches"]["value"] == steps * mbs * 3 * n_c8
    assert tel.registry.names() <= set(obs.DOCUMENTED_METRICS)
    # host weights take no gradient themselves: their device proxies do
    assert all(not t.requires_grad for t in tree_leaves(state["params"]["runs"]))
    assert all(t.requires_grad for t in tree_leaves(state["params"]["embed"]))


def test_checkpoint_resume_with_host_weights_and_swap(tmp_path):
    """A plan with host weights, swap and compress8 layers resumes from its
    checkpoint to the same losses and state as a straight run."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.train.loop import LoopConfig, train_loop

    plan = MemoryPlan(4, 2, n_persist=1, n_host=2, host_params=True, n_buffer=1,
                      act_policies=("swap", "compress8"))

    def run(steps, ckpt_dir=None):
        art = build_train_step(CFG, plan, "cpu", SHAPE, adam=AdamConfig(lr=LR))
        mgr = CheckpointManager(str(ckpt_dir), keep=2) if ckpt_dir else None
        return train_loop(art, SyntheticTokenPipeline(CFG, SHAPE, seed=0), mgr,
                          LoopConfig(total_steps=steps, checkpoint_every=2, log_every=0),
                          generator=torch.Generator().manual_seed(0), log=lambda s: None)

    straight = run(4)
    first = run(2, tmp_path / "ck")
    second = run(4, tmp_path / "ck")
    assert second.resumed_from == 2 and first.losses + second.losses == straight.losses
    for a, b in zip(tree_leaves(second.state["params"]), tree_leaves(straight.state["params"])):
        assert torch.equal(a, b)
    assert not any(t.requires_grad for t in tree_leaves(second.state["params"]["head"]))
