"""The port's xla gradient sync on several data ranks, at 4 gloo ranks,
against the JAX package's one-device xla step over the global batch with
the same plan: ZeRO-sharded ``hbm`` chunks, host chunks with and without
``host_params`` (a swap block, a checkpointed block, microbatches) and
``zero1_persistent``, under each wire format; the int8 scale of a sharded
leaf against the reference's whole-leaf quantizer; the port against itself
on one rank; a 4-rank checkpoint resumed; ``launch.train --nproc 4``.

Reduced ``llama3-405b`` in fp32 at ``ShapeConfig("tiny", 32, 16, "train")``,
each plan's parameters carried from that plan's JAX init by
``repro_torch.models.convert``. The 4 ranks (``torch_dist_ranks.
xla_steps``) are spawned once for the module. Without compression and
under bf16 losses, grad norms and fp32 masters after 3 steps are held at
``TOL = 1e-4`` with the Adam-eps exception ``tests/test_torch_dist_train.py``
states (at most ``1e-5`` of the masters, by at most ``MASTER_ABS``). Under
int8 + EF the 4 ranks reduce in another order than the one device, and a
value at a rounding edge lands on the other int8 neighbour: where that
edge is between 0 and one step, Adam's first steps move the master by the
whole learning rate. The losses are held at ``RTOL_INT8`` (measured on
this CPU: at most 1.56e-4 relative, ``zero`` at step 3), tighter than the
manual path's 2e-2, and the masters' distance from JAX's at
``INT8_UPDATE_GAP`` of JAX's own update (measured: at most 0.0576, `zero`).
"""
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
from repro.dist import collectives as JC
from repro.optim.adam import AdamConfig as JAdam
from repro.train.step_builder import build_train_step as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotuner import search
from repro_torch.core.cost_model import build_workload
from repro_torch.core.hardware import LOCAL_CPU_HW, MeshSpec
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models import convert
from repro_torch.optim import adam as OPT
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.train import sync as SYNC
from repro_torch.train.step_builder import build_train_step

import torch_dist_ranks as R

import torch_cores

torch_cores.share_cores()

TOL = 1e-4
RTOL_INT8 = 1e-3
INT8_UPDATE_GAP = 0.1
MASTER_ABS = 1e-3
# the port at 4 ranks against itself at 1: the same arithmetic, summed in
# another order (fp32 reduction order), and Adam's eps exception as above
SELF_TOL = 1e-5
JCFG = jreduced(jget_config("llama3-405b"), dtype="float32")
JSHAPE = JShape("tiny", 32, 16, "train")
CFG = reduced(get_config("llama3-405b"), dtype="float32")
SHAPE = ShapeConfig("tiny", 32, 16, "train")
PLAN_OF = {f"{n}_{c}": n for n, c in R.XLA_CASES}
CASES = list(PLAN_OF)


def _close(out, ref, tol, what=""):
    a, b = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    excess = (np.abs(a - b) - tol * (1.0 + np.abs(b))).max()
    assert excess <= 0.0, f"{what}: max |diff| {np.abs(a - b).max()} beyond {tol}"


def _masters_close(got, want, tol, what):
    """fp32 masters at ``tol``, except where Adam divides by a gradient at
    its eps: at most 1e-5 of them beyond ``tol``, none beyond
    ``MASTER_ABS``."""
    assert len(got) == len(want)
    off = total = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape, (what, a.shape, b.shape)
        diff = np.abs(a - b)
        assert diff.max() <= MASTER_ABS, (what, diff.max())
        off += int((diff > tol * (1 + np.abs(b))).sum())
        total += a.size
    assert off <= 1e-5 * total, (what, off, total)


def _jax_step(name: str, compress: str):
    """The JAX one-device xla step of the plan: (artifacts, fresh state)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    plan = JPlan(4, 2, grad_compress=compress, **R.XLA_PLANS[name][0])
    art = j_build(JCFG, plan, mesh, JSHAPE, adam=JAdam(lr=R.LR))
    return art, art.init(jax.random.PRNGKey(0))


def _jax_case(name: str, compress: str):
    """3 steps of the JAX step over the global batch: losses and norms,
    the fp32 masters before and after them."""
    art, state = _jax_step(name, compress)
    init = jax.device_get(state["opt"]["master"])
    fn = jax.jit(art.fn)
    pipe = JPipe(JCFG, JSHAPE, seed=0)
    losses, norms = [], []
    for _ in range(R.XLA_STEPS):
        state, m = fn(state, pipe.next_sync())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "init_master": [np.asarray(x) for x in jax.tree.leaves(init)],
            "master": [np.asarray(x) for x in jax.tree.leaves(
                jax.device_get(state["opt"]["master"]))]}


@pytest.fixture(scope="module")
def inits():
    """Each plan's JAX init (its run layout; the same for every wire
    format), as the port's tensors."""
    return {n: convert.tree_from_numpy(jax.device_get(_jax_step(n, "none")[1]["params"]))
            for n in R.XLA_PLANS}


@pytest.fixture(scope="module")
def both(inits, tmp_path_factory):
    """The 4 ranks, started first, and the JAX steps run while they train:
    (JAX results, ranks' results)."""
    d = str(tmp_path_factory.mktemp("dist_xla"))
    path = f"{d}/params.pt"
    torch.save(inits, path)
    wait = R.start_ranks("xla_steps", d, path)
    ref = {f"{n}_{c}": _jax_case(n, c) for n, c in R.XLA_CASES}
    return ref, wait()


@pytest.fixture(scope="module")
def jax_ref(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


@pytest.fixture(scope="module")
def one_rank(inits):
    """The port's own single-device step (``make_strategy`` at world one)
    from the same parameters."""
    out = {}
    for n, c in R.XLA_CASES:
        plan = R.xla_plan(n, c)
        art = build_train_step(CFG, plan, "cpu", SHAPE, adam=AdamConfig(lr=R.LR))
        assert art.strategy.kind == "xla" and not art.strategy.sharded
        state = art.place_state(OPT.tree_map(lambda t: t.clone(), inits[n]))
        pipe = SyntheticTokenPipeline(CFG, SHAPE, seed=0)
        losses, norms = [], []
        for _ in range(R.XLA_STEPS):
            state, m = art.fn(state, pipe.next_sync())
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{n}_{c}"] = {"losses": losses, "norms": norms, "master": [
            t.numpy().copy() for t in tree_leaves(state["opt"]["master"])]}
    return out


@pytest.mark.parametrize("case", CASES)
def test_xla_steps_hold_jax(ranks, jax_ref, case):
    """3 steps at 4 ranks against the JAX one-device step with the same
    plan: losses and grad norms, and the fp32 masters made whole from the
    shards (``TOL``; int8 + EF: losses at ``RTOL_INT8``). Every rank agrees
    on the losses and the masters bitwise."""
    runs = [r[case] for r in ranks]
    ref = jax_ref[case]
    assert all(r["kind"] == "xla" and r["sharded"] for r in runs)
    run = runs[0]
    if case.endswith("int8_ef"):
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=RTOL_INT8)
        assert min(run["ef_norms"]) > 0
        gap = sum(float(np.square(a - b).sum()) for a, b in zip(run["master"], ref["master"]))
        upd = sum(float(np.square(b - i).sum())
                  for b, i in zip(ref["master"], ref["init_master"]))
        assert upd > 0 and np.sqrt(gap / upd) <= INT8_UPDATE_GAP, np.sqrt(gap / upd)
    else:
        _close(run["losses"], ref["losses"], TOL, "losses")
        _close(run["norms"], ref["norms"], TOL, "grad norms")
        _masters_close(run["master"], ref["master"], TOL, case)
    for r in runs[1:]:
        assert r["losses"] == run["losses"] and r["norms"] == run["norms"]
        for a, b in zip(r["master"], run["master"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CASES)
def test_xla_layout_per_placement(ranks, case):
    """Shards where the reference's table puts them: a non-persistent
    chunk's ``zero`` leaves a quarter along their dim, persistent leaves
    whole (their states a quarter under ``zero1_persistent``), residuals
    shaped like the gradients, the bf16 weights the masters' cast."""
    run = ranks[0][case]
    zero1 = R.XLA_PLANS[PLAN_OF[case]][0].get("zero1_persistent", False)
    assert any(d is not None for d in run["opt_dims"])
    for d, od, local, mshape, full in zip(run["dims"], run["opt_dims"], run["param_shapes"],
                                          run["master_shapes"], run["master"]):
        if d is None:
            assert local == full.shape
        else:
            assert local[d] * R.WORLD == full.shape[d]
        assert od == d or (zero1 and d is None)
        if od is not None:
            assert mshape[od] * R.WORLD == full.shape[od]
    if run["ef_shapes"]:
        assert run["ef_shapes"] == run["param_shapes"]
    for p, m in zip(run["params"], run["master"]):
        np.testing.assert_array_equal(p, m)  # fp32 weights: the master itself


@pytest.mark.parametrize("case", [c for c in CASES if c.endswith("int8_ef")])
def test_replicated_residuals_equal_on_every_rank(ranks, case):
    """A replicated leaf's reduced gradient is the same on every rank, so
    its residual stays the same after every step."""
    base = ranks[0][case]["rep_ef"]
    assert len(base) == R.XLA_STEPS and base[0]
    for r in ranks[1:]:
        for step_a, step_b in zip(r[case]["rep_ef"], base):
            for a, b in zip(step_a, step_b):
                np.testing.assert_array_equal(a, b)


def test_int8_scale_of_a_sharded_leaf_is_the_whole_leafs(ranks):
    """One leaf sharded 4 ways, its shards' absmaxes 1000x apart: every
    rank's payload, scale, dequantized shard and residual equal the
    reference's ``compressed_all_reduce(x, err, mesh=None)`` on the whole
    leaf bitwise. A per-shard scale fails this."""
    x, err = R.xla_absmax_inputs()
    c = jnp.asarray(x) + jnp.asarray(err)
    jq, js = JC._quantize_int8(c)
    javg, jerr = JC.compressed_all_reduce(jnp.asarray(x), jnp.asarray(err))
    w = R.XLA_ABSMAX_SHAPE[R.XLA_ABSMAX_DIM] // R.WORLD
    for r, out in enumerate(ranks):
        got = out["absmax"]
        sl = np.s_[:, r * w:(r + 1) * w]
        np.testing.assert_array_equal(got["scale"].view(np.int32),
                                      np.asarray(js).view(np.int32))
        np.testing.assert_array_equal(got["q"], np.asarray(jq)[sl])
        np.testing.assert_array_equal(got["local"].view(np.int32),
                                      np.asarray(javg)[sl].view(np.int32))
        np.testing.assert_array_equal(got["err"].view(np.int32),
                                      np.asarray(jerr)[sl].view(np.int32))


@pytest.mark.parametrize("case", CASES)
def test_four_ranks_hold_one_rank(ranks, one_rank, case):
    """The port at 4 ranks against its own single-device step from the same
    parameters: losses and norms at ``SELF_TOL``, masters at ``SELF_TOL``
    with the eps exception. A bf16 wire rounds the reduced gradients, and
    a few land across a bf16 edge (33 of 459,392 masters past ``SELF_TOL``
    here): its masters at ``TOL``. Int8 + EF: losses at ``RTOL_INT8``."""
    run, ref = ranks[0][case], one_rank[case]
    if case.endswith("int8_ef"):
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=RTOL_INT8)
        return
    _close(run["losses"], ref["losses"], SELF_TOL, "losses")
    _close(run["norms"], ref["norms"], SELF_TOL, "grad norms")
    _masters_close(run["master"], ref["master"], TOL if case.endswith("bf16") else SELF_TOL,
                   case)


def test_xla_checkpoint_resumes_bitwise(ranks):
    """Each rank saves its shards, pinned-host states and residuals at step
    2; resumed, it ends at step 4 bitwise where the uninterrupted run ends."""
    for r in ranks:
        ck = r["checkpoint"]
        assert ck["resumed_from"] == 2 and ck["state_equal"]
        assert ck["losses"] == ck["straight_losses"]


def test_launcher_auto_runs_the_plan_searched_over_both_sync_modes(ranks):
    """``--plan auto`` at 4 ranks runs ``search(w)`` (every sync mode) on
    ``MeshSpec((4,), ("data",))``, as searched."""
    summary = ranks[0]["auto"]
    assert all(r["auto"] is None for r in ranks[1:])
    w = build_workload(reduced(get_config("llama3-405b")), ShapeConfig("cli", 32, 16, "train"),
                       MeshSpec((4,), ("data",)), LOCAL_CPU_HW)
    plan = search(w).plan
    assert summary["plan"] == plan.describe() and summary["world"] == 4
    assert summary["strategy"] == ("xla" if plan.sync_mode == "xla"
                                   else plan.manual_sync_kind())
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])


def test_make_strategy_xla_on_four_ranks():
    """Every plan the xla path lowers is a sharded ``XlaSync`` at world 4,
    with and without a model axis (``tp_degree=2``)."""
    mesh = LocalMesh(0, 4, None, torch.device("cpu"))
    for n, c in R.XLA_CASES:
        s = SYNC.make_strategy(R.xla_plan(n, c), mesh)
        assert isinstance(s, SYNC.XlaSync) and s.sharded and s.kind == "xla"
    s = SYNC.make_strategy(MemoryPlan(4, 2, n_persist=0), mesh, tp_degree=2)
    assert isinstance(s, SYNC.XlaSync) and s.sharded and s.kind == "xla"


def test_launcher_nproc_fsdp_runs_the_xla_path(capsys):
    rc = launch_train.main(["--arch", "llama3-405b", "--reduced", "--nproc", "4", "--steps",
                            "4", "--batch", "16", "--seq", "32", "--device", "cpu",
                            "--plan", "fsdp"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert summary["world"] == 4 and summary["strategy"] == "xla"
    assert summary["steps"] == 4 and np.isfinite(summary["final_loss"])
    assert summary["plan"].startswith("persist=0/")
