"""The model axis: tensor parallelism, ``dp_only`` and sequence sharding on
the xla path, at 4 gloo ranks, against the JAX package's one-device xla
step over the global batch with the same plan.

Every family in fp32 at ``ShapeConfig("tiny", 32, 16, "train")``, each
model's parameters carried from its plan's JAX init by
``repro_torch.models.convert`` (``torch_dist_ranks.TP_MODELS`` /
``TP_CASES``): reduced ``llama3-405b`` at data x model 2 x 2 and 1 x 4,
with and without ``seq_shard_acts``, ``dp_only`` at 2 x 2 (which also
equals the port at data 4), a host chunk plan under int8 + EF at 2 x 2,
compressed saves (int8 and bf16) under ``seq_shard_acts`` at 2 x 2, and
with ``num_kv_heads = 2`` at 1 x 4 (the reference's ``_fits`` shards
``wk`` / ``wv`` in half-heads); reduced ``qwen2-moe-a2.7b`` (4 experts,
one a rank, and the shared expert) at 1 x 4, and with ``capacity_factor``
1.0 on both sides and 2 microbatches at 4 x 1, 2 x 2 and 2 x 2
``dp_only``: the capacity drops choices, so the ranks must route the
global microbatch as the reference does (its capacity, its token order,
its aux loss); reduced ``mamba2-130m`` at 2 x 2, 1 x 4 and 1 x 4 with
``seq_shard_acts`` (the SSD on a rank's heads, ``in_proj`` and the conv
taken whole at use); the reduced hybrid (one Jamba period, one KV head)
at 2 x 2 and 1 x 4 with ``seq_shard_acts``; reduced
``seamless-m4t-large-v2`` at 2 x 2 and 1 x 4 with ``seq_shard_acts``
(the encoder and the cross-attention split) and at 1 x 4 with a vocab of
510, which 4 does not divide (the embedding and head stay whole); reduced
``llava-next-34b`` at 2 x 2 and 1 x 4 with ``seq_shard_acts`` (the
boundary splits the patches and tokens). ``seq_shard_acts`` and ``dp_only``
change only how the reference lays the step out on a mesh above one
device (its activation sharder is the identity on one device,
``make_activation_sharder``, and ``batch_axes`` differs by the model axis
alone), so each layout is held against the one JAX step of its model and
plan, which runs while the ranks train. The 4 ranks
(``torch_dist_ranks.tp_steps``) are spawned once for the module; they
also run the checkpoint race and ``launch.train --nproc 4 --model 2`` on
``llama3-405b`` and ``mamba2-130m``.

Tolerances are ``tests/test_torch_dist_xla.py``'s: losses, grad norms and
fp32 masters after 3 steps at ``TOL = 1e-4``, with its Adam-eps exception
for the masters; int8 + EF at ``RTOL_INT8`` for the losses and
``INT8_UPDATE_GAP`` for the masters; compressed saves as
``tests/test_torch_policies.py`` holds them (the first step at ``TOL``,
the losses at ``COMPRESS_LOSS_TOL``, each master's update within
``COMPRESS_UPDATE_TOL`` of JAX's: an int8 activation a step off moves
the later steps). The row-parallel products and the
vocab-parallel cross-entropy sum in another order than one device: in
fp32 that is within ``TOL``. The hybrid runs Adam at eps 1e-6 on both
sides (``torch_dist_ranks.TP_ADAM_EPS``): at 1e-8 its one-device port
already misses the JAX masters at ``TOL``.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.dist import sharding as JSH
from repro.models import model as JM
from repro.optim.adam import AdamConfig as JAdam
from repro.train.step_builder import build_train_step as j_build
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotuner import search
from repro_torch.core.cost_model import build_workload
from repro_torch.core.hardware import LOCAL_CPU_HW, MeshSpec
from repro_torch.core.plan import MemoryPlan
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim.adam import tree_leaves as OPT_LEAVES
from repro_torch.train import sync as SYNC
from repro_torch.train.step_builder import build_train_step

import torch_dist_ranks as R
from test_torch_dist_xla import (INT8_UPDATE_GAP, RTOL_INT8, SELF_TOL, TOL, _close,
                                 _masters_close)

import torch_cores

torch_cores.share_cores()

CPU = torch.device("cpu")
COMPRESS_LOSS_TOL, COMPRESS_UPDATE_TOL = 1e-3, 1e-1  # test_torch_policies.py's
JSHAPE = JShape("tiny", 32, 16, "train")
REFS = sorted({f"{m}_{p}" for m, p, _, _ in R.TP_CASES.values()})


def _jcfg(model: str):
    return R.tp_overrides(jreduced(jget_config(R.TP_MODELS[model][0]), dtype="float32"), model)


def _jax_step(ref: str):
    """The JAX one-device xla step of ``ref`` ("model_plan"): (config,
    artifacts, fresh state)."""
    model, plan = ref.split("_")
    cfg = _jcfg(model)
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    n = JM.num_repeats(cfg)
    art = j_build(cfg, JPlan(n + 2, n, **R.TP_PLANS[plan]), mesh, JSHAPE,
                  adam=JAdam(lr=R.LR, **R.tp_adam_kw(model)))
    return cfg, art, art.init(jax.random.PRNGKey(0))


def _jax_ref(cfg, art, state) -> dict:
    """3 steps of a JAX step (``_jax_step``'s triple): losses, norms, the
    fp32 masters before and after."""
    init = jax.device_get(state["opt"]["master"])
    fn = jax.jit(art.fn)
    pipe = JPipe(cfg, JSHAPE, seed=0)
    losses, norms = [], []
    for _ in range(R.TP_STEPS):
        state, m = fn(state, pipe.next_sync())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "norms": norms,
            "init_master": [np.asarray(x) for x in jax.tree.leaves(init)],
            "master": [np.asarray(x) for x in jax.tree.leaves(
                jax.device_get(state["opt"]["master"]))]}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The 4 ranks, started first, and the JAX steps run while they train:
    (JAX results by reference, ranks' results)."""
    d = str(tmp_path_factory.mktemp("tp"))
    steps = {r: _jax_step(r) for r in REFS}
    inits = {r: convert.tree_from_numpy(jax.device_get(st[2]["params"]))
             for r, st in steps.items()}
    path = f"{d}/params.pt"
    torch.save(inits, path)
    wait = R.start_ranks("tp_steps", d, path)
    ref = {r: _jax_ref(*steps.pop(r)) for r in REFS}
    return ref, wait()


@pytest.fixture(scope="module")
def jax_ref(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


@pytest.mark.parametrize("case", sorted(R.TP_CASES))
def test_tp_steps_hold_jax(ranks, jax_ref, case):
    """3 steps at 4 ranks on the case's layout against the JAX one-device
    step of its model and plan: losses, grad norms and the fp32 masters made
    whole from the 2-D shards (int8 + EF: losses at ``RTOL_INT8``, masters
    within ``INT8_UPDATE_GAP`` of JAX's update; compressed saves: the first
    step at ``TOL``, then ``COMPRESS_*``). Every rank agrees on the losses,
    norms and masters bitwise."""
    model, plan, _, _ = R.TP_CASES[case]
    runs = [r[case] for r in ranks]
    ref = jax_ref[f"{model}_{plan}"]
    run = runs[0]
    assert all(r["kind"] == "xla" for r in runs)
    if plan == "host":
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=RTOL_INT8)
        assert min(run["ef_norms"]) > 0
        gap = sum(float(np.square(a - b).sum()) for a, b in zip(run["master"], ref["master"]))
        upd = sum(float(np.square(b - i).sum())
                  for b, i in zip(ref["master"], ref["init_master"]))
        assert upd > 0 and np.sqrt(gap / upd) <= INT8_UPDATE_GAP, np.sqrt(gap / upd)
    elif plan == "compress":
        _close(run["losses"][:1], ref["losses"][:1], TOL, "first loss")
        _close(run["norms"][:1], ref["norms"][:1], TOL, "first grad norm")
        _close(run["losses"], ref["losses"], COMPRESS_LOSS_TOL, "losses")
        for a, b, i in zip(run["master"], ref["master"], ref["init_master"]):
            rel = np.linalg.norm(a - b) / np.linalg.norm(b - i)
            assert rel <= COMPRESS_UPDATE_TOL, (case, rel)
    else:
        _close(run["losses"], ref["losses"], TOL, "losses")
        _close(run["norms"], ref["norms"], TOL, "grad norms")
        _masters_close(run["master"], ref["master"], TOL, case)
    for r in runs[1:]:
        assert r["losses"] == run["losses"] and r["norms"] == run["norms"]
        for a, b in zip(r["master"], run["master"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(R.TP_CASES))
def test_tp_layout(ranks, case):
    """Each rank holds its 2-D shard: a leaf's data dim split over the data
    extent, its model dim over the model extent; the model axis splits
    ``wq``'s columns, the experts and the vocab, and nothing under
    ``dp_only``; at a data extent of one nothing splits over data."""
    _, _, (data, model), extra = R.TP_CASES[case]
    for rank, out in enumerate(ranks):
        run = out[case]
        mdims = [m for _, m in run["dims"]]
        for (d, m), local, full in zip(run["dims"], run["param_shapes"], run["master"]):
            want = list(full.shape)
            if d is not None:
                want[d] //= data
            if m is not None:
                want[m] //= model
            assert list(local) == want, (case, rank, local, full.shape)
        if model == 1 or extra.get("dp_only"):
            assert all(m is None for m in mdims)
        else:
            assert sum(m is not None for m in mdims) >= 5
        if data == 1:
            assert all(d is None for d, _ in run["dims"])


def test_dp_only_equals_data_four(ranks):
    """``dp_only`` folds the model axis into the batch: at 2 x 2 the step is
    the port's at data 4, summed in another order (``SELF_TOL``, masters
    with the Adam-eps exception)."""
    a, b = ranks[0]["dense_2x2_dp_only"], ranks[0]["dense_4x1"]
    _close(a["losses"], b["losses"], SELF_TOL, "losses")
    _close(a["norms"], b["norms"], SELF_TOL, "grad norms")
    _masters_close(a["master"], b["master"], SELF_TOL, "dp_only vs data 4")


def test_checkpoint_ranks_resume_from_one_step(ranks):
    """The last rank's step-4 file is held back until the others have
    listed the steps: they list step 2 as the newest complete one, it lists
    step 4; every rank resumes from step 2, its own state of step 2."""
    listed = [r["race"]["listed"] for r in ranks]
    assert listed == [2] * (R.WORLD - 1) + [4]
    for rank, r in enumerate(ranks):
        assert r["race"]["resumed"] == 2
        assert r["race"]["w"] == [2.0 + rank] * 3


def _check_searched(ranks, key: str, arch: str) -> None:
    """Rank 0's launcher summary under ``key`` ran the plan searched for
    ``arch`` on the 2 x 2 mesh."""
    summary = ranks[0][key]
    assert all(r[key] is None for r in ranks[1:])
    w = build_workload(reduced(get_config(arch)), ShapeConfig("cli", 32, 16, "train"),
                       MeshSpec((2, 2), ("data", "model")), LOCAL_CPU_HW)
    plan = search(w, sp="auto", dp="auto").plan
    assert summary["arch"] == arch
    assert summary["plan"] == plan.describe()
    assert (summary["dp_only"], summary["seq_shard_acts"]) == (plan.dp_only,
                                                                plan.seq_shard_acts)
    assert summary["world"] == 4 and summary["model"] == 2
    assert summary["strategy"] == ("xla" if plan.sync_mode == "xla"
                                   else plan.manual_sync_kind(2))
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])


def test_launcher_model_axis_runs_the_searched_plan(ranks):
    """``launch.train --nproc 4 --model 2 --plan auto`` lays the ranks out
    2 x 2 and runs ``search(w, sp="auto", dp="auto")`` on
    ``MeshSpec((2, 2), ("data", "model"))``, as searched."""
    _check_searched(ranks, "auto", "llama3-405b")


def test_launcher_model_axis_runs_mamba2(ranks):
    """The same launcher at ``--arch mamba2-130m``: the Mamba-2 family
    trains the plan searched for its 2 x 2 mesh."""
    _check_searched(ranks, "auto_mamba", "mamba2-130m")


# ---------------------------------------------------------------------------
# In one process: layouts, guards
# ---------------------------------------------------------------------------
SHARD_ARCHS = ["llama3-405b", "mistral-7b", "qwen2-moe-a2.7b", "mamba2-130m",
               "seamless-m4t-large-v2", "llava-next-34b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("layout", [(2, 2), (1, 4), (4, 4), (16, 16)])
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_leaf_dims_equal_jax(arch, layout):
    """Every leaf's (data dim, model dim) under each placement, with and
    without ``dp_only``, equals the dims JAX's ``_spec`` gives ``"data"``
    and ``"model"`` on a ``(data, model)`` mesh; a data extent of one
    shards nothing (JAX's spec names the axis of extent one)."""
    data, model = layout
    mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(layout))
    jdefs = jax.tree.leaves(JM.param_defs(jget_config(arch)),
                            is_leaf=lambda x: isinstance(x, JM.ParamDef))
    tdefs = SH.def_leaves(TM.param_defs(get_config(arch)))
    for placement in ("persist", "hbm", "host"):
        for dp in (False, True):
            for jd, td in zip(jdefs, tdefs):
                spec = JSH._spec(jd, mesh, placement, dp)
                want = tuple(next((i for i, e in enumerate(spec) if e == ax), None)
                             for ax in ("data", "model"))
                if data == 1:
                    want = (None, want[1])
                assert SH.leaf_dims(td, placement, data, model, dp) == want, (
                    placement, dp, td, want)


def test_shard_activation_kinds():
    """The activation sharder's kinds as this rank's part of a whole
    tensor: ``enter`` the batch rows, ``bsd`` also the sequence under
    ``seq_shard_acts``, ``logits`` the vocab; ``dp_only`` splits the batch
    over every rank and nothing over the model axis."""
    x = torch.arange(4 * 8 * 6).reshape(4, 8, 6)
    mesh = LocalMesh(3, 4, None, CPU, model=2)  # data rank 1, model rank 1
    sp = MemoryPlan(4, 2, seq_shard_acts=True)
    assert torch.equal(SH.shard_activation(x, "enter", mesh, sp), x[2:])
    assert torch.equal(SH.shard_activation(x, "bsd", mesh, sp), x[2:, 4:])
    assert torch.equal(SH.shard_activation(x, "bsd", mesh, MemoryPlan(4, 2)), x[2:])
    assert torch.equal(SH.shard_activation(x, "logits", mesh, sp), x[2:, :, 3:])
    dp = MemoryPlan(4, 2, dp_only=True, seq_shard_acts=True)
    assert torch.equal(SH.shard_activation(x, "bsd", mesh, dp), x[3:])
    assert torch.equal(SH.shard_activation(x, "logits", mesh, dp), x[3:])
    assert SH.batch_axes(mesh, True) == ("data", "model") and SH.batch_axes(mesh) == ("data",)
    assert mesh.spec == MeshSpec((2, 2), ("data", "model"))


def _leaf_paths(tree, prefix="") -> list[str]:
    """The paths of a tree's leaves in ``tree_leaves`` order."""
    if isinstance(tree, torch.Tensor):
        return [prefix]
    items = enumerate(tree) if isinstance(tree, list) else sorted(tree.items())
    return [p for k, v in items for p in _leaf_paths(v, f"{prefix}/{k}")]


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b",
                                  "seamless-m4t-large-v2", "llava-next-34b"])
def test_uncovered_families_raise_at_model_two(arch):
    """Mamba-2, the hybrid, the encoder-decoder and the VLM, which raised
    at a model extent of 2 before the model axis split them, build there:
    each rank's state holds, of every leaf, its model shard along the dim
    ``leaf_dims`` names (held to JAX's ``_spec`` above) -- the Mamba-2
    mixer's ``in_proj``, conv and ``out_proj``, the encoder's and the
    cross-attention's projections among them -- and ``dp_only`` folds the
    axis into the batch, every leaf whole."""
    cfg = reduced(get_config(arch), dtype="float32")
    shape = ShapeConfig("tiny", 32, 16, "train")
    mesh = LocalMesh(1, 4, None, CPU, model=2)  # data rank 0, model rank 1
    nc = TM.num_repeats(cfg) + 2
    plan = MemoryPlan(nc, nc - 2, n_persist=nc)  # one persistent run
    full = build_train_step(cfg, plan, "cpu", shape).init()["params"]
    defs = TM.param_defs(cfg)
    state_defs = {**{k: v for k, v in defs.items() if k != "blocks"}, "runs": [defs["blocks"]]}
    paths = _leaf_paths(full)
    for dp in (False, True):
        art = build_train_step(cfg, dataclasses.replace(plan, dp_only=dp), "cpu", shape,
                               mesh=mesh)
        local = OPT_LEAVES(art.init()["params"])
        want_mdims = [SH.leaf_dims(d, "persist", 2, 2, dp)[1]
                      for d in SH.def_leaves(state_defs)]
        assert [ls.mdim for ls in art.leaf_syncs] == want_mdims
        split = set()
        for path, m, t, f in zip(paths, want_mdims, local, OPT_LEAVES(full)):
            assert torch.equal(t, SH.shard(f, m, 1, 2)), (arch, dp, path, t.shape, f.shape)
            if m is not None:
                split.add("/".join(path.split("/")[-2:]))
        if dp:
            assert not split
            continue
        assert "embed/tok" in split
        want = {"mamba/in_proj", "mamba/conv_w", "mamba/out_proj"} if cfg.mamba2 else set()
        want |= {"attn/wq", "attn/wo"} if "attention" in cfg.mixer_pattern else set()
        want |= {"xattn/wq", "xattn/wo"} if cfg.kind == "encdec" else set()
        assert want <= split, (arch, want - split)


def test_make_strategy_with_a_model_axis():
    """At a model extent of 2 the xla path runs the sharded ``XlaSync`` over
    the data group; a manual plan lowers only as "ddp" under ``dp_only``
    (``MemoryPlan.manual_sync_kind``), else raises the reference's
    ``ValueError``."""
    mesh = LocalMesh(0, 4, None, CPU, model=2)
    for kw in (dict(n_persist=0), dict(n_persist=1, n_host=2), dict(n_persist=4,
                                                                    dp_only=True)):
        s = SYNC.make_strategy(MemoryPlan(4, 2, **kw), mesh)
        assert isinstance(s, SYNC.XlaSync) and s.sharded and s.kind == "xla"
    manual = dict(sync_mode="manual", grad_compress="int8_ef")
    s = SYNC.make_strategy(MemoryPlan(4, 2, n_persist=4, dp_only=True, **manual), mesh)
    assert isinstance(s, SYNC.ManualSync) and s.kind == "ddp"
    for kw in (dict(n_persist=4), dict(n_persist=0), dict(n_persist=0, dp_only=True)):
        with pytest.raises(ValueError, match="manual"):
            SYNC.make_strategy(MemoryPlan(4, 2, **kw, **manual), mesh)
