"""The port's distributed sync against the JAX package: primitives at 4 gloo
ranks, sharding, strategies and guards, the ZeRO-3 schedule, and the
one-rank ``XlaSync`` steps.

The 4 ranks (``torch_dist_ranks.primitives``) are spawned once for the
module. Each rank's inputs come from ``np.random.default_rng(seed + rank)``;
the expected values are the JAX functions run per rank on one device, op
by op (``repro.dist.collectives._quantize_int8`` / ``_dequantize_int8`` /
``_chunk``, ``repro.kernels.ref.fused_quantize_ef_ref``), then the numpy
mean in rank order. Int8 payloads, scales and residuals must match
bitwise. Means are held as ``|port - ref| <= tol * (1 + |ref|)``: fp32
means ``MEAN_TOL = 1e-6`` (a mean of 4 fp32 values summed in another
order: a few ulp), bf16 wires ``BF16_TOL = 2 ** -7`` (a bf16 sum of 4
rounds up to twice).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core import cost_model as JCM
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.dist import collectives as JC
from repro.dist import sharding as JSH
from repro.kernels import ref as JR
from repro.models import model as JM
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.optim.adam import AdamConfig as JAdam
from repro.train import sync as JSYNC
from repro.train.step_builder import build_train_step as j_build
from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import cost_model as TCM
from repro_torch.core.plan import MemoryPlan
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.dist import sharding as SH
from repro_torch.launch.mesh import LocalMesh, make_local_mesh, mesh_spec
from repro_torch.models import convert
from repro_torch.models import model as TM
from repro_torch.optim.adam import AdamConfig, tree_leaves
from repro_torch.train import sync as SYNC
from repro_torch.train.step_builder import build_train_step

import torch_dist_ranks as R

import torch_cores

torch_cores.share_cores()

MEAN_TOL = 1e-6
BF16_TOL = 2.0 ** -7
TOL = 1e-4  # steps: tests/test_torch_train.py's bound
CPU = torch.device("cpu")


def _close(out, ref, tol, what=""):
    a, b = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    excess = (np.abs(a - b) - tol * (1.0 + np.abs(b))).max()
    assert excess <= 0.0, f"{what}: max |diff| {np.abs(a - b).max()} beyond {tol}"


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same_bits(out, ref, what=""):
    np.testing.assert_array_equal(_bits(out), _bits(np.asarray(ref)), err_msg=what)


def _bf16(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return R.spawn_ranks("primitives", str(tmp_path_factory.mktemp("dist_prims")))


# ---------------------------------------------------------------------------
# Primitives at 4 ranks
# ---------------------------------------------------------------------------
def test_int8_payloads_and_scales_equal_jax_bitwise(ranks):
    for r, out in enumerate(ranks):
        x, _ = R.prim_inputs(r, (9, 13))
        jq, js = JC._quantize_int8(jnp.asarray(x))
        _same_bits(out["quantize"][0], jq, f"q rank {r}")
        _same_bits(out["quantize"][1], js, f"scale rank {r}")


@pytest.mark.parametrize("key", ["int8_sync", "int8_sync_async"])
def test_int8_gather_sync_matches_jax(ranks, key):
    """``manual_int8_ef_sync``: each rank's new residual bitwise the JAX
    quantizer's on ``x + err``; the mean equal on every rank and the numpy
    mean of the dequantized payloads in rank order."""
    deq = []
    for r, out in enumerate(ranks):
        x, err = R.prim_inputs(r, (9, 13))
        c = jnp.asarray(x) + jnp.asarray(err)
        jq, js = JC._quantize_int8(c)
        jdeq = JC._dequantize_int8(jq, js)
        _same_bits(out[key][1], c - jdeq, f"residual rank {r}")
        deq.append(np.asarray(jdeq))
    want = np.mean(np.stack(deq), axis=0)
    for r, out in enumerate(ranks):
        _same_bits(out[key][0], ranks[0][key][0], f"mean rank {r} vs rank 0")
        _close(out[key][0], want, MEAN_TOL, "mean")


def test_compressed_all_reduce_matches_jax(ranks):
    deq = []
    for r, out in enumerate(ranks):
        x, err = R.prim_inputs(r, (9, 13))
        local, jerr = JC.compressed_all_reduce(jnp.asarray(x), jnp.asarray(err))
        _same_bits(out["compressed_all_reduce"][1], jerr, f"residual rank {r}")
        deq.append(np.asarray(local))
    for out in ranks:
        _close(out["compressed_all_reduce"][0], np.mean(np.stack(deq), 0), MEAN_TOL, "avg")


@pytest.mark.parametrize("key,tol,bf16", [("mean", MEAN_TOL, False),
                                          ("bf16_mean", BF16_TOL, True),
                                          ("bf16_all_reduce", BF16_TOL, True)])
def test_means_over_ranks(ranks, key, tol, bf16):
    xs = [R.prim_inputs(r, (9, 13))[0] for r in range(R.WORLD)]
    want = np.mean(np.stack([_bf16(x) if bf16 else x for x in xs]), 0)
    for out in ranks:
        _same_bits(out[key], ranks[0][key], f"{key}: equal on every rank")
        _close(out[key], _bf16(want) if bf16 else want, tol, key)


@pytest.mark.parametrize("name,shape,dim", R.RS_CASES)
def test_int8_reduce_scatter_matches_jax(ranks, name, shape, dim):
    """The chunk stack (JAX ``_chunk``, padded when the world does not
    divide ``dim``), the own-chunk residual added, ``fused_quantize_ef_ref``
    on it: payloads, scales and residuals bitwise; each owner's mean the
    numpy mean of the chunks it received; the caller's gradient is left
    as it was (a dim-0 chunk stack of an fp32 input is not a view of it)."""
    deq = []
    for r, out in enumerate(ranks):
        x, _ = R.prim_inputs(r, shape, R.SEED + 7)
        e = R.shard_err(r, shape, dim)
        ch = JC._chunk(jnp.asarray(x), dim, R.WORLD)
        ch = ch.at[r].add(jnp.asarray(e))
        jq, js, jerr = JR.fused_quantize_ef_ref(ch, r)
        got = out[f"rs_{name}"]
        assert got["input_unchanged"], f"rank {r} wrote into its input"
        _same_bits(got["q"], jq, f"q rank {r}")
        _same_bits(got["scale"], js, f"scales rank {r}")
        _same_bits(got["err"], jerr, f"residual rank {r}")
        deq.append(np.asarray(jq, np.float32) * np.asarray(js).reshape((-1,) + (1,) * len(shape)))
    stack = np.stack(deq)  # (sender, owner, *shard)
    xs = np.stack([np.asarray(JC._chunk(jnp.asarray(R.prim_inputs(r, shape, R.SEED + 7)[0]),
                                        dim, R.WORLD)) for r in range(R.WORLD)])
    for owner, out in enumerate(ranks):
        _close(out[f"rs_{name}"]["mean"], stack[:, owner].mean(0), MEAN_TOL, "int8 mean")
        _close(out[f"rs_none_{name}"], xs[:, owner].mean(0), MEAN_TOL, "fp32 mean")
        _close(out[f"rs_bf16_{name}"], _bf16(xs[:, owner]).mean(0), BF16_TOL, "bf16 mean")


def test_lazy_gather_forward_and_backward(ranks):
    """``gather_param_lazy``: the forward is the full leaf, its backward the
    compressed reduce-scatter, with the new residual written in place."""
    for out in ranks:
        assert out["lazy"] == {"forward_equal": True, "grad_equal": True,
                               "err_equal": True, "unshard_equal": True}


# ---------------------------------------------------------------------------
# Sharding against dist/sharding.py
# ---------------------------------------------------------------------------
SHARD_ARCHS = ["llama3-405b", "mistral-7b", "qwen2-moe-a2.7b", "mamba2-130m",
               "seamless-m4t-large-v2", "llava-next-34b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("world", [1, 3, 4])
@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_leaf_sync_dims_equal_jax(arch, world):
    """Every leaf's sharded dim (None: replicated) under a persistent and a
    sharded placement equals the dim JAX's ``_spec`` gives the data axis of
    a (world, 1) mesh: the first ``zero`` dim the world divides."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((world, 1)))
    jdefs = jax.tree.leaves(JM.param_defs(jget_config(arch)),
                            is_leaf=lambda x: isinstance(x, JM.ParamDef))
    tdefs = SH.def_leaves(TM.param_defs(get_config(arch)))
    assert [d.shape for d in tdefs] == [d.shape for d in jdefs]
    for placement in ("persist", "hbm"):
        want = [next((i for i, e in enumerate(JSH._spec(d, mesh, placement, False))
                      if e == "data"), None) for d in jdefs]
        got = [SH.leaf_sync_dim(d, world, placement) for d in tdefs]
        assert got == want, (placement, got, want)
    if world == 4 and arch != "llava-next-34b":
        assert any(x is not None for x in got)


def test_batch_split_and_mesh():
    x = torch.arange(16).reshape(8, 2)
    parts = [SH.manual_batch_split(x, r, 4) for r in range(4)]
    assert torch.equal(torch.cat(parts), x) and parts[1].shape == (2, 2)
    with pytest.raises(ValueError, match="does not split"):
        SH.manual_batch_split(x, 0, 3)
    mesh = make_local_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.spec.shape, mesh.spec.axes) == (0, 1, (1,), ("data",))
    assert mesh_spec().shape == (16, 16)


# ---------------------------------------------------------------------------
# Strategies and guards
# ---------------------------------------------------------------------------
LATTICE = [  # (n_persist, n_host, n_swap, zero1, zero_stage) -> kind at tp 1
    ((4, 0, 0, False, 3), "ddp"), ((0, 0, 0, False, 3), "zero3"),
    ((2, 0, 0, False, 3), "zero3"), ((0, 0, 0, False, 2), "zero2"),
    ((0, 2, 0, False, 3), None), ((4, 0, 1, False, 3), None),
    ((0, 0, 1, False, 3), None), ((4, 0, 0, True, 3), None),
]


@pytest.mark.parametrize("cell,kind", LATTICE)
def test_make_strategy_kinds_and_guards(cell, kind):
    """A manual plan no kind lowers raises the reference's ValueError at
    every world size; one that lowers is ``ManualSync`` of its kind on 4
    ranks and ``XlaSync`` on one; the xla path on 4 ranks is the sharded
    ``XlaSync``, with a model axis too, where a manual plan lowers only as
    "ddp" under ``dp_only`` (``tests/test_torch_tp.py``)."""
    n_persist, n_host, n_swap, zero1, stage = cell
    plan = MemoryPlan(4, 2, n_persist=n_persist, n_host=n_host, n_swap=n_swap,
                      zero1_persistent=zero1, zero_stage=stage, sync_mode="manual",
                      grad_compress="int8_ef")
    jplan = JPlan(4, 2, n_persist=n_persist, n_host=n_host, n_swap=n_swap,
                  zero1_persistent=zero1, zero_stage=stage)
    assert jplan.manual_sync_kind(1) == kind
    for world in (1, 4):
        mesh = LocalMesh(0, world, None, CPU)
        if kind is None:
            with pytest.raises(ValueError, match="manual"):
                SYNC.make_strategy(plan, mesh)
            continue
        s = SYNC.make_strategy(plan, mesh)
        assert s.kind == (kind if world == 4 else "xla")
    xla = SYNC.make_strategy(MemoryPlan(4, 2, n_persist=n_persist), LocalMesh(0, 4, None, CPU))
    assert xla.kind == "xla" and xla.sharded
    tp = SYNC.make_strategy(MemoryPlan(4, 2, n_persist=n_persist), LocalMesh(0, 4, None, CPU),
                            tp_degree=2)
    assert tp.kind == "xla" and tp.sharded
    if kind is not None:
        with pytest.raises(ValueError, match="manual"):
            SYNC.make_strategy(plan, LocalMesh(0, 4, None, CPU), tp_degree=2)


JCFG = jreduced(jget_config("llama3-405b"), dtype="float32")
CFG = reduced(get_config("llama3-405b"), dtype="float32")
SHAPE = ShapeConfig("tiny", 32, 16, "train")
JSHAPE = JShape("tiny", 32, 16, "train")


def _jmesh():
    return jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


@pytest.mark.parametrize("kind,plan_kw", [("zero3", dict(n_persist=1, microbatch=2)),
                                          ("zero2", dict(n_persist=0, zero_stage=2)),
                                          ("ddp", dict(n_persist=4))])
def test_sync_inventory_equals_reference(kind, plan_kw):
    """The per-step wire-byte gauges of a one-rank manual step equal the
    reference's ``record_sync_inventory`` on a one-device mesh."""
    jplan = JPlan(4, 2, grad_compress="int8_ef", sync_mode="manual", **plan_kw)
    jart = j_build(JCFG, jplan, _jmesh(), JSHAPE)
    reg = JRegistry()
    want = JSYNC.record_sync_inventory(JSYNC.ManualSync(jplan, _jmesh(), kind),
                                       jart.state_specs["params"], jplan.microbatch, reg)
    plan = MemoryPlan(4, 2, grad_compress="int8_ef", sync_mode="manual", **plan_kw)
    mesh = make_local_mesh("cpu")
    tel = obs.Telemetry(trace=False)
    build_train_step(CFG, plan, "cpu", SHAPE, mesh=mesh, telemetry=tel,
                     strategy=SYNC.ManualSync(plan, mesh, kind))
    snap = tel.registry.snapshot()
    for op in ("grad_sync", "param_gather"):
        key = f"sync.wire_bytes_per_step{{op={op},strategy={kind}}}"
        assert snap[key]["value"] == want[op], (key, snap[key], want)
    assert want["param_gather"] > 0 or kind == "ddp"


# ---------------------------------------------------------------------------
# One rank: XlaSync's wire numerics against the JAX one-device step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compress", ["int8_ef", "bf16"])
def test_xla_sync_one_rank_matches_jax(compress):
    """Three steps of the xla path with wire compression on one device.
    Losses and grad norms at ``TOL``. The residuals agree at ``TOL``
    except where the two sides round a value to the other int8 neighbour:
    their gradients are a few ulp apart, and XLA compiles the JAX
    quantizer's division by 127 as a multiply by its reciprocal (ROADMAP.md
    queue 3 B), so about 0.5 % of the values land across a rounding edge
    after 3 steps. There they differ by at most one quantization step
    (twice the leaf's largest residual), in at most 1 % of the values; the
    residual norm agrees to 1e-3."""
    plan_kw = dict(n_persist=4, grad_compress=compress)
    art = j_build(JCFG, JPlan(4, 2, **plan_kw), _jmesh(), JSHAPE, adam=JAdam(lr=R.LR))
    jstate = art.init(jax.random.PRNGKey(0))
    init = jax.device_get(jstate)
    fn = jax.jit(art.fn)
    pipe = JPipe(JCFG, JSHAPE, seed=0)
    jlosses, jnorms = [], []
    for _ in range(3):
        jstate, m = fn(jstate, pipe.next_sync())
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    tart = build_train_step(CFG, MemoryPlan(4, 2, **plan_kw), "cpu", SHAPE,
                            adam=AdamConfig(lr=R.LR))
    assert tart.strategy.kind == "xla"
    state = tart.place_state(convert.tree_from_numpy(init["params"]))
    tpipe = SyntheticTokenPipeline(CFG, SHAPE, seed=0)
    losses, norms = [], []
    for _ in range(3):
        state, m = tart.fn(state, tpipe.next_sync())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    _close(losses, jlosses, TOL, "losses")
    _close(norms, jnorms, TOL, "grad norms")
    if compress != "int8_ef":
        assert "ef" not in state
        return
    assert float(m["ef_norm"]) > 0
    jef = tree_leaves(convert.tree_from_numpy(jax.device_get(jstate["ef"])))
    ef = tree_leaves(state["ef"])
    assert len(ef) == len(jef)
    flipped = total = 0
    for a, b in zip(ef, jef):
        a, b = a.numpy(), b.numpy()
        off = np.abs(a - b) > TOL * (1 + np.abs(b))
        assert (np.abs(a - b)[off] <= 2 * np.abs(b).max() + TOL).all()
        flipped += int(off.sum())
        total += a.size
    assert flipped <= 1e-2 * total, (flipped, total)
    assert math.isclose(float(m["ef_norm"]),
                        float(np.sqrt(sum(np.square(b.numpy().astype(np.float64)).sum()
                                          for b in jef))), rel_tol=1e-3)
