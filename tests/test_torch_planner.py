"""The port's planner against the JAX package's: hardware specs, the
superblock profiler, the cost models, the search, the baselines, the serving
planner, the prefill-chunk choice and the drift monitor, on the same inputs.

The cost models and the search are held to the reference on a **shared**
``BlockProfile`` (the reference's numbers): both packages price every plan
of a grid to a relative 1e-12 and return equal plans. The profilers are
compared on their own: matmul FLOPs exactly, the boundary exactly, traffic
and residual bytes within the bounds below (measured, with their causes).
"""
import dataclasses
import math

import pytest
import torch

from repro import configs as JC
from repro.configs.base import ShapeConfig as JShape
from repro.core import autotuner as JA
from repro.core import baselines as JB
from repro.core import cost_model as JCM
from repro.core import hardware as JH
from repro.core import profiler as JP
from repro.core import serve_plan as JSP
from repro.core.plan import MemoryPlan as JPlan
from repro.obs.drift import DriftMonitor as JDrift
from repro.serve.paging import choose_paging as j_paging
from repro_torch import configs as TC
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.core import autotuner as TA
from repro_torch.core import baselines as TB
from repro_torch.core import cost_model as TCM
from repro_torch.core import hardware as TH
from repro_torch.core import profiler as TP
from repro_torch.core import serve_plan as TSP
from repro_torch.core.plan import MemoryPlan as TPlan
from repro_torch.obs import device_memory_watermark
from repro_torch.obs.drift import DriftMonitor as TDrift
from repro_torch.serve.paging import choose_paging as t_paging

import torch_cores

torch_cores.share_cores()

RTOL = 1e-12
H100_J = JH.HardwareSpec(**dataclasses.asdict(TH.H100_SXM))  # the port's spec, as the reference's


def _hw(name: str):
    """(reference spec, port spec) of a name."""
    if name == "h100-sxm":
        return H100_J, TH.H100_SXM
    if name == "cpu-host":
        return JH.LOCAL_CPU_HW, TH.LOCAL_CPU_HW
    return JH.HARDWARE[name], TH.HARDWARE[name]


MESHES = {
    "gpu1": ((1,), ("data",)),
    "gpu4": ((4,), ("data",)),
    "dp2tp2": ((2, 2), ("data", "model")),
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def _cfgs(arch: str, red: bool):
    j, t = JC.get_config(arch), TC.get_config(arch)
    if red:
        j, t = JC.reduced(j), TC.reduced(t)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


def _pair(arch, seq, batch, mesh, hw, red=False):
    """(reference Workload, port Workload) on the reference's block profile."""
    jc, tc = _cfgs(arch, red)
    jhw, thw = _hw(hw)
    jw = JCM.build_workload(jc, JShape("t", seq, batch, "train"), JH.MeshSpec(*MESHES[mesh]), jhw)
    tw = TCM.build_workload(tc, TShape("t", seq, batch, "train"), TH.MeshSpec(*MESHES[mesh]), thw)
    assert [dataclasses.asdict(c) for c in tw.chunks] == [dataclasses.asdict(c)
                                                         for c in jw.chunks]
    assert (tw.positions, tw.max_position_param_bytes) == (jw.positions,
                                                           jw.max_position_param_bytes)
    return jw, dataclasses.replace(tw, block=TP.BlockProfile(**dataclasses.asdict(jw.block)))


def _close(a, b, path="") -> None:
    """Equal structures; floats to RTOL relative."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert math.isclose(a, b, rel_tol=RTOL, abs_tol=0.0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


# ---------------------------------------------------------------------------
# (a) hardware
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["tpu-v5e", "rtx-3090", "a100-80g", "cpu-host"])
def test_hardware_spec_equals_reference(name):
    j, t = _hw(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for nbytes in (1e9, 3.7e11):
        assert t.matmul_time(nbytes) == j.matmul_time(nbytes)
        assert t.hbm_time(nbytes) == j.hbm_time(nbytes)
    assert t.capacity_bytes() == j.capacity_bytes()


def test_capacity_constants_and_registry_equal_reference():
    assert TH.HBM_CAPACITY_FRACTION == JH.HBM_CAPACITY_FRACTION
    assert TH.SERVE_RESIDENT_HEADROOM == JH.SERVE_RESIDENT_HEADROOM
    assert {k: v for k, v in TH.HARDWARE.items() if k != "h100-sxm"} == {
        k: TH.HardwareSpec(**dataclasses.asdict(v)) for k, v in JH.HARDWARE.items()}
    assert TH.H100_SXM.peak_flops == 989e12 and TH.H100_SXM.hbm_bw == 3.35e12
    assert TH.H100_SXM.hbm_bytes == 80e9 and TH.H100_SXM.host_bw == 64e9


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_spec_equals_reference(mesh):
    j, t = JH.MeshSpec(*MESHES[mesh]), TH.MeshSpec(*MESHES[mesh])
    for attr in ("n_chips", "zero_axes", "zero_degree", "tp_degree"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for hw in ("tpu-v5e", "a100-80g"):
        jhw, thw = _hw(hw)
        assert t.gather_bw(thw) == j.gather_bw(jhw)
    assert dataclasses.asdict(TH.SINGLE_POD) == dataclasses.asdict(JH.SINGLE_POD)
    assert dataclasses.asdict(TH.MULTI_POD) == dataclasses.asdict(JH.MULTI_POD)


def test_local_cuda_hw_needs_a_card():
    with pytest.raises(ValueError, match="CUDA card"):
        TH.local_cuda_hw("cpu")
    assert device_memory_watermark("cpu") == (0, "none")


# ---------------------------------------------------------------------------
# (b) profiler
# ---------------------------------------------------------------------------
# hbm_bytes_fwd, the sum of every op's bytes in and out: the reference also
# counts its reshapes, transposes and broadcasts (each a new jaxpr value),
# which are views that move nothing in the port. Measured port / reference:
# 0.886-0.983 on the reduced configs, 0.776-0.991 at full width.
TRAFFIC = (0.75, 1.0)
# act_residual_bytes: the reference classifies a weight that a nested jaxpr
# (a position under ``jit``) feeds to a dot as an *activation* residual --
# its weight set holds only the outer variables -- while the port counts it
# as a weight. So the port's activation plus weight residuals are held to
# the reference's activation residuals: measured 0.94-1.06 with one KV block
# (S <= 1024; gpt2's GELU, whose tanh form the two write with different
# intermediates, gives the low end). The plain attention's Python loop over
# KV blocks counts its residuals once, as the reference's scan body
# (``layers.scan_iteration``): at S 4096, 4 KV blocks, measured 1.07 (2.55
# while each block's intermediates counted apart).
RESID_ONE_BLOCK = (0.9, 1.1)

PROFILE_CASES = [("mistral-7b", True, 2, 64), ("stablelm-3b", True, 2, 64),
                 ("gpt2-1b", True, 2, 64), ("llama-13b", True, 1, 128),
                 ("gpt2-1b", False, 1, 1024), ("llama-13b", False, 1, 1024)]


@pytest.mark.parametrize("arch,red,batch,seq", PROFILE_CASES)
def test_profile_matmul_flops_equal_reference(arch, red, batch, seq):
    jc, tc = _cfgs(arch, red)
    jprof = _jax_trace(jc, batch, seq)
    tprof = TP.trace_superblock(tc, batch, seq)
    jmm = sum(op.flops for op in jprof.ops if op.name == "dot_general")
    assert tprof.matmul_flops == jmm
    jb, tb = JP.profile_superblock(jc, batch, seq), TP.profile_superblock(tc, batch, seq)
    assert tb.boundary_bytes == jb.boundary_bytes
    assert TRAFFIC[0] <= tb.hbm_bytes_fwd / jb.hbm_bytes_fwd <= TRAFFIC[1]
    lo, hi = RESID_ONE_BLOCK
    resid = tprof.residual_act_bytes + tprof.residual_weight_bytes
    assert lo <= resid / jb.act_residual_bytes <= hi
    assert tb.act_residual_bytes == tprof.residual_act_bytes
    assert tb.flops_fwd == tprof.total_flops and tb.flops_bwd == 2 * tb.flops_fwd


def test_profile_full_mistral_superblock():
    """mistral-7b at B 1, S 4096: fake tensors only, so tracing costs no memory."""
    jc, tc = _cfgs("mistral-7b", False)
    tprof = TP.trace_superblock(tc, 1, 4096)
    jprof = _jax_trace(jc, 1, 4096)
    assert tprof.matmul_flops == sum(op.flops for op in jprof.ops if op.name == "dot_general")
    assert tprof.matmul_flops == 2061651410944.0
    jb, tb = JP.profile_superblock(jc, 1, 4096), TP.profile_superblock(tc, 1, 4096)
    assert tb.boundary_bytes == jb.boundary_bytes == 33554432
    assert TRAFFIC[0] <= tb.hbm_bytes_fwd / jb.hbm_bytes_fwd <= TRAFFIC[1]
    resid = tprof.residual_act_bytes + tprof.residual_weight_bytes
    lo, hi = RESID_ONE_BLOCK  # 4 KV blocks, their residuals counted once
    assert lo <= resid / jb.act_residual_bytes <= hi
    # the numbers chip_smoke.py prints beside the port's (the reference's)
    # and the card test expects (the port's)
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ref = dict(smoke.REFERENCE_BLOCK_PROFILE)
    ref.pop("peak_transient_bytes")  # miscounted by the reference on jax 0.9 (ROADMAP.md)
    got = dataclasses.asdict(jb)
    assert {k: got[k] for k in ref} == ref
    assert dataclasses.asdict(tb) == dict(
        flops_fwd=2064375300608.0, hbm_bytes_fwd=40026731584, act_residual_bytes=1317569536,
        boundary_bytes=33554432, peak_transient_bytes=1628446720)


def _jax_trace(cfg, batch, seq):
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    defs = JM.param_defs(cfg)["blocks"]
    one = jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape[1:], jnp.dtype(d.dtype)), defs,
                       is_leaf=lambda x: hasattr(x, "shape") and not hasattr(x, "aval"))
    x = jax.ShapeDtypeStruct((batch, seq, cfg.d_model), jnp.dtype(cfg.dtype))
    return JP.profile_fn(lambda p, x: JM.apply_superblock(p, x, cfg)[0], one, x,
                         weight_args=(0,))


def test_profile_counts_views_as_free_and_classifies_weights():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(4, 8, dtype=torch.bfloat16)
        w = torch.empty(8, 16, dtype=torch.bfloat16)
        prof = TP.profile_fn(lambda x, w: torch.exp((x @ w).float().reshape(64)), x, w,
                             weight_args=(1,))
    names = [op.name for op in prof.ops]
    assert "mm" in names and "exp" in names
    assert prof.matmul_flops == 2 * 4 * 8 * 16
    view = [op for op in prof.ops if op.name == "view"]
    assert view and all(op.flops == 0 and op.bytes_in == op.bytes_out == 0 for op in view)
    assert prof.residual_weight_bytes == 8 * 16 * 2
    # x (bf16) for the matmul, the widened product for exp
    assert prof.residual_act_bytes == 4 * 8 * 2 + 4 * 16 * 4


# ---------------------------------------------------------------------------
# (c) cost models on a shared profile
# ---------------------------------------------------------------------------
def _plan_grid(nc: int, nb: int, mesh_chips: int):
    mixed = tuple(("none", "checkpoint", "compress8", "compress16", "swap")[b % 5]
                  for b in range(nb))
    plans = []
    for n_persist, n_buffer, n_host in [(nc, 0, 0), (0, 0, 0), (nc // 2, 0, nc - nc // 2),
                                        (1, min(2, nc - 1), max(nc - 3, 0)), (0, nc, 0),
                                        (2, 1, 1)]:
        for acts in (None, ("checkpoint",) * nb, mixed):
            for mb in (1, 2):
                for ho, hp in ((True, True), (True, False), (False, True)):
                    plans.append(dict(n_persist=n_persist, n_buffer=n_buffer, n_host=n_host,
                                      act_policies=acts, microbatch=mb, host_optimizer=ho,
                                      host_params=hp))
    plans += [dict(n_persist=nc, n_swap=nb // 2, n_checkpoint=nb - nb // 2),
              dict(n_persist=0, n_checkpoint=nb, ckpt_group=2, seq_shard_acts=True),
              dict(n_persist=nc // 2, zero1_persistent=True, n_checkpoint=nb // 2)]
    if mesh_chips > 1:
        for stage in (2, 3):
            for overlap in (True, False):
                plans.append(dict(n_persist=nc // 3, n_buffer=2, grad_compress="int8_ef",
                                  sync_mode="manual", zero_stage=stage, overlap=overlap))
        plans += [dict(n_persist=nc, grad_compress="int8_ef", sync_mode="manual"),
                  dict(n_persist=nc // 2, grad_compress="bf16"),
                  dict(n_persist=0, dp_only=True, n_checkpoint=nb)]
    return plans


COST_CASES = [("mistral-7b", False, 4096, 1, "gpu1", "h100-sxm"),
              ("mistral-7b", True, 64, 4, "gpu4", "a100-80g"),
              ("stablelm-3b", False, 2048, 8, "dp2tp2", "tpu-v5e"),
              ("gpt2-1b", False, 1024, 8, "gpu4", "rtx-3090"),
              ("llama-13b", False, 1024, 64, "multi_pod", "tpu-v5e")]


@pytest.mark.parametrize("arch,red,seq,batch,mesh,hw", COST_CASES)
def test_cost_models_equal_reference_on_shared_profile(arch, red, seq, batch, mesh, hw):
    jw, tw = _pair(arch, seq, batch, mesh, hw, red)
    for kw in _plan_grid(jw.n_chunks, jw.n_blocks, jw.mesh.n_chips):
        jplan, tplan = JPlan(jw.n_chunks, jw.n_blocks, **kw), TPlan(tw.n_chunks, tw.n_blocks, **kw)
        _close(vars(JCM.estimate_runtime(jw, jplan)), vars(TCM.estimate_runtime(tw, tplan)),
               str(kw))
        _close(vars(JCM.estimate_memory(jw, jplan)), vars(TCM.estimate_memory(tw, tplan)),
               str(kw))
        _close(list(JCM.step_totals(jw, jplan)), list(TCM.step_totals(tw, tplan)), str(kw))


@pytest.mark.parametrize("n_chunks,n_buffer,microbatch", [(6, 0, 1), (6, 2, 2), (9, 4, 1),
                                                          (4, 4, 3)] + [
    (n, b, mb) for n in (1, 2, 8) for b in sorted({0, n // 2, n}) for mb in (1, 3)])
def test_zero3_prefetch_schedule_equals_reference(n_chunks, n_buffer, microbatch):
    for depth in (None, 1, 2):
        assert TCM.zero3_prefetch_schedule(n_chunks, n_buffer, microbatch, depth) == \
            JCM.zero3_prefetch_schedule(n_chunks, n_buffer, microbatch, depth)


def test_wire_calibration_equals_reference():
    JCM.reset_wire_calibration()
    TCM.reset_wire_calibration()
    for mode, keys in JCM.DEFAULT_WIRE_FACTORS.items():
        for key in keys:
            assert TCM.wire_factor(mode, key) == JCM.wire_factor(mode, key), (mode, key)
    assert TCM.ef_residual_factor() == JCM.ef_residual_factor()


# ---------------------------------------------------------------------------
# (d) search, act-policy search, baselines, serving planner
# ---------------------------------------------------------------------------
SEARCH_CASES = [
    ("mistral-7b", False, 4096, 1, "gpu1", "h100-sxm", dict(compress="off", sync="xla")),
    ("mistral-7b", False, 4096, 2, "gpu1", "h100-sxm", dict(compress="off", sync="xla")),
    ("mistral-7b", True, 64, 2, "gpu1", "cpu-host", dict(compress="off", sync="xla")),
    ("gpt2-1b", False, 1024, 8, "gpu4", "rtx-3090", {}),
    ("gpt2-1b", False, 1024, 64, "gpu4", "a100-80g", {}),
    ("gpt2-10b", False, 1024, 8, "gpu1", "rtx-3090", {}),
    ("llama-13b", False, 1024, 8, "gpu4", "a100-80g", {}),
    ("stablelm-3b", False, 2048, 16, "dp2tp2", "tpu-v5e", dict(sp="auto", dp="auto")),
]


def _result(res) -> dict:
    return {"plan": dataclasses.asdict(res.plan), "runtime": vars(res.runtime),
            "memory": vars(res.memory), "evaluated": res.evaluated, "feasible": res.feasible}


@pytest.mark.parametrize("arch,red,seq,batch,mesh,hw,kw", SEARCH_CASES)
def test_search_equals_reference(arch, red, seq, batch, mesh, hw, kw):
    jw, tw = _pair(arch, seq, batch, mesh, hw, red)
    jres, tres = JA.search(jw, **kw), TA.search(tw, **kw)
    _close(_result(jres), _result(tres))
    # the greedy act-policy sweep alone, from the winner's placement under a
    # tighter budget
    cap = 0.8 * jw.hw.capacity_bytes()
    base = dataclasses.replace(jres.plan, act_policies=None)
    _close(_result(JA.search_act_policies(jw, base, cap)),
           _result(TA.search_act_policies(tw, TPlan(**dataclasses.asdict(base)), cap)))
    for name in sorted(JB.BASELINES):
        assert dataclasses.asdict(TB.BASELINES[name](tw, cap)) == \
            dataclasses.asdict(JB.BASELINES[name](jw, cap)), name
    assert dataclasses.asdict(TA.megatrain_plan(tw)) == dataclasses.asdict(JA.megatrain_plan(jw))


def test_exhaustive_search_equals_reference():
    jw, tw = _pair("mistral-7b", 64, 4, "gpu1", "cpu-host", red=True)
    for cap in (2e6, 5e6, 2e7):
        _close(_result(JA.exhaustive_search(jw, cap)), _result(TA.exhaustive_search(tw, cap)))


def test_searched_plans_prefer_the_reference_ladder():
    assert TA.ACT_LADDER == JA.ACT_LADDER


SERVE_CASES = [("mistral-7b", 1024, 4, "gpu1", "h100-sxm"),
               ("mistral-7b", 32768, 64, "gpu1", "h100-sxm"),
               ("mistral-7b", 32768, 8, "gpu1", "rtx-3090"),
               ("llama-13b", 4096, 32, "gpu1", "rtx-3090"),
               ("gpt2-10b", 8192, 16, "gpu4", "a100-80g")]


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("arch,seq,batch,mesh,hw", SERVE_CASES)
def test_serve_plan_equals_reference(arch, seq, batch, mesh, hw, kernel, monkeypatch):
    """The serving planner and its memory picture, with the decode pricing
    of the plain path (the port on the CPU) and of the paged kernel."""
    jc, tc = _cfgs(arch, False)
    jhw, thw = _hw(hw)
    jm, tm = JH.MeshSpec(*MESHES[mesh]), TH.MeshSpec(*MESHES[mesh])
    js, ts = JShape("s", seq, batch, "decode"), TShape("s", seq, batch, "decode")
    monkeypatch.setattr(JCM, "decode_kernel_active", lambda: kernel)
    monkeypatch.setattr(TCM, "decode_kernel_active", lambda: kernel)
    jplan, tplan = JSP.serve_plan(jc, js, jm, jhw), TSP.serve_plan(tc, ts, tm, thw)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    _close(JSP.serve_memory_estimate(jc, js, jm, jplan),
           TSP.serve_memory_estimate(tc, ts, tm, tplan))
    assert TSP.cache_bytes_per_device(tc, ts, tm) == JSP.cache_bytes_per_device(jc, js, jm)
    jw = JCM.Workload(jc, js, jm, jhw, JCM.chunk_inventory(jc),
                      JP.BlockProfile(1e9, 1e9, 10, 10, 10))
    tw = TCM.Workload(tc, ts, tm, thw, TCM.chunk_inventory(tc),
                      TP.BlockProfile(1e9, 1e9, 10, 10, 10))
    _close(list(JCM.serve_totals(jw, jplan)), list(TCM.serve_totals(tw, tplan)))


# ---------------------------------------------------------------------------
# (e) the paper's claims through the port's planner (tests/test_paper_claims.py)
# ---------------------------------------------------------------------------
GPU1, GPU4 = TH.MeshSpec((1,), ("data",)), TH.MeshSpec((4,), ("data",))


def _throughput(cfg, batch, hw, planner):
    w = TCM.build_workload(cfg, TShape("b", 1024, batch, "train"), GPU4, hw)
    cap = hw.hbm_bytes * 0.92
    if planner == "protrain":
        res = TA.search(w, capacity_bytes=cap)
        return res.runtime.tokens_per_second if res.feasible else 0.0
    plan = TB.BASELINES[planner](w, cap)
    if TCM.estimate_memory(w, plan).peak >= cap:
        return 0.0
    return TCM.estimate_runtime(w, plan).tokens_per_second


def test_protrain_not_slower_than_baselines():
    """Fig. 3: ProTrain throughput >= each baseline (same hardware/model)."""
    for name in ("gpt2-10b", "llama-13b"):
        cfg = TC.PAPER_MODELS[name]
        pro = max(_throughput(cfg, b, TH.A100_80G, "protrain") for b in (8, 64))
        for other in ("deepspeed", "colossalai", "fsdp"):
            base = max(_throughput(cfg, b, TH.A100_80G, other) for b in (8, 64))
            assert pro >= base * 0.999, (name, other, pro, base)


def test_table4_batch_size_shrinks_persistence():
    """Table 4 rows A->B: larger batch forces fewer persistent chunks."""
    cfg = TC.PAPER_MODELS["gpt2-1b"]
    plans = {b: TA.search(TCM.build_workload(cfg, TShape("b", 1024, b, "train"), GPU4,
                                             TH.RTX_3090)).plan for b in (8, 64)}
    assert plans[64].n_persist < plans[8].n_persist


def test_table4_a100_avoids_memory_savings_for_small_model():
    """Table 4 row C: 1B model at batch 64 on A100 needs no ckpt/offload."""
    cfg = TC.PAPER_MODELS["gpt2-1b"]
    w = TCM.build_workload(cfg, TShape("b", 1024, 64, "train"), GPU4, TH.A100_80G)
    plan = TA.search(w).plan
    assert plan.n_checkpoint == 0 and plan.n_swap == 0 and plan.n_host == 0


def test_table3_large_model_requires_offload():
    """Table 3: GPT2-20B on 4xA100 is infeasible without offloading."""
    cfg = TC.PAPER_MODELS["gpt2-20b"]
    w = TCM.build_workload(cfg, TShape("b", 1024, 8, "train"), GPU4, TH.A100_80G)
    assert not TA.search(w, allow_host=False).feasible
    assert TA.search(w, allow_host=True).feasible


def test_fig5_overlap_matters():
    """Fig. 5: un-overlapping the host update costs >10% at batch >= 8."""
    cfg = TC.PAPER_MODELS["gpt2-10b"]
    w = TCM.build_workload(cfg, TShape("b", 1024, 8, "train"), GPU4, TH.RTX_3090)
    rt = TA.search(w).runtime
    t_no_overlap = rt.t_fwd + rt.t_bwd + rt.t_gpu_optim + rt.t_cpu_optim
    assert rt.t_cpu_optim > 0
    assert t_no_overlap > 1.1 * rt.t_iteration


# ---------------------------------------------------------------------------
# (f) the prefill chunk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("seq,batch,page,n_hot", [(1024, 4, 256, None), (1024, 4, 256, 2),
                                                  (4096, 8, 256, 4), (32768, 2, 256, 16)])
def test_choose_prefill_chunk_equals_reference(seq, batch, page, n_hot, kernel, monkeypatch):
    jc, tc = _cfgs("mistral-7b", False)
    js, ts = JShape("s", seq, batch, "decode"), TShape("s", seq, batch, "decode")
    cache = min(seq, jc.sliding_window or seq)
    jspec = None if n_hot is None else j_paging(cache, page, n_hot)
    tspec = None if n_hot is None else t_paging(cache, page, n_hot)
    monkeypatch.setattr(JCM, "decode_kernel_active", lambda: kernel)
    jm, tm = JH.MeshSpec((1,), ("data",)), TH.ONE_CHIP
    for max_chunk in (None, 32, page):
        want = JCM.choose_prefill_chunk(jc, js, jm, JH.LOCAL_CPU_HW, spec=jspec,
                                        max_chunk=max_chunk)
        got = TCM.choose_prefill_chunk(tc, ts, tm, TH.LOCAL_CPU_HW, spec=tspec,
                                       max_chunk=max_chunk, kernel=kernel)
        assert got == want, (max_chunk, got, want)
    for chunk in (1, 8):
        _close(JCM.t_prefill_chunk(jc, js, jm, JH.LOCAL_CPU_HW, chunk, spec=jspec),
               TCM.t_prefill_chunk(tc, ts, tm, TH.LOCAL_CPU_HW, chunk, spec=tspec,
                                   kernel=kernel))
    if jspec is not None:
        assert TCM.page_fetch_bytes_per_step(tc, ts, tm, tspec) == \
            JCM.page_fetch_bytes_per_step(jc, js, jm, jspec)
        monkeypatch.setattr(TCM, "decode_kernel_active", lambda: kernel)
        assert TCM.page_fetch_feasible(tc, ts, tm, TH.LOCAL_CPU_HW, tspec) == \
            JCM.page_fetch_feasible(jc, js, jm, JH.LOCAL_CPU_HW, jspec)


def test_decode_kernel_active_follows_the_default_device():
    assert TCM.decode_kernel_active() == torch.cuda.is_available()


# ---------------------------------------------------------------------------
# (g) the drift monitor
# ---------------------------------------------------------------------------
def test_drift_monitor_report_equals_reference(tmp_path):
    jw, tw = _pair("mistral-7b", 4096, 1, "gpu1", "h100-sxm")
    kw = dict(n_persist=18, n_host=16, n_checkpoint=20)
    jmon = JDrift(jw, JPlan(jw.n_chunks, jw.n_blocks, **kw), window=3, band=2.0)
    tmon = TDrift(tw, TPlan(tw.n_chunks, tw.n_blocks, **kw), window=3, band=2.0)
    assert jmon.report() == tmon.report() or _close(jmon.report(), tmon.report()) is None
    for wall, mem in ((5.0, 70e9), (2.5, None), (2.0, 71e9), (2.25, 69e9)):
        for mon in (jmon, tmon):
            mon.observe_step(wall, None if mem is None else int(mem), mem_source="max")
        _close(jmon.report(), tmon.report())
    assert tmon.measured_step_s == 2.25 and tmon.ok == jmon.ok
    path = tmon.write(str(tmp_path / "drift_report.json"))
    assert path.endswith("drift_report.json")
