"""The dry-run's cells against the reference's planning (helpers of
``tests/test_torch_dryrun_plans.py`` and ``test_torch_dryrun_build.py``).

``check_plan`` runs ``repro_torch.launch.dryrun.plan_cell`` -- the
planning half of ``run_cell`` -- priced on ``TPU_V5E``, and holds its
``plan`` string and ``modeled`` dict to what the reference's
``src/repro/launch/dryrun.py::run_cell`` plans for the same cell
(``search`` for training; ``serve_plan`` and ``serve_memory_estimate``
for serving) and its analytic FLOPs and bytes a chip to the reference's
formulas (``step_totals``, ``serve_totals``, the decode formula of
``dryrun.py:101-112``), to ``RTOL``, on the reference's block profile
(``shared_profile``), as ``tests/test_torch_planner.py`` holds the
search: the two profilers count the non-matmul ops apart (ROADMAP.md
queue 3 B), which moves a prefill's bytes a chip by up to 9 % and the
modeled step times. ``check_build`` runs the whole
``run_cell`` on the plain route (``device="cpu"``: fake CPU tensors):
the same plan, and a record whose step was built and run.
"""
import dataclasses
import functools

import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro.configs import shapes_for as jshapes_for
from repro.configs.archs import ARCHS as JARCHS
from repro.core import build_workload as jbuild_workload
from repro.core import search as jsearch
from repro.core.chunks import chunk_inventory as jchunk_inventory
from repro.core.cost_model import serve_totals as jserve_totals
from repro.core.cost_model import step_totals as jstep_totals
from repro.core.hardware import MULTI_POD as J_MULTI_POD
from repro.core.hardware import SINGLE_POD as J_SINGLE_POD
from repro.core.hardware import TPU_V5E as J_TPU_V5E
from repro.core.profiler import profile_superblock as jprofile_superblock
from repro.core.serve_plan import cache_bytes_per_device as jcache_bytes
from repro.core.serve_plan import serve_memory_estimate as jserve_memory_estimate
from repro.core.serve_plan import serve_plan as jserve_plan
from repro_torch.core import cost_model as TCM
from repro_torch.core.hardware import TPU_V5E
from repro_torch.core.profiler import BlockProfile
from repro_torch.launch import dryrun as D

RTOL = 1e-9
# the training cells held here; the others' searches are tests/test_torch_planner.py's
TRAIN_ARCHS = ("mamba2-130m", "qwen2-moe-a2.7b", "seamless-m4t-large-v2",
               "jamba-1.5-large-398b")


def serving_cells(modes: tuple[str, ...]) -> list[tuple[str, str, bool]]:
    """(arch, shape, multi_pod) of every cell of these serving modes, both
    meshes."""
    return [(a, s.name, mp) for a in sorted(JARCHS) for s in jshapes_for(jget_config(a))
            if s.mode in modes for mp in (False, True)]


def cell_id(cell) -> str:
    arch, shape, mp = cell
    return f"{arch}-{shape}-{'multi' if mp else 'single'}"


@functools.lru_cache(maxsize=None)
def _reference_profile(arch: str, seq: int):
    return jprofile_superblock(jget_config(arch), 1, seq)


def shared_profile(monkeypatch) -> None:
    """The port's workloads on the reference's block profile."""
    monkeypatch.setattr(TCM, "profile_superblock", lambda cfg, batch, seq: BlockProfile(
        **dataclasses.asdict(_reference_profile(cfg.name, seq))))


def reference(arch: str, shape_name: str, multi_pod: bool) -> dict:
    """The reference's plan string, modeled dict and analytic totals a chip."""
    cfg, shape = jget_config(arch), jget_shape(shape_name)
    mspec = J_MULTI_POD if multi_pod else J_SINGLE_POD
    if shape.is_training:
        w = jbuild_workload(cfg, shape, mspec, J_TPU_V5E)
        res = jsearch(w, sp="off")
        plan = res.plan
        desc = plan.describe() + (" dp" if plan.dp_only else "") + (
            " sp" if plan.seq_shard_acts else "")
        modeled = {"t_iteration_s": res.runtime.t_iteration,
                   "tokens_per_s": res.runtime.tokens_per_second,
                   "peak_gb_per_chip": res.memory.peak / 1e9}
        flops, nbytes = jstep_totals(w, plan)
    else:
        plan = jserve_plan(cfg, shape, mspec, J_TPU_V5E)
        desc = plan.describe()
        modeled = jserve_memory_estimate(cfg, shape, mspec, plan)
        if shape.mode == "prefill":
            flops, nbytes = jserve_totals(jbuild_workload(cfg, shape, mspec, J_TPU_V5E), plan)
        else:
            b_loc = shape.global_batch / mspec.zero_degree
            flops = 2.0 * cfg.active_param_count() * b_loc / mspec.tp_degree
            nbytes = (sum(c.param_bytes for c in jchunk_inventory(cfg)) / mspec.tp_degree
                      + jcache_bytes(cfg, shape, mspec))
    return {"plan": desc, "modeled": modeled, "flops": flops, "nbytes": nbytes}


def check_plan(cell, monkeypatch) -> None:
    shared_profile(monkeypatch)
    arch, shape, mp = cell
    want = reference(arch, shape, mp)
    got = D.plan_cell(arch, shape, mp, target_hw=TPU_V5E)
    rec = got.record
    assert rec["plan"] == want["plan"]
    assert rec["modeled"].keys() == want["modeled"].keys()
    for key, value in want["modeled"].items():
        assert rec["modeled"][key] == pytest.approx(value, rel=RTOL, abs=1e-12), key
    assert got.flops_per_chip == pytest.approx(want["flops"], rel=RTOL)
    assert got.hbm_bytes_per_chip == pytest.approx(want["nbytes"], rel=RTOL)


def check_build(cell) -> dict:
    arch, shape, mp = cell
    want = reference(arch, shape, mp)
    rec = D.run_cell(arch, shape, mp, device="cpu", target_hw=TPU_V5E)
    assert rec["ok"] and rec["route"] == "plain" and rec["target_hw"] == TPU_V5E.name
    assert rec["plan"] == want["plan"]
    rl = rec["roofline"]
    assert rl["flops_per_chip"] == pytest.approx(want["flops"], rel=RTOL)
    assert rl["hbm_gb_per_chip"] == pytest.approx(want["nbytes"] / 1e9, rel=RTOL)
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    assert rl["counted_flops"] > 0 and rl["collective_gb_raw"] > 0
    mem = rec["memory"]
    assert mem["argument_gb"] > 0 and mem["temp_gb"] > 0 and rec["n_collectives"] > 0
    assert rec["peak_gb"] == mem["argument_gb"] + mem["temp_gb"]
    return rec
