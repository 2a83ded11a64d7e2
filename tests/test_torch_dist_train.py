"""The port's manual gradient sync at 4 gloo ranks against the JAX
package's one-device xla step over the global batch: the ``ddp``, ``zero2``
and ``zero3`` kinds, the ZeRO-3 buffering and overlap schedule, a 4-rank
checkpoint, and ``launch.train --nproc 4``.

Reduced ``llama3-405b`` in fp32 at ``ShapeConfig("tiny", 32, 16,
"train")`` (``tests/test_manual_sync.py:27-28``), its parameters carried
from the JAX step's init by ``repro_torch.models.convert``. The 4 ranks
(``torch_dist_ranks.train_steps``) are spawned once for the module. The
manual path quantizes each rank's gradient before the reduction, the xla
path after it, so under int8_ef the two are held at the reference's own
bound for manual against xla, ``rtol=2e-2`` (``tests/test_manual_sync.py:
70-88``); without compression they compute the same mean, held at
``tests/test_torch_train.py``'s ``1e-4`` on losses, norms and fp32 masters
(see ``test_manual_uncompressed_steps_match_jax`` for Adam's exception).
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.configs.base import ShapeConfig as JShape
from repro.core.plan import MemoryPlan as JPlan
from repro.data.pipeline import SyntheticTokenPipeline as JPipe
from repro.optim.adam import AdamConfig as JAdam
from repro.train.step_builder import build_train_step as j_build
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.launch import train as launch_train
from repro_torch.models import convert

import torch_dist_ranks as R

import torch_cores

torch_cores.share_cores()

TOL = 1e-4
RTOL_INT8 = 2e-2
MASTER_ABS = 1e-3
KINDS = ("ddp", "zero2", "zero3")
JCFG = jreduced(jget_config("llama3-405b"), dtype="float32")
JSHAPE = JShape("tiny", 32, 16, "train")


def _close(out, ref, tol, what=""):
    a, b = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    excess = (np.abs(a - b) - tol * (1.0 + np.abs(b))).max()
    assert excess <= 0.0, f"{what}: max |diff| {np.abs(a - b).max()} beyond {tol}"


def _jax_steps(compress: str):
    """The JAX one-device xla step (every chunk persistent) over the global
    batch: its init, per-step losses and norms, fp32 masters after 3 and 5
    steps."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    art = j_build(JCFG, JPlan(4, 2, n_persist=4, grad_compress=compress), mesh, JSHAPE,
                  adam=JAdam(lr=R.LR))
    state = art.init(jax.random.PRNGKey(0))
    init = jax.device_get(state["params"])
    fn = jax.jit(art.fn)
    pipe = JPipe(JCFG, JSHAPE, seed=0)
    losses, norms = [], []
    for _ in range(R.STEPS):
        state, m = fn(state, pipe.next_sync())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if len(losses) == 3:
            master3 = [np.asarray(x) for x in jax.tree.leaves(
                jax.device_get(state["opt"]["master"]))]
    return {"init": init, "losses": losses, "norms": norms, "master3": master3,
            "master": [np.asarray(x) for x in jax.tree.leaves(
                jax.device_get(state["opt"]["master"]))]}


@pytest.fixture(scope="module")
def jax_ref():
    return {c: _jax_steps(c) for c in ("int8_ef", "none")}


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist_train"))
    init = jax_ref["none"]["init"]
    assert len(init["runs"]) == 1  # every chunk persistent: one run of both layers
    params = {k: v for k, v in init.items() if k != "runs"}
    params["blocks"] = init["runs"][0]
    path = os.path.join(d, "params.pt")
    torch.save(convert.tree_from_numpy(params), path)
    return R.spawn_ranks("train_steps", d, path)


@pytest.mark.parametrize("kind", KINDS)
def test_manual_int8_ef_steps_hold_jax(ranks, jax_ref, kind):
    """5 steps of int8_ef at 4 ranks against the JAX xla int8_ef step:
    losses at ``rtol=2e-2``; the residual norm above 0 every step; the
    replicated leaves' residuals ``(1, *shape)`` and different between
    ranks; a sharded leaf's residual shard-sized."""
    runs = [r[f"{kind}_int8_ef"] for r in ranks]
    assert all(r["kind"] == kind for r in runs)
    np.testing.assert_allclose(runs[0]["losses"], jax_ref["int8_ef"]["losses"], rtol=RTOL_INT8)
    assert all(np.isfinite(runs[0]["losses"])) and min(runs[0]["ef_norms"]) > 0
    for r in runs[1:]:
        assert r["losses"] == runs[0]["losses"] and r["ef_norms"] == runs[0]["ef_norms"]
    dims = runs[0]["dims"]
    assert (kind == "ddp") == all(d is None for d in dims)
    differ = 0
    for i, d in enumerate(dims):
        local = runs[0]["params"][i].shape
        if d is None:
            assert runs[0]["ef"][i].shape == (1,) + local
            differ += any(not np.array_equal(r["ef"][i], runs[0]["ef"][i]) for r in runs[1:])
        else:
            assert runs[0]["ef"][i].shape == local
            assert local[d] * R.WORLD == runs[0]["master"][i].shape[d]
    assert differ > 0


@pytest.mark.parametrize("kind", KINDS)
def test_manual_uncompressed_steps_match_jax(ranks, jax_ref, kind):
    """Without compression the manual mean is the global batch's gradient:
    losses and grad norms at ``TOL`` over 5 steps, and the fp32 masters
    (made whole from the shards) after 3 and after 5 steps at ``TOL``,
    with one exception Adam makes: where a summed gradient lies within a
    few ulp of ``eps`` (1e-8), ``m / (sqrt(v) + eps)`` turns on those
    ulps, which the ranks' and the one device's sums order differently.
    At most ``1e-5`` of the masters (2 and 3 of 459,392 here) may differ
    beyond ``TOL``, by at most ``MASTER_ABS``. Every rank holds the same
    masters bitwise."""
    run = ranks[0][f"{kind}_none"]
    ref = jax_ref["none"]
    _close(run["losses"], ref["losses"], TOL, "losses")
    _close(run["norms"], ref["norms"], TOL, "grad norms")
    for key in ("master3", "master"):
        assert len(run[key]) == len(ref[key])
        off = total = 0
        for a, b in zip(run[key], ref[key]):
            diff = np.abs(a - b)
            assert diff.max() <= MASTER_ABS, (key, diff.max())
            off += int((diff > TOL * (1 + np.abs(b))).sum())
            total += a.size
        assert off <= 1e-5 * total, (key, off, total)
    for r in ranks[1:]:
        for a, b in zip(r[f"{kind}_none"]["master"], run["master"]):
            np.testing.assert_array_equal(a, b)


GATHERS = {  # per run label: gathers a microbatch (7 sharded leaves a layer, 2 layers)
    "buffered": {"runs[0]": 14, "embed": 1, "head": 1},
    "unbuffered": {"runs[0]": 28, "embed": 1, "head": 1},
    "unbuffered_ckpt": {"runs[0]": 28, "embed": 1, "head": 1},
}


def _gathers(run) -> tuple[dict, dict]:
    """(gathers by chunk, gathers started ahead by chunk) of one run."""
    total, ahead = {}, {}
    for key, n in run["gathers"].items():
        labels = dict(kv.split("=") for kv in key[key.index("{") + 1:-1].split(","))
        total[labels["chunk"]] = total.get(labels["chunk"], 0) + n
        if labels["ahead"] == "True":
            ahead[labels["chunk"]] = ahead.get(labels["chunk"], 0) + n
    return total, ahead


@pytest.mark.parametrize("name", sorted(GATHERS))
def test_zero3_gathers_counted_at_the_collective(ranks, name):
    """Buffered chunks gather once a microbatch, unbuffered ones twice (the
    backward gathers them again: kept activations' saved weights, or the
    checkpointed replay); the embedding and head once. Under overlap a
    buffered run's second layer is gathered one layer ahead."""
    for overlap in (True, False):
        total, ahead = _gathers(ranks[0][f"zero3_{name}_overlap_{overlap}"])
        assert total == {k: 4 * v for k, v in GATHERS[name].items()}, total  # 2 steps x 2
        want_ahead = {"runs[0]": 4 * 7} if overlap and name == "buffered" else {}
        assert ahead == want_ahead, ahead


@pytest.mark.parametrize("name", sorted(GATHERS))
def test_zero3_overlap_on_and_off_bitwise(ranks, name):
    """The overlapped schedule (gathers ahead, each microbatch's fold after
    the next backward, the replicated leaves' syncs started async) changes
    no bit: losses, params and residuals of every rank."""
    for r in ranks:
        on, off = r[f"zero3_{name}_overlap_True"], r[f"zero3_{name}_overlap_False"]
        assert on["losses"] == off["losses"] and on["norms"] == off["norms"]
        for a, b in zip(on["params"] + on["ef"], off["params"] + off["ef"]):
            np.testing.assert_array_equal(a, b)


def test_zero3_checkpoint_restores_bitwise_and_resumes(ranks):
    """Each rank saves its shards, optimizer states and residuals; restored
    into a fresh state they are bitwise the saved ones, and training on
    from step 2 gives the uninterrupted run's losses and state bitwise. A
    manager at another world size refuses the checkpoint."""
    for r in ranks:
        ck = r["checkpoint"]
        assert ck["saved"] == [2] and ck["resumed_from"] == 2
        assert ck["restored_equal"] and ck["state_equal"] and ck["ef_leaves"] > 0
        assert ck["losses"] == ck["straight_losses"]
        assert "world size [4]" in ck["other_world_error"]


def test_checkpoint_ranks_resume_from_the_same_complete_step(tmp_path):
    """A crash between two ranks' saves of step 2 (rank 1's file missing):
    both ranks resume from step 1, the newest step every rank saved, and
    rank 0's clean-up keeps step 1 while it is the only complete one."""
    mgrs = [CheckpointManager(str(tmp_path), keep=1, rank=r, world=2) for r in range(2)]
    for step in (1, 2):
        for r, mgr in enumerate(mgrs):
            mgr.save(step, {"w": torch.full((3,), float(10 * step + r))}, sync=True)
    os.remove(tmp_path / "step_2" / mgrs[1].state_file)
    mgrs[0].save(3, {"w": torch.zeros(3)}, sync=True)  # step 3: rank 0's file only
    assert os.path.isdir(tmp_path / "step_1")
    for r, mgr in enumerate(mgrs):
        assert mgr.steps() == [1]
        step, state, _ = mgr.restore_latest({"w": torch.empty(3)})
        assert step == 1 and torch.equal(state["w"], torch.full((3,), 10.0 + r))
    mgrs[1].save(3, {"w": torch.ones(3)}, sync=True)
    mgrs[0].save(4, {"w": torch.zeros(3)}, sync=True)  # gc: step 3 is now complete
    assert mgrs[0].steps() == [3] and sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]


def test_launcher_nproc_prints_one_json_line(capsys):
    rc = launch_train.main(["--arch", "llama3-405b", "--reduced", "--nproc", "4", "--steps",
                            "2", "--batch", "16", "--seq", "32", "--device", "cpu",
                            "--plan", "zero3"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-1])
    assert sum(line.startswith("{") for line in lines) == 1
    assert summary["world"] == 4 and summary["strategy"] == "zero3"
    assert summary["steps"] == 2 and np.isfinite(summary["final_loss"])
