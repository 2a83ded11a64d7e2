"""The multi-pod mesh: the port's ``(pod, data, model)`` layout against the
reference's, and steps over the pod axis at 4 gloo ranks against the JAX
package's one-device programs.

The layout: for every rank of the production meshes (2, 16, 16) and (16,
16), ``LocalMesh.coords`` is its index in ``numpy.arange(n).reshape(shape)``
(the row-major order of ``jax.make_mesh``), and its zero group -- the
ranks ``data_group`` spans, ``LocalMesh.zero_ranks`` -- is the set the
reference's ``zero_axes`` (every axis but ``model``,
``repro.dist.sharding.zero_axes``) pick from that array, in its order;
``LocalMesh.spec`` is ``MULTI_POD`` / ``SINGLE_POD``.

At 4 gloo ranks (``torch_dist_ranks.pod_steps``, spawned once for the
module; the JAX references run while they train): reduced ``llama3-405b``
and the reduced MoE, fp32, at (pod 2, data 2, model 1) and (pod 2, data 1,
model 2), three steps of the ZeRO plan of ``tests/test_torch_tp.py``
against the JAX one-device step of the same plan: losses, grad norms and
fp32 masters at ``TOL = 1e-4`` (``tests/test_torch_dist_xla.py``'s); one
decode of reduced ``mistral-7b`` at (2, 1, 2), its logits at each of 8
teacher-forced steps against the JAX one-device decode at ``TOL``. The
ranks' real zero groups are the layout's, and the collectives rank 0
issues in one step at (2, 1, 2) equal, op for op, those the dry-run's
fake step records at rank 0 of a fake world of 4 (``launch/dryrun.py``).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.core.hardware import MULTI_POD as J_MULTI_POD
from repro.core.hardware import SINGLE_POD as J_SINGLE_POD
from repro.dist import sharding as JSH
from repro.models import model as JM
from repro_torch.core.hardware import H100_SXM, MULTI_POD, SINGLE_POD, MeshSpec
from repro_torch.dist import sharding as SH
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import AXES_3D, LocalMesh, make_production_mesh
from repro_torch.models import convert

import torch_dist_ranks as R
from test_torch_dist_xla import TOL, _close, _masters_close
from test_torch_serve_mesh import _jax_decode, _jcfg
from test_torch_tp import _jax_ref, _jax_step

import torch_cores

torch_cores.share_cores()

CPU = torch.device("cpu")
REFS = sorted({f"{m}_{p}" for m, p, _, _ in R.POD_CASES.values()})
DECODE_MODELS = sorted({m for m, _, _ in R.POD_DECODE_CASES.values()})


def _reference_zero_ranks(shape: tuple, rank: int) -> list[int]:
    """The ranks of ``rank``'s group over the reference's zero axes
    (``repro.dist.sharding.zero_axes``) in ``numpy.arange(n).reshape(shape)``:
    those that share its other coordinates, in row-major order."""
    names = ("pod", "data", "model")[-len(shape):]
    zero = JSH.zero_axes(types.SimpleNamespace(axis_names=names))
    devs = np.arange(int(np.prod(shape))).reshape(shape)
    at = np.argwhere(devs == rank)[0]
    index = tuple(slice(None) if a in zero else int(i) for a, i in zip(names, at))
    return devs[index].ravel().tolist()


@pytest.mark.parametrize("shape,spec", [((2, 16, 16), MULTI_POD), ((16, 16), SINGLE_POD)])
def test_every_rank_sits_where_the_reference_puts_it(shape, spec):
    n = int(np.prod(shape))
    devs = np.arange(n).reshape(shape)
    pod = shape[0] if len(shape) == 3 else 1
    for rank in range(n):
        mesh = LocalMesh(rank, n, None, CPU, model=shape[-1], pod=pod)
        assert mesh.coords == tuple(int(i) for i in np.argwhere(devs == rank)[0])
        assert list(mesh.zero_ranks) == _reference_zero_ranks(shape, rank)
        assert mesh.data == n // shape[-1] and mesh.data_rank == mesh.zero_ranks.index(rank)
        assert mesh.spec == spec
        assert SH.batch_axes(mesh) == (("pod", "data") if pod > 1 else ("data",))
        assert SH.batch_axes(mesh, dp_only=True)[-1] == "model"
    assert (MULTI_POD.shape, MULTI_POD.axes) == (J_MULTI_POD.shape, J_MULTI_POD.axes)
    assert (SINGLE_POD.shape, SINGLE_POD.axes) == (J_SINGLE_POD.shape, J_SINGLE_POD.axes)


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True, device=CPU)
    with D.fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device=CPU)
        assert (mesh.world, mesh.pod, mesh.data, mesh.model) == (512, 2, 32, 16)
        # the ZeRO gathers cross the pods: priced on the pods' network
        assert mesh.spec == MULTI_POD
        assert mesh.spec.gather_bw(H100_SXM) == H100_SXM.dcn_bw * H100_SXM.coll_efficiency
        assert torch.distributed.get_process_group_ranks(mesh.data_group) == list(
            mesh.zero_ranks)
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The 4 ranks, started first, and the JAX references computed while
    they run: (JAX results, ranks' results)."""
    d = str(tmp_path_factory.mktemp("pod"))
    steps = {r: _jax_step(r) for r in REFS}
    jparams = {m: jax.device_get(JM.init_params(_jcfg(m), jax.random.PRNGKey(0)))
               for m in DECODE_MODELS}
    path = f"{d}/params.pt"
    torch.save({"train": {r: convert.tree_from_numpy(jax.device_get(st[2]["params"]))
                          for r, st in steps.items()},
                "serve": {m: convert.tree_from_numpy(p) for m, p in jparams.items()}}, path)
    wait = R.start_ranks("pod_steps", d, path)
    ref = {"train": {r: _jax_ref(*steps.pop(r)) for r in REFS},
           "decode": {m: _jax_decode(m, jparams[m]) for m in DECODE_MODELS}}
    return ref, wait()


@pytest.fixture(scope="module")
def jax_ref(both):
    return both[0]


@pytest.fixture(scope="module")
def ranks(both):
    return both[1]


@pytest.mark.parametrize("layout", R.POD_LAYOUTS)
def test_ranks_zero_groups_are_the_layouts(ranks, layout):
    """Each rank's coordinates, its real zero group (``data_group``) and its
    place along the batch axes, against the reference's layout of 4
    devices."""
    for rank, r in enumerate(ranks):
        got = r["mesh"][layout]
        devs = np.arange(4).reshape(layout)
        assert got["coords"] == tuple(int(i) for i in np.argwhere(devs == rank)[0])
        zero = _reference_zero_ranks(layout, rank)
        assert list(got["zero_ranks"]) == zero == got["zero_group"]
        assert got["spec"] == (layout, AXES_3D)
        assert got["batch"] == (zero.index(rank), len(zero))
        assert got["batch_axes"] == ("pod", "data")


@pytest.mark.parametrize("case", sorted(R.POD_CASES))
def test_pod_steps_hold_jax(ranks, jax_ref, case):
    """3 steps on the case's (pod, data, model) layout against the JAX
    one-device step of its model and plan: losses, grad norms and the fp32
    masters made whole, at ``TOL``; every rank agrees bitwise."""
    model, plan, _, _ = R.POD_CASES[case]
    runs = [r["train"][case] for r in ranks]
    ref = jax_ref["train"][f"{model}_{plan}"]
    run = runs[0]
    assert all(r["kind"] == "xla" for r in runs)
    _close(run["losses"], ref["losses"], TOL, "losses")
    _close(run["norms"], ref["norms"], TOL, "grad norms")
    _masters_close(run["master"], ref["master"], TOL, case)
    for r in runs[1:]:
        assert r["losses"] == run["losses"] and r["norms"] == run["norms"]
        for a, b in zip(r["master"], run["master"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", sorted(R.POD_DECODE_CASES))
def test_pod_decode_logits_hold_jax(ranks, jax_ref, case):
    """Each teacher-forced step's logits, made whole over the vocab and the
    slots, against the JAX one-device decode at ``TOL``; every rank's
    equal."""
    model = R.POD_DECODE_CASES[case][0]
    got = ranks[0]["decode"][case]["logits"]
    _close(got, jax_ref["decode"][model], TOL, case)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["decode"][case]["logits"], got)


def test_recorded_collectives_equal_the_fake_steps(ranks):
    """The collectives of one step at (2, 1, 2), recorded at rank 0 of the 4
    gloo ranks, equal those the dry-run's fake step records at rank 0 of a
    fake world of 4 on the same reduced cell, op for op."""
    model, plan, layout, _ = R.POD_CASES[R.POD_RECORD_CASE]
    cfg, shape = R.tp_config(model)
    built = D.fake_step(cfg, shape, R.tp_plan(R.POD_RECORD_CASE), MeshSpec(layout, AXES_3D),
                        CPU)
    fake = [(o.kind, o.nbytes, o.dtype, o.group_size) for o in built["collectives"]]
    real = ranks[0]["recorded"]
    assert len(real) > 10 and {k for k, *_ in real} >= {"all-gather", "all-reduce",
                                                         "reduce-scatter"}
    assert fake == real
    assert not torch.distributed.is_initialized()
