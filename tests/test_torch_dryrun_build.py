"""The dry-run's whole cell, built: ``launch.dryrun.run_cell`` on the plain
route (fake CPU tensors) for every ``decode_32k`` cell of the single-pod
mesh, priced on ``TPU_V5E``: the reference's plan, an ``ok`` record whose
step ran for rank 0 of 256 (argument and live bytes, collectives, counted
FLOPs) and the reference's analytic totals (``tests/torch_dryrun_cells.py``).
The builds of all 66 cells on both meshes are the CLI's
(``python -m repro_torch.launch.dryrun --all --mesh both``; PERF.md) and
``chip_smoke.py``'s ``dryrun`` phase on the kernel route; a fake build on
the plain route takes 3-150 s a cell here, most of it ``FakeTensorMode``'s
dispatch.
"""
import pytest

import torch_cores
import torch_dryrun_cells as C

torch_cores.share_cores()

DECODE = [c for c in C.serving_cells(("decode",)) if c[1] == "decode_32k" and not c[2]]


@pytest.mark.parametrize("cell", DECODE, ids=C.cell_id)
def test_decode_cell_builds_on_the_single_pod_mesh(cell):
    C.check_build(cell)
