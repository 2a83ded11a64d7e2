"""The dry-run's plans against the reference's, cell by cell.

For every serving cell of both production meshes (46: ``prefill_32k``,
``decode_32k`` and ``long_500k``) and for the ``train_4k`` cells of
``mamba2-130m``, ``qwen2-moe-a2.7b``, ``seamless-m4t-large-v2`` and the
Jamba hybrid on both meshes, ``launch.dryrun.plan_cell`` priced on
``TPU_V5E`` gives the reference's plan string and ``modeled`` dict and its
analytic FLOPs and bytes a chip on the reference's block profile
(``tests/torch_dryrun_cells.py``, to 1e-9).
The other six training searches take 6-25 s each on the reference alone;
``tests/test_torch_planner.py`` holds the search itself.
"""
import pytest

import torch_cores
import torch_dryrun_cells as C

torch_cores.share_cores()

SERVING = C.serving_cells(("prefill", "decode"))
TRAIN = [(a, "train_4k", mp) for a in C.TRAIN_ARCHS for mp in (False, True)]


@pytest.mark.parametrize("cell", SERVING, ids=C.cell_id)
def test_serving_plan_equals_the_reference(cell, monkeypatch):
    C.check_plan(cell, monkeypatch)


@pytest.mark.parametrize("cell", TRAIN, ids=C.cell_id)
def test_training_plan_equals_the_reference(cell, monkeypatch):
    C.check_plan(cell, monkeypatch)


def test_the_cells_are_the_reference_sweeps():
    """33 cells a mesh, as ``tests/test_system.py`` counts the reference's:
    10 train, 10 prefill, 13 decode (``long_500k`` for the subquadratic)."""
    assert len(SERVING) == 46 and len(TRAIN) == 8
    assert sum(s == "long_500k" for _, s, _ in SERVING) == 6
