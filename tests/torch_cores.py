"""The CPU's cores shared among pytest-xdist's workers.

Under ``pytest -n N`` each worker process runs its test files with
PyTorch's default intra-op pool, one thread a core: N workers then run N
times as many threads as the machine has cores, and the port's many small
ops spend their time waiting on each other's threads (6 parallel runs of
``test_torch_moe.py`` on an 8-core host took 4.7 times as long as with a
thread a run).
``share_cores`` gives each worker its share, as ``launch.train --nproc``
gives each rank its share; outside xdist it changes nothing. Every worker
imports every test module at collection, so the first port test module
imported sets it for the worker's whole run.
"""
from __future__ import annotations

import os

import torch


def share_cores() -> None:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
