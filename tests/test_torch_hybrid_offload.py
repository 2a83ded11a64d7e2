"""Two training steps of reduced ``jamba-1.5-large-398b`` (one 8-layer
period: 3 chunks, 1 block) against the JAX step, fp32, under the plans that
use host memory: ``swap`` (the block's save sites copied out and back) and
host-resident weights (the block and the head, fetched again for the
backward). Tolerances are ``tests/test_torch_mamba.py``'s (``train_case``).
"""
import pytest
from test_torch_mamba import train_case

import torch_cores

torch_cores.share_cores()

ARCH = "jamba-1.5-large-398b"
PLANS = {  # name: plan keywords for 3 chunks and 1 block
    "swap": dict(n_persist=3, n_swap=1),
    "host_weights": dict(n_persist=1, n_host=2, host_params=True),
}


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_hybrid_offload_steps_match_jax(plan_name):
    train_case(ARCH, 3, 1, PLANS[plan_name], False, plan_name)
