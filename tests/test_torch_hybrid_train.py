"""Two training steps of reduced ``jamba-1.5-large-398b`` (one 8-layer
period: 3 chunks, 1 block) against the JAX step, fp32, with the device's
act policies: ``none``, ``checkpoint`` with 2 microbatches and
``compress8``. Tolerances are ``tests/test_torch_mamba.py``'s
(``train_case``), except for the ``compress8`` plan: its 24 int8 sites
(three a layer) flip where the two frameworks' fp32 noise crosses a
rounding step, and the four MoE layers' routing follows them, so after the
first step its loss and gradient norm are held within ``5e-3 * (1 +
|jax|)`` (measured 2.2e-3 on the gradient norm) and each leaf's update
within 0.2 in relative L2 (measured at most 0.1025; 4-8 % on most leaves),
where the 2-layer Mamba-2 case holds 0.1. The host-memory plans are in
``tests/test_torch_hybrid_offload.py``.
"""
import pytest
from test_torch_mamba import train_case

import torch_cores

torch_cores.share_cores()

ARCH = "jamba-1.5-large-398b"
PLANS = {  # name: (plan keywords for 3 chunks and 1 block, quantizes)
    "none": (dict(n_persist=3), False),
    "checkpoint_2mb": (dict(n_persist=3, n_checkpoint=1, microbatch=2), False),
    "compress8": (dict(n_persist=3, act_policies=("compress8",)), True),
}


@pytest.mark.parametrize("plan_name", sorted(PLANS))
def test_hybrid_train_steps_match_jax(plan_name):
    plan_kw, quantizes = PLANS[plan_name]
    train_case(ARCH, 3, 1, plan_kw, quantizes, plan_name, later_tol=5e-3,
               update_tol=0.2 if quantizes else None)
