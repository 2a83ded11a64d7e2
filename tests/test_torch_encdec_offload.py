"""Reduced ``seamless-m4t-large-v2``'s training steps against the JAX step
under the plans that move activations or weights: compress8 at every
layer, and a plan whose front chunk (the embedding and the encoder) and
every other chunk are ``host`` with ``host_params`` (weights fetched, the
first block swapped and fetched again for its replay). The helper and
the tolerances are ``test_torch_encdec_train.py``'s; the split keeps each
file near a minute on one worker.
"""
import pytest

from test_torch_encdec_train import check_steps_match_jax

import torch_cores

torch_cores.share_cores()


@pytest.mark.parametrize("plan_name", ["compress8", "front_chunk_host"])
def test_seamless_offload_steps_match_jax(plan_name):
    check_steps_match_jax(plan_name)
