"""Carry parameter and cache trees between the JAX package and the port.

Trees cross as numpy arrays, key for key. bf16 (numpy's ``bfloat16`` from
ml_dtypes, recognised by its dtype name) passes through an ``int16`` view,
which keeps every bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def tree_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays (e.g. ``jax.device_get`` of a JAX param or
    cache tree) -> the same nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return _leaf_from_numpy(tree, device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # np.dtype("bfloat16") exists once ml_dtypes is loaded (jax loads it)
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def tree_to_numpy(tree):
    """The inverse of ``tree_from_numpy``, for the tests."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)
