"""Deterministic synthetic token streams, placed on a device.

Port of ``src/repro/data/pipeline.py`` (``:30-125``). Batches are made per
(seed, step) with the same numpy generator and arithmetic as the JAX
pipeline, so both give the same tokens, and restoring a checkpoint at step
N reproduces the batches the interrupted run would have seen. An
encoder-decoder's batch carries ``frames`` (B, S, D), a vision-language
model's ``patches`` (B, min(1024, S), D): fp32 standard normals from the
same generator, drawn after the tokens, cast to the model's dtype on
placement, as the JAX pipeline makes them. The host prefetch thread is not
ported: the training loop takes one batch a step with ``next_sync``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.layers import torch_dtype


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int


class SyntheticTokenPipeline:
    """Markov-ish synthetic LM batches (learnable structure, not noise).
    ``device``: where batches are placed (the caller's; tensors are int32)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 start_step: int = 0, device="cpu"):
        self.cfg = cfg
        self.shape = shape
        self.seed = seed
        self.step = start_step
        self.device = torch.device(device)

    # --- synthesis ----------------------------------------------------------
    def _make_host_batch(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        b, s, v = self.shape.global_batch, self.shape.seq_len, self.cfg.vocab_size
        # tokens follow t_{i+1} = (a * t_i + b) % v with per-sequence (a, b)
        a = rng.integers(1, 17, size=(b, 1))
        c = rng.integers(0, v, size=(b, 1))
        t0 = rng.integers(0, v, size=(b, 1))
        idx = np.arange(s)[None, :]
        tokens = ((a ** (idx % 5 + 1)) * t0 + c * idx) % v
        tokens = tokens.astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.kind == "encdec":
            out["frames"] = rng.standard_normal((b, s, self.cfg.d_model)).astype(np.float32)
        if self.cfg.frontend == "vision_patches":
            n_patch = min(1024, s)
            out["patches"] = rng.standard_normal((b, n_patch, self.cfg.d_model)).astype(np.float32)
        return out

    def _place(self, host: dict) -> dict:
        dt = torch_dtype(self.cfg.dtype)
        return {k: torch.from_numpy(v).to(self.device) if v.dtype == np.int32
                else torch.from_numpy(v).to(self.device, dt) for k, v in host.items()}

    def next_sync(self) -> dict:
        """The batch of the current step, on the device; advances the step."""
        batch = self._place(self._make_host_batch(self.step))
        self.step += 1
        return batch

    # --- checkpointable state -----------------------------------------------
    def state(self) -> PipelineState:
        return PipelineState(seed=self.seed, step=self.step)
