"""Config registry: ``get_config("llama3-405b")`` / ``--arch`` ids."""
from __future__ import annotations

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    Mamba2Config,
    ModelConfig,
    MoeConfig,
    ShapeConfig,
    reduced,
    shapes_for,
)
from repro_torch.configs.paper_models import PAPER_MODELS, paper_shape

REGISTRY: dict[str, ModelConfig] = {**ARCHS, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")
