"""Model / run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``; the four shape
suites are ``ShapeConfig``s. Configs are plain frozen dataclasses so they can be
hashed into jit cache keys and serialized into checkpoints.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

MixerKind = Literal["attention", "mamba2"]
MlpKind = Literal["swiglu", "gelu", "relu2", "geglu"]
ModelKind = Literal["decoder", "encdec"]
Frontend = Literal["none", "audio_frames", "vision_patches"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    """Mixture-of-experts settings for MoE/hybrid layers."""

    num_experts: int
    top_k: int
    # Experts that every token passes through (Qwen-MoE style), 0 for pure MoE.
    num_shared_experts: int = 0
    # d_ff of each expert (may differ from the dense d_ff).
    d_expert: int = 0
    # Apply MoE every `every` layers (1 = all layers, 2 = alternating, ...).
    every: int = 1
    # Router jitter / load-balance loss weight.
    aux_loss_weight: float = 0.01
    # Expert capacity = ceil(top_k * tokens / num_experts * capacity_factor).
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    """SSD (state-space duality) mixer settings [arXiv:2405.21060]."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256  # SSD block size along sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    kind: ModelKind = "decoder"
    head_dim: int = 0  # 0 -> d_model // num_heads
    mlp: MlpKind = "swiglu"
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    rope_theta: float = 10_000.0
    # Sliding-window attention size; 0 = full attention.
    sliding_window: int = 0
    # Per-layer mixer pattern, tiled over layers (e.g. Jamba 1 attn : 7 mamba).
    mixer_pattern: Sequence[MixerKind] = ("attention",)
    moe: MoeConfig | None = None
    mamba2: Mamba2Config | None = None
    # Encoder config for encdec models (decoder uses the top-level fields).
    encoder_layers: int = 0
    # Modality frontend stub: the model consumes precomputed embeddings.
    frontend: Frontend = "none"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def mixer_at(self, layer: int) -> MixerKind:
        return self.mixer_pattern[layer % len(self.mixer_pattern)]

    def moe_at(self, layer: int) -> bool:
        return self.moe is not None and (layer % self.moe.every) == (self.moe.every - 1)

    @property
    def attention_free(self) -> bool:
        return all(m != "attention" for m in self.mixer_pattern)

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM/hybrid state or SWA window)."""
        return self.attention_free or self.sliding_window > 0 or any(
            m == "mamba2" for m in self.mixer_pattern
        )

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), exact for our zoo."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d  # token embedding
        if not self.tie_embeddings:
            total += v * d  # lm head

        def attn_params() -> int:
            return d * n_q + 2 * d * n_kv + n_q * d

        def mamba_params() -> int:
            mc = self.mamba2
            d_in = mc.expand * d
            n_h = d_in // mc.head_dim
            # in_proj: z, x, B, C, dt
            zxbcdt = d * (2 * d_in + 2 * mc.d_state + n_h)
            conv = mc.d_conv * (d_in + 2 * mc.d_state)
            out = d_in * d
            return zxbcdt + conv + out + 2 * n_h  # + A_log, D

        def dense_mlp() -> int:
            mults = 3 if self.mlp in ("swiglu", "geglu") else 2
            return mults * d * ff

        def moe_mlp() -> int:
            mc = self.moe
            de = mc.d_expert or ff
            per = 3 * d * de if self.mlp in ("swiglu", "geglu") else 2 * d * de
            return mc.num_experts * per + mc.num_shared_experts * per + d * mc.num_experts

        def block(layer: int) -> int:
            mixer = attn_params() if self.mixer_at(layer) == "attention" else mamba_params()
            mlp = moe_mlp() if self.moe_at(layer) else (dense_mlp() if ff else 0)
            return mixer + mlp + 2 * d  # two norms

        total += sum(block(l) for l in range(self.num_layers))
        if self.kind == "encdec":
            # encoder blocks (dense attention + mlp) + decoder cross-attn
            enc_block = attn_params() + dense_mlp() + 2 * d
            total += self.encoder_layers * enc_block
            total += self.num_layers * (attn_params() + d)  # cross attn + norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        mc = self.moe
        de = mc.d_expert or self.d_ff
        per = (3 if self.mlp in ("swiglu", "geglu") else 2) * self.d_model * de
        inactive = (mc.num_experts - mc.top_k) * per
        n_moe_layers = sum(1 for l in range(self.num_layers) if self.moe_at(l))
        return self.param_count() - n_moe_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: Literal["train", "prefill", "decode"]

    @property
    def is_training(self) -> bool:
        return self.mode == "train"


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(config: ModelConfig) -> tuple[ShapeConfig, ...]:
    """The shape cells defined for this architecture (assignment rules)."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if config.subquadratic:
        shapes.append(LONG_500K)
    return tuple(shapes)


def reduced(config: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes: dict = dict(
        num_layers=min(config.num_layers, 2 * len(config.mixer_pattern))
        if len(config.mixer_pattern) > 1
        else 2,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(config.num_kv_heads, 4) if config.num_kv_heads else 4,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        encoder_layers=2 if config.kind == "encdec" else 0,
        sliding_window=min(config.sliding_window, 64) if config.sliding_window else 0,
    )
    if config.moe is not None:
        changes["moe"] = dataclasses.replace(
            config.moe,
            num_experts=4,
            top_k=min(config.moe.top_k, 2),
            d_expert=128 if config.moe.d_expert else 0,
            capacity_factor=8.0,  # drop-free so decode == prefill in tests
        )
    if config.mamba2 is not None:
        changes["mamba2"] = dataclasses.replace(
            config.mamba2, d_state=16, head_dim=32, chunk_size=32
        )
    # keep hybrid patterns: at least one full pattern repetition
    if len(config.mixer_pattern) > 1:
        changes["num_layers"] = len(config.mixer_pattern)
    changes.update(overrides)
    return dataclasses.replace(config, **changes)
