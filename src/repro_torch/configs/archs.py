"""The 10 assigned architectures (public configs, see brackets for source).

Each is exposed as a module-level ``CONFIG`` via per-arch shim modules and
collected in ``ARCHS`` for ``--arch <id>`` selection.
"""
from __future__ import annotations

from repro_torch.configs.base import Mamba2Config, ModelConfig, MoeConfig

# [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave (attention every 8th
# layer), MoE 16e top-2 applied every other layer.
JAMBA_1_5_LARGE_398B = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mlp="swiglu",
    mixer_pattern=(
        "mamba2", "mamba2", "mamba2", "attention",
        "mamba2", "mamba2", "mamba2", "mamba2",
    ),
    moe=MoeConfig(num_experts=16, top_k=2, every=2),
    mamba2=Mamba2Config(d_state=128, head_dim=64, expand=2),
)

# [hf:stabilityai/stablelm-2-1_6b; unverified] — MHA (kv == heads).
STABLELM_3B = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    mlp="swiglu",
    norm="layernorm",
)

# [arXiv:2407.21783; unverified] — GQA kv=8, 128k vocab.
LLAMA3_405B = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    num_heads=128,
    num_kv_heads=8,
    d_ff=53248,
    vocab_size=128256,
    mlp="swiglu",
    rope_theta=500_000.0,
)

# [arXiv:2402.19173; hf] — GQA kv=4, RoPE, non-gated GELU MLP.
STARCODER2_15B = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    mlp="gelu",
    norm="layernorm",
)

# [arXiv:2402.16819; unverified] — squared-ReLU MLP, 256k vocab.
NEMOTRON_4_340B = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp="relu2",
    norm="layernorm",
)

# [hf:Qwen/Qwen1.5-MoE-A2.7B; hf] — 60 routed top-4 + 4 shared experts.
QWEN2_MOE_A2_7B = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    mlp="swiglu",
    moe=MoeConfig(num_experts=60, top_k=4, num_shared_experts=4, d_expert=1408),
)

# [arXiv:2401.04088; hf] — 8 experts top-2, sliding-window attention.
MIXTRAL_8X22B = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    mlp="swiglu",
    sliding_window=4096,
    moe=MoeConfig(num_experts=8, top_k=2),
)

# [arXiv:2405.21060; unverified] — pure SSD, attention-free, no MLP stack.
MAMBA2_130M = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=0,
    vocab_size=50280,
    mixer_pattern=("mamba2",),
    mamba2=Mamba2Config(d_state=128, head_dim=64, expand=2),
)

# [arXiv:2308.11596; hf] — enc-dec; audio frontend stubbed (frame embeddings).
SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    kind="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    mlp="gelu",
    norm="layernorm",
    frontend="audio_frames",
)

# [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — LM backbone only;
# anyres vision tiling stubbed (patch embeddings).
LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    mlp="swiglu",
    frontend="vision_patches",
)

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        JAMBA_1_5_LARGE_398B,
        STABLELM_3B,
        LLAMA3_405B,
        STARCODER2_15B,
        NEMOTRON_4_340B,
        QWEN2_MOE_A2_7B,
        MIXTRAL_8X22B,
        MAMBA2_130M,
        SEAMLESS_M4T_LARGE_V2,
        LLAVA_NEXT_34B,
    )
}
