"""Paper Table 1 model configurations (GPT-2 / OPT / Mistral / LLaMA sizes).

Used by the benchmark harness to reproduce the paper's tables; sequence length
in the paper is fixed at 1024.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _gpt2(name: str, hidden: int, blocks: int, heads: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=blocks,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=4 * hidden,
        vocab_size=50257,
        mlp="gelu",
        norm="layernorm",
        tie_embeddings=True,
    )


def _llama(name: str, hidden: int, blocks: int, heads: int, ff: int) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=blocks,
        d_model=hidden,
        num_heads=heads,
        num_kv_heads=heads,
        d_ff=ff,
        vocab_size=32000,
        mlp="swiglu",
    )


# Table 1 rows (parameter sizes are the paper's labels).
GPT2_1B = _gpt2("gpt2-1b", 2048, 18, 16)  # row A/B/C of Table 4
GPT2_10B = _gpt2("gpt2-10b", 4096, 48, 32)
GPT2_15B = _gpt2("gpt2-15b", 8192, 18, 64)
GPT2_20B = _gpt2("gpt2-20b", 8192, 24, 64)
GPT2_30B = _gpt2("gpt2-30b", 8192, 36, 64)
GPT2_40B = _gpt2("gpt2-40b", 8192, 50, 64)
MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    mlp="swiglu",
    sliding_window=4096,
)
OPT_13B = ModelConfig(
    name="opt-13b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=20480,
    vocab_size=50272,
    mlp="relu2",  # OPT uses ReLU; relu2 is our closest kind — see DESIGN.md
    norm="layernorm",
)
OPT_30B = ModelConfig(
    name="opt-30b",
    family="dense",
    num_layers=48,
    d_model=7168,
    num_heads=56,
    num_kv_heads=56,
    d_ff=28672,
    vocab_size=50272,
    mlp="relu2",
    norm="layernorm",
)
LLAMA_13B = _llama("llama-13b", 5120, 40, 40, 13824)
LLAMA_34B = _llama("llama-34b", 8192, 48, 64, 22016)

PAPER_MODELS = {
    m.name: m
    for m in (
        GPT2_1B, GPT2_10B, GPT2_15B, GPT2_20B, GPT2_30B, GPT2_40B,
        MISTRAL_7B, OPT_13B, OPT_30B, LLAMA_13B, LLAMA_34B,
    )
}

# The paper's controlled-comparison shape: seq 1024, batch swept per bench.
def paper_shape(batch: int) -> ShapeConfig:
    return ShapeConfig(f"paper_b{batch}", 1024, batch, "train")
