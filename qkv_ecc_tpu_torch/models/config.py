"""Model configurations (counterpart of ``qkv_ecc_tpu/models/config.py``):
its nine configurations, field for field."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str  # "gpt2" | "llama"
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    max_position_embeddings: int = 2048
    rope_theta: float = 10000.0
    rope_scaling_llama3: bool = False  # Llama-3.1 NTK-by-parts scaling
    rms_norm_eps: float = 1e-5
    layer_norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    sliding_window: Optional[int] = None  # Mistral
    dtype: str = "float32"

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


GPT2_124M = ModelConfig(
    name="gpt2",
    arch="gpt2",
    vocab_size=50257,
    hidden_size=768,
    num_layers=12,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    intermediate_size=3072,
    max_position_embeddings=1024,
    tie_word_embeddings=True,
)

MISTRAL_7B = ModelConfig(
    name="mistral-7b",
    arch="llama",
    vocab_size=32768,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    max_position_embeddings=32768,
    rope_theta=1000000.0,
    tie_word_embeddings=False,
    sliding_window=None,  # v0.3 has no sliding window
    dtype="bfloat16",
)

LLAMA31_8B = ModelConfig(
    name="llama-3.1-8b",
    arch="llama",
    vocab_size=128256,
    hidden_size=4096,
    num_layers=32,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=14336,
    max_position_embeddings=131072,
    rope_theta=500000.0,
    rope_scaling_llama3=True,
    tie_word_embeddings=False,
    dtype="bfloat16",
)

# Tiny configs for tests (no checkpoints needed)
TINY_GPT2 = ModelConfig(
    name="tiny-gpt2",
    arch="gpt2",
    vocab_size=256,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    intermediate_size=128,
    max_position_embeddings=128,
)

TINY_LLAMA = ModelConfig(
    name="tiny-llama",
    arch="llama",
    vocab_size=256,
    hidden_size=64,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    intermediate_size=128,
    max_position_embeddings=128,
    rope_theta=10000.0,
    tie_word_embeddings=False,
)

# Byte-level GPT-2 trained by the JAX package (its checkpoint lives under
# results/trained_tiny/): large enough that KV-cache corruption visibly
# destroys its predictions, small enough to train in minutes.
TRAINED_TINY = ModelConfig(
    name="trained-tiny",
    arch="gpt2",
    vocab_size=256,
    hidden_size=256,
    num_layers=6,
    num_heads=8,
    num_kv_heads=8,
    head_dim=32,
    intermediate_size=1024,
    max_position_embeddings=512,
)

# ~100M-param word-level model: llama architecture with GQA (12 Q / 4 KV
# heads), trained on the word corpus; ~103M parameters (tied embeddings).
TRAINED_100M = ModelConfig(
    name="trained-100m",
    arch="llama",
    vocab_size=8192,
    hidden_size=768,
    num_layers=14,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    intermediate_size=2304,
    max_position_embeddings=512,
    rope_theta=10000.0,
    tie_word_embeddings=True,
)

# The headline-benchmark model (bench.py, benchmarks/scaling.py): llama
# architecture, ~0.9B parameters plus embeddings, GQA 16/8 at head_dim 128,
# bf16 with room for batch-8 KV. Random weights: throughput does not depend
# on their content.
BENCH_0_9B = ModelConfig(
    name="bench-0.9b",
    arch="llama",
    vocab_size=32768,
    hidden_size=2048,
    num_layers=24,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    intermediate_size=5632,
    max_position_embeddings=4096,
    rope_theta=10000.0,
    tie_word_embeddings=False,
    dtype="bfloat16",
)

# Word-level trainable model (8k vocab): big enough dynamic range for the
# catastrophic unprotected-INT4 demonstration (byte models cap PPL at 256)
TRAINED_WORD = ModelConfig(
    name="trained-word",
    arch="gpt2",
    vocab_size=8192,
    hidden_size=384,
    num_layers=8,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    intermediate_size=1536,
    max_position_embeddings=512,
)

MODEL_CONFIGS = {
    c.name: c
    for c in (
        GPT2_124M, MISTRAL_7B, LLAMA31_8B, TINY_GPT2, TINY_LLAMA,
        TRAINED_TINY, TRAINED_WORD, TRAINED_100M, BENCH_0_9B,
    )
}


def get_model_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise ValueError(f"Unknown model '{name}'. Known: {sorted(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[name]
