"""Model configurations (counterpart of ``qkv_ecc_tpu/models/config.py``;
the llama configurations this slice runs)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str  # "llama" (gpt2 is a later slice)
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

# The headline-benchmark model of the JAX package (bench.py): llama
# architecture, ~0.9B parameters plus embeddings, GQA 16/8 at head_dim 128.
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

MODEL_CONFIGS = {c.name: c for c in (TINY_LLAMA, BENCH_0_9B)}


def get_model_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise ValueError(f"Unknown model '{name}'. Known: {sorted(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[name]
