"""Model configurations (counterpart of ``qkv_ecc_tpu/models/config.py``):
its nine configurations, field for field, then the port's own
(DeepSeek-V2-Lite and its tiny CPU counterpart), whose latent attention,
experts and YaRN fields the nine leave at their defaults."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch: str  # "gpt2" | "llama" | "deepseek_v2"
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
    # deepseek_v2: latent attention (MLA) with q_lora_rank null; each token
    # caches one latent row of kv_lora_rank + qk_rope_head_dim values
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # deepseek_v2: layers from first_k_dense_replace on are MoE layers of
    # n_routed_experts experts (num_experts_per_tok a token, softmax routing
    # in float32, greedy top-k) and n_shared_experts shared ones, each of
    # width moe_intermediate_size
    first_k_dense_replace: int = 0
    n_routed_experts: int = 0
    num_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_intermediate_size: int = 0
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    # YaRN rope scaling (factor 0: none)
    yarn_factor: float = 0.0
    yarn_original_max_position: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0

    def __repr__(self) -> str:
        """The dataclass's repr over ``as_dict``: a configuration of the JAX
        package's nine reads as that package's (sweep fingerprints hash it)."""
        return f"ModelConfig({', '.join(f'{k}={v!r}' for k, v in self.as_dict().items())})"

    def as_dict(self) -> dict:
        """The fields as a dict, the port's own (latent attention, experts,
        YaRN) left out where they hold their defaults: a configuration of
        the JAX package's nine gives that package's dict."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name in _JAX_FIELDS or getattr(self, f.name) != f.default}

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]


# the fields the JAX package's ModelConfig has; those after them are the port's own
_FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]
_JAX_FIELDS = tuple(_FIELDS[:_FIELDS.index("kv_lora_rank")])

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

# DeepSeek-V2-Lite (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite,
# config.json): 27 layers, layer 0 dense, then 64 routed experts (6 a token)
# and 2 shared a layer; MLA over a 512-value latent and a 64-value roped key;
# YaRN (factor 40 over 4096 positions). head_dim is the cache row's width:
# one latent row of 576 values a token, read by all 16 heads.
DEEPSEEK_V2_LITE = ModelConfig(
    name="deepseek-v2-lite",
    arch="deepseek_v2",
    vocab_size=102400,
    hidden_size=2048,
    num_layers=27,
    num_heads=16,
    num_kv_heads=1,
    head_dim=576,
    intermediate_size=10944,
    max_position_embeddings=163840,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=False,
    dtype="bfloat16",
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense_replace=1,
    n_routed_experts=64,
    num_experts_per_tok=6,
    n_shared_experts=2,
    moe_intermediate_size=1408,
    norm_topk_prob=False,
    routed_scaling_factor=1.0,
    yarn_factor=40.0,
    yarn_original_max_position=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
)

# Its structure at CPU-test size: a dense layer 0, then two MoE layers of 8
# experts (2 a token, 1 shared); a 48-value cache row (latent 32, rope 16)
TINY_DEEPSEEK_V2 = ModelConfig(
    name="tiny-deepseek-v2",
    arch="deepseek_v2",
    vocab_size=256,
    hidden_size=64,
    num_layers=3,
    num_heads=4,
    num_kv_heads=1,
    head_dim=48,
    intermediate_size=128,
    max_position_embeddings=4096,
    rope_theta=10000.0,
    rms_norm_eps=1e-6,
    tie_word_embeddings=False,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=16,
    v_head_dim=16,
    first_k_dense_replace=1,
    n_routed_experts=8,
    num_experts_per_tok=2,
    n_shared_experts=1,
    moe_intermediate_size=32,
    yarn_factor=40.0,
    yarn_original_max_position=64,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
)

# JAX's nine in its order, then the port's own
MODEL_CONFIGS = {
    c.name: c
    for c in (
        GPT2_124M, MISTRAL_7B, LLAMA31_8B, TINY_GPT2, TINY_LLAMA,
        TRAINED_TINY, TRAINED_WORD, TRAINED_100M, BENCH_0_9B,
        DEEPSEEK_V2_LITE, TINY_DEEPSEEK_V2,
    )
}


LATENT_ARCHS = ("deepseek_v2",)  # one latent cache row a token (row kind "kv")


def is_latent(cfg: ModelConfig) -> bool:
    return cfg.arch in LATENT_ARCHS


def refuse_latent(cfg: ModelConfig, what: str):
    """Raise NotImplementedError for a latent model on a path it is not
    ported to (a mesh, the server, training)."""
    if is_latent(cfg):
        raise NotImplementedError(f"architecture '{cfg.arch}' ({cfg.name}): {what} is not "
                                  "ported for the latent cache")


def get_model_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise ValueError(f"Unknown model '{name}'. Known: {sorted(MODEL_CONFIGS)}")
    return MODEL_CONFIGS[name]
