"""Experiment constants (counterpart of ``qkv_ecc_tpu/evaluation/constants.py``):
the cache modes, BER levels, prime seeds and publication defaults, the
model table, and the peak memory rates of the NVIDIA cards for the kernel
benchmark's bandwidth efficiency. The JAX table's TPU rates and its
models' TPU ``chip`` entries are facts of the TPU and stay there."""

from __future__ import annotations

CACHE_MODES = {
    "fp16": {
        "bits": 16,
        "description": "FP16 Oracle baseline (no quantization)",
        "protected": False,
    },
    "fp8": {
        "bits": 8,
        "description": "FP8 E4M3 quantization (vLLM standard)",
        "protected": False,
    },
    "int4": {
        "bits": 4,
        "description": "INT4 Unprotected (no error correction; fresh "
        "read-time bit flips per attend, reference unprotected_shim.py:276)",
        "protected": False,
    },
    "int4-write-inject": {
        "bits": 4,
        "description": "INT4 Unprotected, write-time (persistent) flips - "
        "the like-for-like perf baseline for the protected arms",
        "protected": False,
    },
    "int4-hamming": {
        "bits": 7,
        "description": "INT4 + Hamming(7,4) SEC",
        "protected": True,
    },
    "int4-hamming84": {
        "bits": 8,
        "description": "INT4 + Hamming(8,4) SECDED (keeps corrupted)",
        "protected": True,
    },
    "int4-hamming84-interp": {
        "bits": 8,
        "description": "INT4 + Hamming(8,4) SECDED + Linear Interpolation",
        "protected": True,
    },
    "int12-golay": {
        "bits": 8,
        "description": "INT4 triplets + Golay(24,12) - corrects up to 3 errors",
        "protected": True,
    },
}

CACHE_MODE_ORDER = [
    "fp16",
    "fp8",
    "int4",
    "int4-hamming",
    "int4-hamming84",
    "int4-hamming84-interp",
    "int12-golay",
]

CACHE_MODE_LABELS = {
    "fp16": "FP16 (Oracle)",
    "fp8": "FP8 (E4M3)",
    "int4": "INT4 (Unprotected)",
    "int4-write-inject": "INT4 (Write-Inject)",
    "int4-hamming": "Hamming(7,4)",
    "int4-hamming84": "Hamming(8,4)",
    "int4-hamming84-interp": "H(8,4)+Interp",
    "int12-golay": "Golay(24,12)",
}

BER_LEVELS = [0, 1e-4, 1e-3, 1e-2]
BER_LEVELS_EXTENDED = [0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2]

DEFAULT_CONFIG = {
    "max_length": 256,
    "stride": 128,
    "block_size": 32,
    "max_samples": 50,
    # 10 prime seeds for statistical rigor
    "seeds": [42, 101, 997, 1999, 4999, 7919, 10007, 15073, 21001, 31337],
}

# model name -> (config name, HF id, metadata)
MODELS = {
    "gpt2": {
        "hf_id": "gpt2",
        "config": "gpt2",
        "type": "gpt2",
        "layers": 12,
        "hidden_size": 768,
        "num_attention_heads": 12,
        "num_kv_heads": 12,
        "requires_auth": False,
    },
    "mistral-7b": {
        "hf_id": "mistralai/Mistral-7B-v0.3",
        "config": "mistral-7b",
        "type": "llama",
        "layers": 32,
        "hidden_size": 4096,
        "num_attention_heads": 32,
        "num_kv_heads": 8,
        "requires_auth": False,
    },
    "llama-3.1-8b": {
        "hf_id": "meta-llama/Llama-3.1-8B",
        "config": "llama-3.1-8b",
        "type": "llama",
        "layers": 32,
        "hidden_size": 4096,
        "num_attention_heads": 32,
        "num_kv_heads": 8,
        "requires_auth": True,
    },
    # offline-friendly tiny configs (random init, byte tokenizer)
    "tiny-gpt2": {
        "hf_id": None,
        "config": "tiny-gpt2",
        "type": "gpt2",
        "layers": 2,
        "hidden_size": 64,
        "num_attention_heads": 4,
        "num_kv_heads": 4,
        "requires_auth": False,
    },
    "tiny-llama": {
        "hf_id": None,
        "config": "tiny-llama",
        "type": "llama",
        "layers": 2,
        "hidden_size": 64,
        "num_attention_heads": 4,
        "num_kv_heads": 2,
        "requires_auth": False,
    },
    # the headline-benchmark model: random-init llama-class 0.9B
    "bench-0.9b": {
        "hf_id": None,
        "config": "bench-0.9b",
        "type": "llama",
        "layers": 24,
        "hidden_size": 2048,
        "num_attention_heads": 16,
        "num_kv_heads": 8,
        "requires_auth": False,
    },
    # trained byte-level model, so the quality tables show real
    # degradation; checkpoint via QKV_TINY_CHECKPOINT (default
    # results/trained_tiny/checkpoint.npz)
    "trained-tiny": {
        "hf_id": None,
        "config": "trained-tiny",
        "type": "gpt2",
        "layers": 6,
        "hidden_size": 256,
        "num_attention_heads": 8,
        "num_kv_heads": 8,
        "requires_auth": False,
    },
    # word-level (8k vocab) trained model: enough PPL dynamic range to show
    # the catastrophic unprotected-INT4 blow-up
    "trained-word": {
        "hf_id": None,
        "config": "trained-word",
        "type": "gpt2",
        "layers": 8,
        "hidden_size": 384,
        "num_attention_heads": 6,
        "num_kv_heads": 6,
        "requires_auth": False,
    },
    # ~100M-param llama-architecture (GQA, 12 Q / 4 KV heads) word-level
    # trained model
    "trained-100m": {
        "hf_id": None,
        "config": "trained-100m",
        "type": "llama",
        "layers": 14,
        "hidden_size": 768,
        "num_attention_heads": 12,
        "num_kv_heads": 4,
        "requires_auth": False,
    },
}

DEFAULT_MODEL = "gpt2"

# the canonical mode -> policy mapping lives in models/kv_policy.py
from ..models.kv_policy import MODE_CONFIG  # noqa: E402


def get_mode_config(cache_mode: str) -> dict:
    if cache_mode not in MODE_CONFIG:
        raise ValueError(
            f"Unknown cache mode: {cache_mode}. Valid modes: {list(MODE_CONFIG)}"
        )
    return dict(MODE_CONFIG[cache_mode])


# Peak memory bandwidth (GB/s) of the NVIDIA cards (NVIDIA's data sheets)
CHIP_BANDWIDTH_GBPS = {
    "T4": 320.0,
    "A100-40GB": 1555.0,
    "A100-80GB": 2039.0,
    "H100": 3352.0,
}

DEFAULT_CHIP = "H100"


def get_chip_bandwidth(chip: str | None = None) -> float:
    """The chip's peak GB/s; an unknown or absent name reads the default
    chip's."""
    if chip is None:
        chip = DEFAULT_CHIP
    return CHIP_BANDWIDTH_GBPS.get(chip, CHIP_BANDWIDTH_GBPS[DEFAULT_CHIP])


def compute_bandwidth_efficiency(
    throughput_mvalues_sec: float, bytes_per_value: float = 1.0, chip: str | None = None
) -> float:
    """Percent of the chip's peak memory rate that the throughput moves."""
    peak = get_chip_bandwidth(chip)
    achieved = throughput_mvalues_sec * bytes_per_value / 1000.0
    return 100.0 * achieved / peak


def get_cache_modes(protected_only: bool = False):
    if protected_only:
        return [m for m in CACHE_MODE_ORDER if CACHE_MODES[m]["protected"]]
    return list(CACHE_MODE_ORDER)


def get_ber_levels(extended: bool = False):
    return list(BER_LEVELS_EXTENDED if extended else BER_LEVELS)


def get_seeds():
    return list(DEFAULT_CONFIG["seeds"])
