"""Model loading for evaluation (counterpart of
``qkv_ecc_tpu/evaluation/models.py``): a model name -> (params,
ModelConfig, tokenizer) on the entry point's device.

The trained models load the JAX package's checkpoints
(``training.load_params``). The port has no converter of HF checkpoints
yet, so its HF branch does what the JAX function does offline: random
weights when allowed, else an error.
"""

from __future__ import annotations

import os
from typing import Tuple

from ..device import resolve_device
from ..models.config import ModelConfig, get_model_config
from ..models.registry import init_params
from .constants import MODELS
from .data import ByteTokenizer

TRAINED_CHECKPOINTS = {
    "trained-tiny": "results/trained_tiny/checkpoint.npz",
    "trained-word": "results/trained_word/checkpoint.npz",
    "trained-100m": "results/trained_100m/checkpoint.npz",
}


def checkpoint_path(model_name: str) -> str:
    """A trained model's checkpoint: ``QKV_TINY_CHECKPOINT`` when set, else
    its default path under results/."""
    return os.environ.get("QKV_TINY_CHECKPOINT", TRAINED_CHECKPOINTS[model_name])


def load_model(
    model_name: str = "gpt2",
    *,
    allow_random_init: bool = True,
    seed: int = 0,
    device=None,
) -> Tuple[dict, ModelConfig, object]:
    """Resolve a model name -> (params, config, tokenizer), the params on
    ``device`` (None: the card).

    A trained model loads its checkpoint and, for the word models, the
    vocabulary beside it; without a checkpoint it takes random weights when
    ``allow_random_init``, else raises RuntimeError. An HF model has no
    converter in the port: with ``allow_random_init`` it takes random
    weights and the byte tokenizer; otherwise it raises RuntimeError, as the
    JAX function does when the download fails (a gated model without
    ``HF_TOKEN`` skips the download there and takes random weights either
    way, and so does it here)."""
    if model_name not in MODELS:
        raise ValueError(f"Unknown model: {model_name}. Known: {sorted(MODELS)}")
    device = resolve_device(device)
    meta = MODELS[model_name]
    cfg = get_model_config(meta["config"])

    if model_name in TRAINED_CHECKPOINTS:
        from ..training import WordTokenizer, load_params

        path = checkpoint_path(model_name)

        def tok_for():
            vocab_path = path + ".vocab.json"
            if model_name in ("trained-word", "trained-100m") and os.path.exists(vocab_path):
                return WordTokenizer.load(vocab_path)
            return ByteTokenizer()

        if os.path.exists(path):
            return load_params(path, cfg, device=device), cfg, tok_for()
        if not allow_random_init:
            raise RuntimeError(
                f"{model_name} checkpoint not found at {path}; the JAX package trains it "
                "(python -m qkv_ecc_tpu.evaluation.experiments.train_tiny)"
            )
        return init_params(cfg, seed, device=device), cfg, tok_for()

    hf_id = meta["hf_id"]
    if hf_id is not None:
        gated = meta["requires_auth"] and not os.environ.get("HF_TOKEN")
        if not gated and not allow_random_init:
            raise RuntimeError(
                f"Could not load HF checkpoint '{hf_id}': the port has no HF "
                "checkpoint converter"
            )

    if not allow_random_init and hf_id is None:
        raise RuntimeError(f"No checkpoint available for {model_name}")

    return init_params(cfg, seed, device=device), cfg, ByteTokenizer()


def get_model_info(model_name: str) -> dict:
    if model_name not in MODELS:
        raise ValueError(f"Unknown model: {model_name}")
    return dict(MODELS[model_name])


def estimate_param_count(cfg: ModelConfig) -> int:
    E, V, I, L = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size, cfg.num_layers
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.arch == "gpt2":
        per_layer = E * 3 * E + 3 * E + E * E + E + E * I + I + I * E + E + 4 * E
        return V * E + cfg.max_position_embeddings * E + L * per_layer + 2 * E
    per_layer = E * (H * D) + 2 * E * (Hkv * D) + (H * D) * E + 3 * E * I + 2 * E
    total = V * E + L * per_layer + E
    if not cfg.tie_word_embeddings:
        total += E * V
    return total
