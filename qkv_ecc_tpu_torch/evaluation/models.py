"""Model loading for evaluation (counterpart of
``qkv_ecc_tpu/evaluation/models.py``): a model name -> (params,
ModelConfig, tokenizer) on the entry point's device.

The trained models load their ``.npz`` checkpoints
(``training.load_params``; either package's ``save_params`` writes them).
An HF model is converted by ``models/convert.py`` when ``transformers`` can
load it (the hub or a local cache); otherwise it takes random weights when
allowed, else raises, as the JAX function does.
"""

from __future__ import annotations

import os
from typing import Tuple

from ..device import resolve_device
from ..models.config import ModelConfig, get_model_config
from ..models.registry import init_params, map_tree
from .constants import MODELS
from .data import ByteTokenizer, get_tokenizer

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
    ``allow_random_init``, else raises RuntimeError. An HF model loads
    through ``convert.load_hf_checkpoint`` (moved to ``device``) with
    ``get_tokenizer``'s tokenizer; when that fails (no ``transformers``, no
    network and no cache) it takes random weights and the byte tokenizer
    with ``allow_random_init``, else raises RuntimeError. A gated model
    without ``HF_TOKEN`` skips the attempt and takes random weights either
    way, as in JAX's."""
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
                f"{model_name} checkpoint not found at {path}; train it with "
                "python -m qkv_ecc_tpu_torch.evaluation.experiments.train_tiny"
            )
        return init_params(cfg, seed, device=device), cfg, tok_for()

    hf_id = meta["hf_id"]
    if hf_id is not None and not (meta["requires_auth"] and not os.environ.get("HF_TOKEN")):
        try:
            from ..models.convert import load_hf_checkpoint

            params = map_tree(lambda _, t: t.to(device), load_hf_checkpoint(hf_id, cfg))
            return params, cfg, get_tokenizer(model_name, hf_id)
        except Exception as e:  # no transformers, no network, no cache
            if not allow_random_init:
                raise RuntimeError(f"Could not load HF checkpoint '{hf_id}': {e}") from e

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
