"""Llama-family parameters (counterpart of ``qkv_ecc_tpu/models/llama.py``).

The parameter layout is the JAX package's: a dict with ``embed`` [V, E],
``final_norm`` [E], ``lm_head`` [E, V] (untied), and ``layers``, a list of
dicts with ``input_norm``, ``post_attn_norm`` [E] and the projections
``q_proj`` [E, H*D], ``k_proj``/``v_proj`` [E, Hkv*D], ``o_proj`` [H*D, E],
``gate_proj``/``up_proj`` [E, I], ``down_proj`` [I, E], applied as x @ W.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from .config import ModelConfig


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random weights N(0, 0.02) drawn on the generator's device, in the
    order of the JAX package's init (the draws differ). ``dtype`` defaults
    to float32; the bench runs bfloat16."""
    device = generator.device
    dtype = dtype or torch.float32
    E, V, I = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    params = {"embed": normal((V, E)), "final_norm": ones(E), "layers": []}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal((E, V))
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "input_norm": ones(E),
            "post_attn_norm": ones(E),
            "q_proj": normal((E, H * D)),
            "k_proj": normal((E, Hkv * D)),
            "v_proj": normal((E, Hkv * D)),
            "o_proj": normal((H * D, E)),
            "gate_proj": normal((E, I)),
            "up_proj": normal((E, I)),
            "down_proj": normal((I, E)),
        })
    return params


def params_from_jax(np_params: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX ``init_params`` pytree, as numpy arrays, -> the port's
    parameters (same layout and dtypes) on ``device`` (None: the card)."""
    device = resolve_device(device)

    def conv(a):
        return torch.tensor(a, device=device)

    out = {k: conv(v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [{k: conv(v) for k, v in lp.items()} for lp in np_params["layers"]]
    if len(out["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(out['layers'])} layers given, {cfg.name} has {cfg.num_layers}")
    return out
