"""Random weights made on the device from the seed, in the port's parameter
layout and the configuration's dtype: one generator, one draw per kind of
matrix (all layers at once), N(0, 0.02) as the published models are
initialised (GPT-2: 0.01 for positions, 0.02 / sqrt(2 L) for the two
residual projections), norms at 1 and biases at 0. Both the program and
the reference are handed these tensors."""

from __future__ import annotations

import math

import torch

from .traffic import WEIGHTS, sub_seed


def make_weights(cfg, seed: int, device) -> dict:
    """cfg: the port's ModelConfig."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    dtype = cfg.torch_dtype

    def normal(shape, std):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(std)

    def full(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    L, E, V, I = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    if cfg.arch == "llama":
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        shapes = {"q_proj": (E, H * D), "k_proj": (E, Hkv * D), "v_proj": (E, Hkv * D),
                  "o_proj": (H * D, E), "gate_proj": (E, I), "up_proj": (E, I),
                  "down_proj": (I, E)}
        stacks = {k: normal((L,) + s, 0.02) for k, s in shapes.items()}
        stacks["input_norm"] = stacks["post_attn_norm"] = full((L, E), 1.0)
        params = {"embed": normal((V, E), 0.02), "final_norm": full((E,), 1.0)}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = normal((E, V), 0.02)
        params["layers"] = [{k: s[i] for k, s in stacks.items()} for i in range(L)]
        return params
    if cfg.arch == "gpt2":
        out_std = 0.02 / math.sqrt(2 * L)
        mats = {"c_attn": ((E, 3 * E), 0.02), "c_proj": ((E, E), out_std),
                "c_fc": ((E, I), 0.02), "mlp_proj": ((I, E), out_std)}
        stacks = {k: (normal((L,) + s, std), full((L, s[1]), 0.0)) for k, (s, std) in mats.items()}
        ones, zeros = full((L, E), 1.0), full((L, E), 0.0)
        layers = []
        for i in range(L):
            lp = {k: {"w": w[i], "b": b[i]} for k, (w, b) in stacks.items()}
            lp["ln_1"] = {"g": ones[i], "b": zeros[i]}
            lp["ln_2"] = {"g": ones[i], "b": zeros[i]}
            layers.append(lp)
        return {"wte": normal((V, E), 0.02),
                "wpe": normal((cfg.max_position_embeddings, E), 0.01),
                "ln_f": {"g": full((E,), 1.0), "b": full((E,), 0.0)}, "layers": layers}
    raise ValueError(f"no weights for architecture '{cfg.arch}'")
