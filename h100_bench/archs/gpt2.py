"""GPT-2 as the harness knows it: the port's sizes and parameter layout,
and the description ``core/counts.py`` counts from, all from the published
config's keys (``n_embd``, ``n_layer``, ``n_head``, ...)."""

from __future__ import annotations

import math


def _inner(config: dict) -> int:
    return config.get("n_inner") or 4 * config["n_embd"]


def port_sizes(config: dict) -> dict:
    """The port's ModelConfig fields and the values the config gives them."""
    return {"hidden_size": config["n_embd"], "num_layers": config["n_layer"],
            "num_heads": config["n_head"], "vocab_size": config["vocab_size"],
            "max_position_embeddings": config["n_positions"],
            "layer_norm_eps": config["layer_norm_epsilon"], "intermediate_size": _inner(config),
            "dtype": config["torch_dtype"]}


def make_weights(cfg, normal, full) -> dict:
    """The port's GPT-2 parameters: N(0, 0.02), positions N(0, 0.01), the
    two residual projections N(0, 0.02 / sqrt(2 L)), LayerNorm gains at 1,
    biases at 0. cfg: the port's ModelConfig; ``normal(shape, std)`` and
    ``full(shape, value)`` draw on the benchmark's one generator."""
    L, E, V, I = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
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


def layers(config: dict) -> list:
    """Each block: multi-head attention over the whole context, a K and a V
    row of every head a token; the combined q/k/v, output and two MLP
    matrices; two LayerNorms and four biases."""
    E, H, I = config["n_embd"], config["n_head"], _inner(config)
    D = E // H
    mats = 4 * E * E + 2 * E * I
    return [{"heads": H, "qk_width": D, "pv_width": D, "rows": [("k", H, D), ("v", H, D)],
             "window": None, "products_active": mats, "products_held": mats,
             "small": 2 * 2 * E + 3 * E + E + I + E}
            for _ in range(config["n_layer"])]


def model(config: dict) -> dict:
    """A token's embedding and position rows, the head tied to the
    embedding (E x V), the final LayerNorm's gain and bias."""
    E = config["n_embd"]
    return {"embed_row": 2 * E, "lm_head": E * config["vocab_size"], "final_norm": 2 * E,
            "dtype": config["torch_dtype"]}
