"""Mistral / Llama as the harness knows it: the port's sizes and parameter
layout, and the description ``core/counts.py`` counts from, all from the
published config's keys (``hidden_size``, ``num_key_value_heads``, ...)."""

from __future__ import annotations


def _head_dim(config: dict) -> int:
    return config.get("head_dim") or config["hidden_size"] // config["num_attention_heads"]


def port_sizes(config: dict) -> dict:
    """The port's ModelConfig fields and the values the config gives them."""
    return {"hidden_size": config["hidden_size"], "num_layers": config["num_hidden_layers"],
            "num_heads": config["num_attention_heads"],
            "num_kv_heads": config["num_key_value_heads"],
            "intermediate_size": config["intermediate_size"],
            "vocab_size": config["vocab_size"], "rope_theta": config["rope_theta"],
            "rms_norm_eps": config["rms_norm_eps"],
            "tie_word_embeddings": config["tie_word_embeddings"],
            "sliding_window": config["sliding_window"], "dtype": config["torch_dtype"]}


def make_weights(cfg, normal, full) -> dict:
    """The port's Llama parameters: every matrix N(0, 0.02), RMSNorm gains
    at 1; an LM head of its own unless the embedding is tied. cfg: the
    port's ModelConfig; ``normal(shape, std)`` and ``full(shape, value)``
    draw on the benchmark's one generator."""
    L, E, V, I = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
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


def layers(config: dict) -> list:
    """Each block: grouped-query attention over the whole context, a K and
    a V row of every KV head a token; the q, k, v, o and three MLP
    matrices; two RMSNorms. No sliding window: no benchmarked Llama has one
    (the reference refuses it too)."""
    if config.get("sliding_window"):
        raise ValueError("no sliding window in the benchmarked Llama layers")
    E, H, Hkv, I = (config["hidden_size"], config["num_attention_heads"],
                    config["num_key_value_heads"], config["intermediate_size"])
    D = _head_dim(config)
    mats = E * (H + 2 * Hkv) * D + H * D * E + 3 * E * I
    return [{"heads": H, "qk_width": D, "pv_width": D, "rows": [("k", Hkv, D), ("v", Hkv, D)],
             "window": None, "products_active": mats, "products_held": mats, "small": 2 * E}
            for _ in range(config["num_hidden_layers"])]


def model(config: dict) -> dict:
    """A token's embedding row, the LM head (E x V, tied or not), the final
    RMSNorm's gain."""
    E = config["hidden_size"]
    return {"embed_row": E, "lm_head": E * config["vocab_size"], "final_norm": E,
            "dtype": config["torch_dtype"]}
