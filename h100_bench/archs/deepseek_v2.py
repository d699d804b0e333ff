"""DeepSeek-V2 (Lite) as the harness knows it: the port's sizes and
parameter layout, and the description ``core/counts.py`` counts from, all
from the published config's keys (``hidden_size``, ``kv_lora_rank``,
``n_routed_experts``, ``rope_scaling``, ...).

Each layer caches one row a token: the latent (kv_lora_rank values) and
the roped k_pe (qk_rope_head_dim), read by every head whole as K and by its
latent as V, the query absorbed (q_nope . W_UK): 16 heads of q . k over 576
values and p . v over 512 at the Lite's sizes.
"""

from __future__ import annotations


def _row(config: dict) -> int:
    return config["kv_lora_rank"] + config["qk_rope_head_dim"]


def port_sizes(config: dict) -> dict:
    """The port's ModelConfig fields and the values the config gives them."""
    ys = config["rope_scaling"]
    return {"hidden_size": config["hidden_size"], "num_layers": config["num_hidden_layers"],
            "num_heads": config["num_attention_heads"], "head_dim": _row(config),
            "intermediate_size": config["intermediate_size"],
            "vocab_size": config["vocab_size"], "rope_theta": config["rope_theta"],
            "rms_norm_eps": config["rms_norm_eps"],
            "tie_word_embeddings": config["tie_word_embeddings"],
            "kv_lora_rank": config["kv_lora_rank"],
            "qk_nope_head_dim": config["qk_nope_head_dim"],
            "qk_rope_head_dim": config["qk_rope_head_dim"], "v_head_dim": config["v_head_dim"],
            "first_k_dense_replace": config["first_k_dense_replace"],
            "n_routed_experts": config["n_routed_experts"],
            "num_experts_per_tok": config["num_experts_per_tok"],
            "n_shared_experts": config["n_shared_experts"],
            "moe_intermediate_size": config["moe_intermediate_size"],
            "norm_topk_prob": config["norm_topk_prob"],
            "routed_scaling_factor": config["routed_scaling_factor"],
            "yarn_factor": ys["factor"],
            "yarn_original_max_position": ys["original_max_position_embeddings"],
            "yarn_beta_fast": ys["beta_fast"], "yarn_beta_slow": ys["beta_slow"],
            "yarn_mscale": ys["mscale"], "yarn_mscale_all_dim": ys["mscale_all_dim"],
            "dtype": config["torch_dtype"]}


def make_weights(cfg, normal, full) -> dict:
    """The port's DeepSeek-V2 parameters: every matrix N(0, 0.02), one draw
    a kind of matrix (all layers of that kind at once), RMSNorm gains at 1;
    an untied LM head. cfg: the port's ModelConfig; ``normal(shape, std)``
    and ``full(shape, value)`` draw on the benchmark's one generator."""
    L, E, V, I, H = (cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size,
                     cfg.num_heads)
    nope, rope, vd, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    n, Im, dense = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.first_k_dense_replace
    Is = Im * cfg.n_shared_experts
    M = L - dense
    attn = {"q_proj": (E, H * (nope + rope)), "kv_a_proj": (E, r + rope),
            "kv_b_proj": (r, H * (nope + vd)), "o_proj": (H * vd, E)}
    dense_mlp = {"gate_proj": (E, I), "up_proj": (E, I), "down_proj": (I, E)}
    moe = {"router": (E, n), "experts_gate": (n, E, Im), "experts_up": (n, E, Im),
           "experts_down": (n, Im, E), "shared_gate": (E, Is), "shared_up": (E, Is),
           "shared_down": (Is, E)}
    stacks = {k: normal((L,) + s, 0.02) for k, s in attn.items()}
    dstacks = {k: normal((dense,) + s, 0.02) for k, s in dense_mlp.items()}
    mstacks = {k: normal((M,) + s, 0.02) for k, s in moe.items()}
    stacks["input_norm"] = stacks["post_attn_norm"] = full((L, E), 1.0)
    stacks["kv_a_norm"] = full((L, r), 1.0)
    params = {"embed": normal((V, E), 0.02), "final_norm": full((E,), 1.0),
              "lm_head": normal((E, V), 0.02), "layers": []}
    for i in range(L):
        lp = {k: s[i] for k, s in stacks.items()}
        lp.update({k: s[i] for k, s in dstacks.items()} if i < dense
                  else {k: s[i - dense] for k, s in mstacks.items()})
        params["layers"].append(lp)
    return params


def layers(config: dict) -> list:
    """Each block: the absorbed latent read (heads of q . k over the row,
    p . v over the latent), one (kv, 1, row) cache row; the attention's
    matrices (q_proj, kv_a_proj, kv_b_proj, o_proj) and a dense SwiGLU, or
    the router, the routed experts (num_experts_per_tok active, all held)
    and the shared ones; three RMSNorms (input, post-attention, the
    latent's)."""
    E, H = config["hidden_size"], config["num_attention_heads"]
    nope, rope, vd, r = (config["qk_nope_head_dim"], config["qk_rope_head_dim"],
                         config["v_head_dim"], config["kv_lora_rank"])
    attn = E * H * (nope + rope) + E * (r + rope) + r * H * (nope + vd) + H * vd * E
    n, k, Im = config["n_routed_experts"], config["num_experts_per_tok"], config["moe_intermediate_size"]
    shared = 3 * E * Im * config["n_shared_experts"]
    out = []
    for i in range(config["num_hidden_layers"]):
        if i < config["first_k_dense_replace"]:
            active = held = attn + 3 * E * config["intermediate_size"]
        else:
            active = attn + E * n + k * 3 * E * Im + shared
            held = attn + E * n + n * 3 * E * Im + shared
        out.append({"heads": H, "qk_width": r + rope, "pv_width": r,
                    "rows": [("kv", 1, r + rope)], "window": None,
                    "products_active": active, "products_held": held, "small": 2 * E + r})
    return out


def model(config: dict) -> dict:
    """A token's embedding row, the untied LM head (E x V), the final
    RMSNorm's gain."""
    E = config["hidden_size"]
    return {"embed_row": E, "lm_head": E * config["vocab_size"], "final_norm": E,
            "dtype": config["torch_dtype"]}
