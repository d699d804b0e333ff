"""Sharding specifications: Megatron tensor parallelism over the "model"
axis and data parallelism over "data" (counterpart of
``qkv_ecc_tpu/parallel/sharding.py``).

A spec is the dimension a tensor is split on over the model axis, or None
when every rank holds it whole (JAX's P(None, "model") is 1, P("model",
None) and P("model") are 0, P() is None):
  * attention: q/k/v column-sharded (heads split over the model ranks),
    o_proj row-sharded with a sum after it, so the paged ECC cache is
    sharded on its KV-head axis and the attention kernel runs on each
    rank's own heads;
  * MLP: gate/up column-sharded, down row-sharded with a sum;
  * embeddings and norms whole; an untied lm_head column-sharded (vocab);
  * KV cache [L, blocks, Hkv, words, bs]: dimension 2; scales dimension 2.
"""

from __future__ import annotations

import torch

from ..models.config import ModelConfig, refuse_latent


def llama_param_specs(cfg: ModelConfig) -> dict:
    layer = {"input_norm": None, "post_attn_norm": None, "q_proj": 1, "k_proj": 1, "v_proj": 1,
             "o_proj": 0, "gate_proj": 1, "up_proj": 1, "down_proj": 0}
    specs = {"embed": None, "final_norm": None,
             "layers": [dict(layer) for _ in range(cfg.num_layers)]}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = 1
    return specs


def gpt2_param_specs(cfg: ModelConfig) -> dict:
    """c_attn packs Q|K|V along its columns, so shard_params first permutes
    them head-blockwise (permute_gpt2_qkv): rank s's column slice is then
    [Q_s | K_s | V_s]. c_proj and mlp_proj are row-sharded and their biases
    added once after the sum (the ``reduce`` of models/gpt2.attn_out_mlp)."""
    def layer():
        return {"ln_1": {"g": None, "b": None}, "ln_2": {"g": None, "b": None},
                "c_attn": {"w": 1, "b": 0}, "c_proj": {"w": 0, "b": None},
                "c_fc": {"w": 1, "b": 0}, "mlp_proj": {"w": 0, "b": None}}

    return {"wte": None, "wpe": None, "ln_f": {"g": None, "b": None},
            "layers": [layer() for _ in range(cfg.num_layers)]}


def param_specs(cfg: ModelConfig) -> dict:
    refuse_latent(cfg, "tensor parallelism")
    if cfg.arch == "llama":
        return llama_param_specs(cfg)
    return gpt2_param_specs(cfg)


def cache_specs() -> dict:
    """The paged cache's arrays: KV heads on the model axis (the split
    parity arrays as the data arrays)."""
    return {"k_cache": 2, "v_cache": 2, "k_parity": 2, "v_parity": 2, "k_scales": 2,
            "v_scales": 2, "context_len": None}


def qkv_permutation(cfg: ModelConfig, tp: int) -> torch.Tensor:
    """JAX's column order of a permuted c_attn: for each of the tp shards,
    its heads' Q, then K, then V columns."""
    E = cfg.num_heads * cfg.head_dim
    width = cfg.num_heads // tp * cfg.head_dim
    perm = [seg * E + s * width + i for s in range(tp) for seg in range(3) for i in range(width)]
    return torch.tensor(perm, dtype=torch.long)


def permute_gpt2_qkv(params, cfg: ModelConfig, tp: int):
    """Every c_attn [E, 3E] and its bias with the columns permuted
    head-blockwise (qkv_permutation), so that a plain column shard over tp
    ranks holds its own heads' [Q_s | K_s | V_s]: a relabelling, after
    which the local third-split is the single-device split restricted to
    the local heads. Returns a new tree (the others' leaves shared)."""
    out = dict(params)
    layers = []
    for lp in params["layers"]:
        perm = qkv_permutation(cfg, tp).to(lp["c_attn"]["w"].device)
        lp = dict(lp)
        lp["c_attn"] = {"w": lp["c_attn"]["w"][:, perm], "b": lp["c_attn"]["b"][perm]}
        layers.append(lp)
    out["layers"] = layers
    return out


def _shard(x: torch.Tensor, dim, n: int, i: int) -> torch.Tensor:
    """Part i of n of x along dim (None: x), in memory of its own."""
    if dim is None:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over {n} ranks")
    return x.chunk(n, dim=dim)[i].clone()


def _map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's slices of a parameter tree (its model index of
    mesh.model parts; gpt2's c_attn permuted first): the columns of
    q/k/v/gate/up, of c_attn and c_fc with their biases, and of an untied
    lm_head; the rows of o_proj/down and of c_proj/mlp_proj; the rest
    whole."""
    if cfg.arch == "gpt2":
        params = permute_gpt2_qkv(params, cfg, mesh.model)
    return _map(lambda x, d: _shard(x, d, mesh.model, mesh.model_index), params,
                param_specs(cfg))


def shard_cache(state: dict, mesh):
    """This rank's KV heads of a full cache state (cache_specs)."""
    specs = cache_specs()
    return {k: _shard(v, specs[k], mesh.model, mesh.model_index) for k, v in state.items()}
