"""GPT-2 with the ECC-protected KV path (counterpart of
``qkv_ecc_tpu/models/gpt2.py``): combined c_attn QKV projection, absolute
position embeddings, pre-LN blocks, tanh-GELU MLP, tied LM head.

The parameter layout is the JAX package's: ``wte`` [V, E], ``wpe`` [P, E],
``ln_f`` {"g", "b"}, and ``layers``, a list of dicts with ``ln_1``, ``ln_2``
{"g", "b"} and the Conv1D projections ``c_attn`` [E, 3E], ``c_proj`` [E,
E], ``c_fc`` [E, I], ``mlp_proj`` [I, E] as {"w" [in, out], "b"}, applied
as x @ w + b. ``forward`` applies the policy's codec chain to each layer's
K/V before attention (kv_policy.process_kv); the decode runtime
(models/runtime.py) shares ``inv_freq``, ``embed``, ``qkv``,
``attn_out_mlp`` and ``lm_head``.
"""

from __future__ import annotations

import math

import torch

from .config import ModelConfig
from .kv_policy import KVCachePolicy, merge_stats, process_kv
from .layers import causal_attention, layer_norm


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random weights drawn on the generator's device in the order of the
    JAX package's init (the draws differ), with its stds: 0.02, 0.01 for
    ``wpe``, 0.02 / sqrt(2 L) for ``c_proj`` and ``mlp_proj``; norms at 1
    and biases at 0. ``dtype`` defaults to float32, as the configs."""
    device = generator.device
    dtype = dtype or torch.float32
    E, V, P, I = cfg.hidden_size, cfg.vocab_size, cfg.max_position_embeddings, cfg.intermediate_size
    out_std = 0.02 / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std=0.02):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * std).to(dtype)

    def zeros(n):
        return torch.zeros(n, device=device, dtype=dtype)

    def norm():
        return {"g": torch.ones(E, device=device, dtype=dtype), "b": zeros(E)}

    params = {"wte": normal((V, E)), "wpe": normal((P, E), std=0.01), "ln_f": norm(), "layers": []}
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "ln_1": norm(),
            "ln_2": norm(),
            "c_attn": {"w": normal((E, 3 * E)), "b": zeros(3 * E)},
            "c_proj": {"w": normal((E, E), std=out_std), "b": zeros(E)},
            "c_fc": {"w": normal((E, I)), "b": zeros(I)},
            "mlp_proj": {"w": normal((I, E), std=out_std), "b": zeros(E)},
        })
    return params


def inv_freq(cfg: ModelConfig, device):
    """GPT-2 has no rotary embedding."""
    return None


def embed(params, input_ids, cfg: ModelConfig, positions):
    """Token plus position embeddings of input_ids [B, S] at positions
    [B, S] (indices past the table clamp to its last row, as JAX's gather
    does)."""
    pos = positions.clamp(max=params["wpe"].shape[0] - 1)
    return params["wte"][input_ids] + params["wpe"][pos]


def qkv(x, lp, cfg: ModelConfig, positions=None, inv_freq=None):
    """ln_1 and the combined projection: q [B, S, H, D], k and v
    [B, S, Hkv, D] (GPT-2 has no rotary embedding: positions and inv_freq
    are unused)."""
    B, S, _ = x.shape
    h = layer_norm(x, lp["ln_1"]["g"], lp["ln_1"]["b"], cfg.layer_norm_eps)
    q, k, v = (h @ lp["c_attn"]["w"] + lp["c_attn"]["b"]).chunk(3, dim=-1)
    D = cfg.head_dim
    return (q.reshape(B, S, cfg.num_heads, D), k.reshape(B, S, cfg.num_kv_heads, D),
            v.reshape(B, S, cfg.num_kv_heads, D))


def attn_out_mlp(x, attn, lp, cfg: ModelConfig):
    """The attention output's projection and residual, then ln_2 and the
    tanh-GELU MLP with its residual."""
    B, S = x.shape[:2]
    x = x + attn.reshape(B, S, cfg.num_heads * cfg.head_dim) @ lp["c_proj"]["w"] + lp["c_proj"]["b"]
    h = layer_norm(x, lp["ln_2"]["g"], lp["ln_2"]["b"], cfg.layer_norm_eps)
    h = torch.nn.functional.gelu(h @ lp["c_fc"]["w"] + lp["c_fc"]["b"], approximate="tanh")
    return x + h @ lp["mlp_proj"]["w"] + lp["mlp_proj"]["b"]


def lm_head(params, x, cfg: ModelConfig):
    """ln_f and the tied head x @ wte.T."""
    x = layer_norm(x, params["ln_f"]["g"], params["ln_f"]["b"], cfg.layer_norm_eps)
    return x @ params["wte"].T


def _block(x, lp, cfg: ModelConfig, policy: KVCachePolicy, layer_idx: int, *, masks=None,
           read_masks=None):
    q, k, v = qkv(x, lp, cfg)
    k, v, stats = process_kv(k, v, policy, layer_idx, seq_axis=1, masks=masks,
                             read_masks=read_masks)
    attn = causal_attention(q, k.to(x.dtype), v.to(x.dtype), cfg.num_kv_groups)
    return attn_out_mlp(x, attn, lp, cfg), stats


def forward(params, input_ids, cfg: ModelConfig, policy: KVCachePolicy, *, write_masks=None,
            read_masks=None):
    """input_ids [B, S] -> (logits [B, S, V], stats). write_masks /
    read_masks: [L, 2, ...] per layer, K then V (kv_policy.process_kv), or
    None to draw them."""
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    x = embed(params, input_ids, cfg, positions)
    stats = None
    for i, lp in enumerate(params["layers"]):
        x, s = _block(x, lp, cfg, policy, i,
                      masks=None if write_masks is None else write_masks[i],
                      read_masks=None if read_masks is None else read_masks[i])
        stats = merge_stats(stats, s)
    return lm_head(params, x, cfg), stats
