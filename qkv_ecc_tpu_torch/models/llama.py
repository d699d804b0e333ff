"""Llama family (Llama 3.x, Mistral) with the ECC-protected KV path
(counterpart of ``qkv_ecc_tpu/models/llama.py``): RMSNorm, rotary
embeddings (with Llama-3.1 NTK-by-parts scaling), GQA with an optional
sliding window, SwiGLU MLP, untied or tied LM head.

The parameter layout is the JAX package's: a dict with ``embed`` [V, E],
``final_norm`` [E], ``lm_head`` [E, V] (untied), and ``layers``, a list of
dicts with ``input_norm``, ``post_attn_norm`` [E] and the projections
``q_proj`` [E, H*D], ``k_proj``/``v_proj`` [E, Hkv*D], ``o_proj`` [H*D, E],
``gate_proj``/``up_proj`` [E, I], ``down_proj`` [I, E], applied as x @ W.
``forward`` applies the policy to post-RoPE K and to V
(kv_policy.process_kv); the decode runtime (models/runtime.py) shares
``inv_freq``, ``embed``, ``qkv``, ``attn_out_mlp`` and ``lm_head``.
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .kv_policy import KVCachePolicy, merge_stats, process_kv
from .layers import apply_rope, causal_attention, rms_norm, rope_frequencies


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
    parameters on ``device`` (None: the card): registry.params_from_jax."""
    from .registry import params_from_jax as convert

    return convert(np_params, cfg, device)


def inv_freq(cfg: ModelConfig, device):
    return rope_frequencies(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_llama3, device=device)


def embed(params, input_ids, cfg: ModelConfig, positions=None):
    """The token embeddings of input_ids [B, S] in the model dtype (RoPE
    carries the positions)."""
    return params["embed"][input_ids].to(cfg.torch_dtype)


def qkv(x, lp, cfg: ModelConfig, positions, inv_freq):
    """input_norm, the projections, and RoPE on q and k at positions
    [B, S]: q [B, S, H, D], k and v [B, S, Hkv, D]."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = (h @ lp["q_proj"]).reshape(B, S, H, D)
    k = (h @ lp["k_proj"]).reshape(B, S, Hkv, D)
    v = (h @ lp["v_proj"]).reshape(B, S, Hkv, D)
    return apply_rope(q, positions, inv_freq), apply_rope(k, positions, inv_freq), v


def attn_out_mlp(x, attn, lp, cfg: ModelConfig, reduce=None):
    """o_proj and its residual, then post_attn_norm and the SwiGLU MLP with
    its residual. ``reduce`` sums the two row-sharded products (o_proj,
    down_proj) over a tensor-parallel group (models/runtime.py); None when
    they are whole."""
    r = reduce or (lambda t: t)
    B, S = x.shape[:2]
    x = x + r(attn.reshape(B, S, cfg.num_heads * cfg.head_dim) @ lp["o_proj"])
    h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
    h = torch.nn.functional.silu(h @ lp["gate_proj"]) * (h @ lp["up_proj"])
    return x + r(h @ lp["down_proj"])


def lm_head(params, x, cfg: ModelConfig):
    """final_norm and the head (embed.T when tied), float32 logits."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    return (x @ head.to(x.dtype)).to(torch.float32)


def _block(x, lp, cfg: ModelConfig, policy: KVCachePolicy, layer_idx: int, positions, freqs, *,
           masks=None, read_masks=None):
    q, k, v = qkv(x, lp, cfg, positions, freqs)
    k, v, stats = process_kv(k, v, policy, layer_idx, seq_axis=1, masks=masks,
                             read_masks=read_masks)
    attn = causal_attention(q, k.to(x.dtype), v.to(x.dtype), cfg.num_kv_groups,
                            sliding_window=cfg.sliding_window)
    return attn_out_mlp(x, attn, lp, cfg), stats


def forward(params, input_ids, cfg: ModelConfig, policy: KVCachePolicy, *, write_masks=None,
            read_masks=None):
    """input_ids [B, S] -> (logits [B, S, V] float32, stats). write_masks /
    read_masks: [L, 2, ...] per layer, K then V (kv_policy.process_kv), or
    None to draw them."""
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    freqs = inv_freq(cfg, input_ids.device)
    x = embed(params, input_ids, cfg)
    stats = None
    for i, lp in enumerate(params["layers"]):
        x, s = _block(x, lp, cfg, policy, i, positions, freqs,
                      masks=None if write_masks is None else write_masks[i],
                      read_masks=None if read_masks is None else read_masks[i])
        stats = merge_stats(stats, s)
    return lm_head(params, x, cfg), stats
