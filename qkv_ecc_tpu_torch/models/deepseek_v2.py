"""DeepSeek-V2 (Lite) with the ECC-protected latent cache: multi-head
latent attention (MLA, ``q_lora_rank`` null), YaRN rotary embeddings, a
dense first layer and then mixture-of-experts layers (softmax routing in
float32, greedy top-k, shared experts). The JAX package has no counterpart.

A token caches one row a layer: ``kv_a_layernorm(c_kv)`` (kv_lora_rank
values) followed by the roped ``k_pe`` (qk_rope_head_dim values), quantized
and encoded as one K row of a single "head" (``ModelConfig.head_dim`` is
its width). Prefill reads it back in the published, non-absorbed form: the
latent decompressed through ``kv_b_proj`` into every head's K (nope, then
the shared k_pe) and V. Decode reads it absorbed: q_nope . W_UK (``absorb``)
scores the latent directly, the read returns each head's latent output,
and ``W_UV`` then ``o_proj`` follow (``attn_out_mlp``).

The parameter layout (applied as x @ W): ``embed`` [V, E], ``final_norm``
[E], ``lm_head`` [E, V], and ``layers``, a list of dicts with
``input_norm``, ``post_attn_norm`` [E], ``q_proj`` [E, H (nope + rope)],
``kv_a_proj`` [E, kv_lora + rope], ``kv_a_norm`` [kv_lora], ``kv_b_proj``
[kv_lora, H (nope + v)] (head h's W_UK then W_UV in columns h (nope + v)
on), ``o_proj`` [H v, E]; a dense layer ``gate_proj``, ``up_proj`` [E, I],
``down_proj`` [I, E]; an MoE layer ``router`` [E, n_experts],
``experts_gate``, ``experts_up`` [n_experts, E, I_moe], ``experts_down``
[n_experts, I_moe, E] and the shared experts as one SwiGLU of width
n_shared I_moe (``shared_gate``, ``shared_up``, ``shared_down``).

The expert layer sorts the token-expert pairs once and runs each of its
three products over all experts as one grouped product
(kernels/grouped.py): three launches a layer whatever the expert count, and
no host sync. While tracing is on it counts the tokens each expert takes,
on the device (``tracing.count``: "<phase>.moe_tokens.<layer>").
"""

from __future__ import annotations

import functools

import torch

from .. import tracing
from ..kernels.grouped import grouped_mm
from .config import ModelConfig
from .kv_policy import KVCachePolicy, kv_roundtrip, merge_stats, stream_seed, write_inject
from .layers import apply_rope, causal_attention, rms_norm, rope_frequencies, yarn_mscale

# queries of prefill's attention scored at once (scores [H, chunk, S] float32)
PREFILL_QUERY_CHUNK = 1024


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=None) -> dict:
    """Random weights N(0, 0.02) drawn on the generator's device, norms at
    1. ``dtype`` defaults to float32."""
    device = generator.device
    dtype = dtype or torch.float32
    E, V, I, H = cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size, cfg.num_heads
    nope, rope, vd, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    n, Im = cfg.n_routed_experts, cfg.moe_intermediate_size
    Is = Im * cfg.n_shared_experts

    def normal(shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def ones(k):
        return torch.ones(k, device=device, dtype=dtype)

    params = {"embed": normal((V, E)), "final_norm": ones(E), "lm_head": normal((E, V)),
              "layers": []}
    for i in range(cfg.num_layers):
        lp = {"input_norm": ones(E), "post_attn_norm": ones(E), "kv_a_norm": ones(r),
              "q_proj": normal((E, H * (nope + rope))), "kv_a_proj": normal((E, r + rope)),
              "kv_b_proj": normal((r, H * (nope + vd))), "o_proj": normal((H * vd, E))}
        if is_moe_layer(cfg, i):
            lp.update(router=normal((E, n)), experts_gate=normal((n, E, Im)),
                      experts_up=normal((n, E, Im)), experts_down=normal((n, Im, E)),
                      shared_gate=normal((E, Is)), shared_up=normal((E, Is)),
                      shared_down=normal((Is, E)))
        else:
            lp.update(gate_proj=normal((E, I)), up_proj=normal((E, I)), down_proj=normal((I, E)))
        params["layers"].append(lp)
    return params


def is_moe_layer(cfg: ModelConfig, layer: int) -> bool:
    return cfg.n_routed_experts > 0 and layer >= cfg.first_k_dense_replace


def inv_freq(cfg: ModelConfig, device):
    """The rope dims' frequencies, YaRN-scaled when the config has a factor;
    made once a (config, device), so that a decode step copies nothing from
    the host."""
    return _inv_freq(cfg, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _inv_freq(cfg: ModelConfig, device: str):
    yarn = None
    if cfg.yarn_factor:
        yarn = (cfg.yarn_factor, cfg.yarn_original_max_position, cfg.yarn_beta_fast,
                cfg.yarn_beta_slow)
    return rope_frequencies(cfg.qk_rope_head_dim, cfg.rope_theta, device=device, yarn=yarn)


def softmax_scale(cfg: ModelConfig) -> float:
    """(nope + rope)^-0.5, times YaRN's mscale(factor, mscale_all_dim)
    squared: 192^-0.5 (0.1 * 0.707 * ln 40 + 1)^2 = 0.1147 for the Lite."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def _rope_mscale(cfg: ModelConfig) -> float:
    """YaRN's factor on cos and sin: mscale(mscale) / mscale(mscale_all_dim)."""
    if not cfg.yarn_factor:
        return 1.0
    return (yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
            / yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim))


def rope(x, positions, freqs, cfg: ModelConfig):
    """The published apply_rotary_pos_emb on x [B, S, h, rope]: its values
    de-interleaved (x0, x2, ..., x1, x3, ...), then rotated in rotate-half
    pairs."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    out = apply_rope(x, positions, freqs)
    m = _rope_mscale(cfg)
    return out if m == 1.0 else (out.to(torch.float32) * m).to(x.dtype)


def embed(params, input_ids, cfg: ModelConfig, positions=None):
    return params["embed"][input_ids].to(cfg.torch_dtype)


def qkv(x, lp, cfg: ModelConfig, positions, freqs):
    """input_norm, q_proj and kv_a_proj, kv_a_layernorm, RoPE on q_pe and
    k_pe at positions [B, S]: (q [B, S, H, nope + rope], the cache row
    [B, S, 1, kv_lora + rope])."""
    B, S, _ = x.shape
    H, nope, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
    q = (h @ lp["q_proj"]).reshape(B, S, H, nope + cfg.qk_rope_head_dim)
    ckv = h @ lp["kv_a_proj"]
    c = rms_norm(ckv[..., :r], lp["kv_a_norm"], cfg.rms_norm_eps)
    q_pe = rope(q[..., nope:], positions, freqs, cfg)
    k_pe = rope(ckv[..., None, r:], positions, freqs, cfg)
    return torch.cat([q[..., :nope], q_pe], -1), torch.cat([c[:, :, None], k_pe], -1)


def _kv_b(lp, cfg: ModelConfig):
    """kv_b_proj as [kv_lora, H, nope + v]."""
    return lp["kv_b_proj"].view(cfg.kv_lora_rank, cfg.num_heads,
                                cfg.qk_nope_head_dim + cfg.v_head_dim)


def absorb(q, lp, cfg: ModelConfig):
    """A decode step's query [B, 1, H, nope + rope] -> [B, H, kv_lora +
    rope]: q_nope . W_UK (each head's nope part taken to the latent), then
    q_pe. Its product with a cache row is q . k of the non-absorbed form."""
    nope = cfg.qk_nope_head_dim
    w_uk = _kv_b(lp, cfg)[:, :, :nope].permute(1, 2, 0)  # [H, nope, kv_lora]
    q_lat = torch.matmul(q[:, 0, :, :nope].transpose(0, 1), w_uk)  # [H, B, kv_lora]
    return torch.cat([q_lat.transpose(0, 1), q[:, 0, :, nope:]], -1)


def prefill_attention(q, rows, lp, cfg: ModelConfig):
    """The non-absorbed form over the rows read back: q [B, S, H, nope +
    rope], rows [B, S, 1, kv_lora + rope] -> [B, S, H, v]. The latent goes
    through kv_b_proj into each head's k_nope and v; k_pe is every head's.
    Causal, with the softmax scale of ``softmax_scale``, in chunks of
    queries."""
    B, S, H, _ = q.shape
    nope, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    kv = (rows[:, :, 0, :r] @ lp["kv_b_proj"]).reshape(B, S, H, nope + cfg.v_head_dim)
    k_pe = rows[:, :, :, r:].expand(B, S, H, cfg.qk_rope_head_dim)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    v = kv[..., nope:]
    scale = softmax_scale(cfg)
    outs = []
    for start in range(0, S, PREFILL_QUERY_CHUNK):
        end = min(S, start + PREFILL_QUERY_CHUNK)
        outs.append(causal_attention(q[:, start:end], k[:, :end], v[:, :end], 1,
                                     kv_offset=start, scale=scale))
    return torch.cat(outs, dim=1)


def _swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate) * (x @ up)) @ down


def moe(h, lp, cfg: ModelConfig, phase: str, layer: int):
    """The expert layer on normed h [B, S, E]: the router's logits and
    softmax in float32 over every expert, the top num_experts_per_tok
    (weights normalised when norm_topk_prob, else times
    routed_scaling_factor), the routed experts' SwiGLU as three grouped
    products over the sorted token-expert pairs, their weighted sum in
    float32, and the shared experts added."""
    B, S, E = h.shape
    k, n = cfg.num_experts_per_tok, cfg.n_routed_experts
    x = h.reshape(B * S, E)
    with tracing.span(f"{phase}.moe_route"):
        scores = torch.softmax(x.to(torch.float32) @ lp["router"].to(torch.float32), dim=-1)
        weight, idx = torch.topk(scores, k, dim=-1)
        if cfg.norm_topk_prob:
            weight = weight / weight.sum(-1, keepdim=True)
        else:
            weight = weight * cfg.routed_scaling_factor
        flat = idx.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.zeros(n, dtype=torch.int32, device=x.device).scatter_add_(
            0, flat, torch.ones_like(flat, dtype=torch.int32))
        offs = torch.cumsum(counts, 0, dtype=torch.int32)
        xs = x[order // k]
        tracing.count(f"{phase}.moe_tokens.{layer}", counts)
    with tracing.span(f"{phase}.moe_experts"):
        a = torch.nn.functional.silu(grouped_mm(xs, lp["experts_gate"], offs)) \
            * grouped_mm(xs, lp["experts_up"], offs)
        ys = torch.empty_like(xs).index_copy_(0, order, grouped_mm(a, lp["experts_down"], offs))
        routed = (ys.view(B * S, k, E).to(torch.float32) * weight[..., None]).sum(1).to(x.dtype)
    with tracing.span(f"{phase}.moe_shared"):
        out = routed + _swiglu(x, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    return out.reshape(B, S, E)


def attn_out_mlp(x, attn, lp, cfg: ModelConfig, phase: str, layer: int, latent: bool = False):
    """o_proj and its residual, post_attn_norm, the dense MLP (layer 0) or
    the expert layer (``moe``), and its residual. ``attn``: [B, S, H, v],
    or with ``latent`` each head's latent output [B, S, H, kv_lora], taken
    through W_UV first. Opens its own leaf spans: ``<phase>.out_mlp``
    around W_UV, o_proj, the norm and a dense MLP, then the expert layer's."""
    B, S = x.shape[:2]
    with tracing.span(f"{phase}.out_mlp"):
        if latent:
            w_uv = _kv_b(lp, cfg)[:, :, cfg.qk_nope_head_dim:].permute(1, 0, 2)  # [H, r, v]
            o = torch.matmul(attn.reshape(B * S, cfg.num_heads, -1).transpose(0, 1), w_uv)
            attn = o.transpose(0, 1)
        x = x + attn.reshape(B, S, cfg.num_heads * cfg.v_head_dim) @ lp["o_proj"]
        h = rms_norm(x, lp["post_attn_norm"], cfg.rms_norm_eps)
        if not is_moe_layer(cfg, layer):
            return x + _swiglu(h, lp["gate_proj"], lp["up_proj"], lp["down_proj"])
    return x + moe(h, lp, cfg, phase, layer)


def lm_head(params, x, cfg: ModelConfig):
    """final_norm and the untied head, float32 logits."""
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return (x @ params["lm_head"].to(x.dtype)).to(torch.float32)


def forward(params, input_ids, cfg: ModelConfig, policy: KVCachePolicy, *, write_masks=None,
            read_masks=None):
    """input_ids [B, S] -> (logits [B, S, V] float32, stats): each layer's
    cache row through the policy's codec round trip (kv_policy.kv_roundtrip)
    and attended in the non-absorbed form. write_masks: [L, 1, ...] per
    layer, or None to draw them from a generator seeded by (policy.seed,
    layer, 0). Read-time injection (mode int4) is not ported here."""
    if read_masks is not None:
        raise NotImplementedError(f"architecture '{cfg.arch}': read-time injection")
    B, S = input_ids.shape
    positions = torch.arange(S, device=input_ids.device).expand(B, S)
    freqs = inv_freq(cfg, input_ids.device)
    x = embed(params, input_ids, cfg)
    stats = None
    for i, lp in enumerate(params["layers"]):
        q, row = qkv(x, lp, cfg, positions, freqs)
        gen = None
        if write_inject(policy) and write_masks is None:
            gen = torch.Generator(device=x.device).manual_seed(stream_seed(policy.seed, i, 0))
        row, s = kv_roundtrip(row, policy, gen,
                              mask=None if write_masks is None else write_masks[i, 0])
        stats = merge_stats(stats, s)
        x = attn_out_mlp(x, prefill_attention(q, row.to(x.dtype), lp, cfg), lp, cfg, "forward", i)
    return lm_head(params, x, cfg), stats
