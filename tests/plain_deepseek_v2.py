"""Plain DeepSeek-V2 (Lite) forward pass over a whole sequence, in float32,
in the published (non-absorbed) form of DeepseekV2Attention (q_lora_rank
null) and DeepseekV2MoE. Plain torch; imports neither JAX nor the port.

Per layer: RMSNorm; q = h @ q_proj, split into q_nope and q_pe; [c_kv,
k_pe] = h @ kv_a_proj; the cache row is [kv_a_layernorm(c_kv), rope(k_pe)]
(``roundtrip(layer, rows)`` takes it through a given round trip, the
protected cache's, and returns what is read); k_nope and v from the read
latent through kv_b_proj, k_pe shared by the heads; causal softmax(q k^T *
scale) v; o_proj and its residual; RMSNorm and a dense SwiGLU (layers below
first_k_dense_replace) or the expert layer: router logits and softmax in
float32, greedy top-k, weights times routed_scaling_factor (normalised when
norm_topk_prob), each routed expert's SwiGLU weighted and summed, the shared
experts added; its residual. A final RMSNorm and the LM head.

RoPE is YaRN's: frequencies from the correction range of beta_fast and
beta_slow blended by a linear ramp, cos and sin times mscale(mscale) /
mscale(mscale_all_dim), applied after de-interleaving (x0, x2, ..., x1, x3,
...) in rotate-half pairs; the softmax scale (nope + rope)^-0.5 times
mscale(factor, mscale_all_dim)^2. Departures: angles in float64, every
product in float32, the experts run one by one over the tokens routed to
them (the published moe_infer does the same).

``sizes`` holds the published config's keys (hidden_size,
num_attention_heads, kv_lora_rank, qk_nope_head_dim, qk_rope_head_dim,
v_head_dim, first_k_dense_replace, n_routed_experts, num_experts_per_tok,
norm_topk_prob, routed_scaling_factor, rope_theta, rms_norm_eps and
rope_scaling); ``weights`` are in the port's layout (applied as x @ W).
"""

from __future__ import annotations

import math

import torch


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, factor: float, original: int, beta_fast: float,
                  beta_slow: float) -> torch.Tensor:
    """[dim / 2] float64 YaRN frequencies."""
    base = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)

    def dim_of(rot):
        return dim * math.log(original / (rot * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(dim_of(beta_fast)), 0)
    high = min(math.ceil(dim_of(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    return base / factor * ramp + base * (1 - ramp)


def softmax_scale(sizes: dict) -> float:
    scale = (sizes["qk_nope_head_dim"] + sizes["qk_rope_head_dim"]) ** -0.5
    ys = sizes["rope_scaling"]
    return scale * mscale(ys["factor"], ys["mscale_all_dim"]) ** 2


def _norm(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g.float()


def _rope(x, positions, sizes):
    """x [B, S, h, d] de-interleaved, then rotated at positions [S]."""
    d = x.shape[-1]
    ys = sizes["rope_scaling"]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).reshape(x.shape)
    inv = yarn_inv_freq(d, float(sizes["rope_theta"]), ys["factor"],
                        ys["original_max_position_embeddings"], ys["beta_fast"], ys["beta_slow"])
    m = mscale(ys["factor"], ys["mscale"]) / mscale(ys["factor"], ys["mscale_all_dim"])
    ang = positions.to(torch.float64)[:, None] * inv[None, :]
    cos = (ang.cos() * m).float()[:, None, :]
    sin = (ang.sin() * m).float()[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _swiglu(x, gate, up, down):
    return (torch.nn.functional.silu(x @ gate.float()) * (x @ up.float())) @ down.float()


def _moe(h, lp, sizes):
    k = sizes["num_experts_per_tok"]
    scores = torch.softmax(h @ lp["router"].float(), dim=-1)
    weight, idx = torch.topk(scores, k, dim=-1)
    if sizes["norm_topk_prob"]:
        weight = weight / weight.sum(-1, keepdim=True)
    else:
        weight = weight * sizes["routed_scaling_factor"]
    out = torch.zeros_like(h)
    for e in range(sizes["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(h[tok], lp["experts_gate"][e], lp["experts_up"][e], lp["experts_down"][e])
            out[tok] += y * weight[tok, slot][:, None]
    return out + _swiglu(h, lp["shared_gate"], lp["shared_up"], lp["shared_down"])


@torch.no_grad()
def forward(weights: dict, sizes: dict, ids: torch.Tensor, roundtrip=None) -> torch.Tensor:
    """ids [B, S] -> logits [B, S, V] float32. roundtrip(layer, rows [B, S,
    kv_lora + rope]) -> the rows as read back, or None for none."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S = ids.shape
    H, eps = sizes["num_attention_heads"], sizes["rms_norm_eps"]
    nope, rope_d = sizes["qk_nope_head_dim"], sizes["qk_rope_head_dim"]
    vd, r = sizes["v_head_dim"], sizes["kv_lora_rank"]
    pos = torch.arange(S)
    scale = softmax_scale(sizes)
    causal = pos[None, :] <= pos[:, None]
    x = weights["embed"][ids].float()
    for i, lp in enumerate(weights["layers"]):
        h = _norm(x, lp["input_norm"], eps)
        q = (h @ lp["q_proj"].float()).reshape(B, S, H, nope + rope_d)
        ckv = h @ lp["kv_a_proj"].float()
        rows = torch.cat([_norm(ckv[..., :r], lp["kv_a_norm"], eps),
                          _rope(ckv[..., None, r:], pos, sizes)[:, :, 0]], -1)
        if roundtrip is not None:
            rows = roundtrip(i, rows)
        kv = (rows[..., :r] @ lp["kv_b_proj"].float()).reshape(B, S, H, nope + vd)
        k = torch.cat([kv[..., :nope], rows[:, :, None, r:].expand(B, S, H, rope_d)], -1)
        q = torch.cat([q[..., :nope], _rope(q[..., nope:], pos, sizes)], -1)
        s = torch.einsum("bshd,bthd->bhst", q, k) * scale
        s = torch.where(causal, s, torch.full_like(s, -math.inf))
        attn = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), kv[..., nope:])
        x = x + attn.reshape(B, S, H * vd) @ lp["o_proj"].float()
        h = _norm(x, lp["post_attn_norm"], eps)
        if i < sizes["first_k_dense_replace"]:
            x = x + _swiglu(h, lp["gate_proj"], lp["up_proj"], lp["down_proj"])
        else:
            x = x + _moe(h.reshape(B * S, -1), lp, sizes).reshape(B, S, -1)
    return _norm(x, weights["final_norm"], eps) @ weights["lm_head"].float()
