"""Plain DeepSeek-V2 (Lite) decoder in float32, from the published config
and modeling code (DeepseekV2Attention with q_lora_rank null, DeepseekV2MoE).

Pre-norm blocks: RMSNorm, q_proj and kv_a_proj_with_mqa, kv_a_layernorm of
the latent, YaRN RoPE on q_pe and k_pe (each de-interleaved first, then the
rotate-half pairing, angles in float64), latent attention (done by the
caller over the protected cache: the row a token stores is the normed
latent, then the roped k_pe), o_proj with its residual, RMSNorm and the
MLP with its residual: a dense SwiGLU in the first
``first_k_dense_replace`` layers, then the expert layer (router logits and
softmax in float32, greedy top-k, weights times routed_scaling_factor or
normalised when norm_topk_prob, each routed expert a SwiGLU, the shared
experts one SwiGLU of n_shared widths); a final RMSNorm and the LM head.

``attend`` is the published, non-absorbed form: the latent read back
decompressed through kv_b_proj into each head's k_nope and v, k_pe shared
by every head, scores times 192^-0.5 mscale(40, 0.707)^2. Weights are the
tensors the benchmark made, in the port's layout (``embed`` [V, E],
``lm_head`` [E, V], per layer ``q_proj`` [E, H (nope + rope)], ``kv_a_proj``
[E, kv_lora + rope], ``kv_b_proj`` [kv_lora, H (nope + v)], ``o_proj``,
``router`` [E, n], ``experts_gate`` / ``experts_up`` [n, E, I],
``experts_down`` [n, I, E], ``shared_*``; applied as x @ W), widened to
float32 here. Departures from the published code: the experts run per
expert over the tokens routed to it (the published moe_infer too), in
float32 throughout; the angles in float64.
"""

from __future__ import annotations

import math

import torch

QUERY_CHUNK = 2048  # queries scored at once in ``attend``


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


class Model:
    def __init__(self, config: dict, weights: dict, rnd):
        self.E = config["hidden_size"]
        self.H = config["num_attention_heads"]
        self.L = config["num_hidden_layers"]
        self.eps = config["rms_norm_eps"]
        self.nope, self.rope = config["qk_nope_head_dim"], config["qk_rope_head_dim"]
        self.vd, self.r = config["v_head_dim"], config["kv_lora_rank"]
        self.first_dense = config["first_k_dense_replace"]
        self.n_exp, self.k = config["n_routed_experts"], config["num_experts_per_tok"]
        self.norm_topk = bool(config["norm_topk_prob"])
        self.route_scale = float(config["routed_scaling_factor"])
        self.theta = float(config["rope_theta"])
        ys = config.get("rope_scaling") or {}
        self.yarn = ys if ys.get("type") == "yarn" else None
        self.scale = (self.nope + self.rope) ** -0.5
        self.rope_m = 1.0
        if self.yarn:
            f = float(ys["factor"])
            if ys.get("mscale_all_dim"):
                self.scale *= _mscale(f, ys["mscale_all_dim"]) ** 2
            self.rope_m = _mscale(f, ys.get("mscale", 1)) / _mscale(f, ys.get("mscale_all_dim", 0))
        self.w = weights
        self.rnd = rnd  # rounds both operands of every product (the control)

    def _mm(self, a, w):
        return self.rnd(a) @ self.rnd(w.to(torch.float32))

    def _norm(self, x, g):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * g.to(torch.float32)

    def cache(self, layer):
        """One row a token: the normed latent, then the roped k_pe, read as
        both K and (its latent) V."""
        return [("kv", 1, self.r + self.rope)]

    def window(self, layer):
        """Every layer attends the whole context."""
        return None

    def embed(self, tokens, positions):
        return self.w["embed"][tokens].to(torch.float32)

    def _inv_freq(self, device):
        d = self.rope
        base = 1.0 / self.theta ** (torch.arange(0, d, 2, dtype=torch.float64, device=device) / d)
        if not self.yarn:
            return base
        ys = self.yarn
        orig = ys["original_max_position_embeddings"]

        def dim_of(rot):
            return d * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(self.theta))

        low = max(math.floor(dim_of(ys["beta_fast"])), 0)
        high = min(math.ceil(dim_of(ys["beta_slow"])), d - 1)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(d // 2, dtype=torch.float64, device=device) - low)
                / (high - low)).clamp(0, 1)
        return base / ys["factor"] * ramp + base * (1 - ramp)

    def _rope(self, x, positions):
        """x [T, h, rope]: de-interleaved, then rotated in rotate-half pairs."""
        T, h, d = x.shape
        x = x.reshape(T, h, d // 2, 2).transpose(-1, -2).reshape(T, h, d)
        ang = positions.to(torch.float64)[:, None] * self._inv_freq(x.device)[None, :]
        cos = (ang.cos() * self.rope_m).to(torch.float32)[:, None, :]
        sin = (ang.sin() * self.rope_m).to(torch.float32)[:, None, :]
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def qkv(self, layer, x, positions):
        lp = self.w["layers"][layer]
        T = x.shape[0]
        h = self._norm(x, lp["input_norm"])
        q = self._mm(h, lp["q_proj"]).reshape(T, self.H, self.nope + self.rope)
        ckv = self._mm(h, lp["kv_a_proj"])
        c = self._norm(ckv[:, : self.r], lp["kv_a_norm"])
        k_pe = self._rope(ckv[:, None, self.r:], positions)
        q = torch.cat([q[..., : self.nope], self._rope(q[..., self.nope:], positions)], -1)
        return q, torch.cat([c[:, None], k_pe], -1)

    def attend(self, layer, q, kv, mask, rnd, edge=None):
        """q [Tq, H, nope + rope] over the rows read back kv [Tk, 1, r +
        rope], mask [Tq, Tk]: each head's K (k_nope from the latent through
        kv_b_proj, then k_pe) and V (from the latent). Returns [Tq, H v]."""
        if edge is not None:
            raise ValueError("no interpolation edge in the latent reference")
        lp = self.w["layers"][layer]
        Tk = kv.shape[0]
        dec = self._mm(kv[:, 0, : self.r], lp["kv_b_proj"]).reshape(Tk, self.H, self.nope + self.vd)
        k = torch.cat([dec[..., : self.nope],
                       kv[:, :, self.r:].expand(Tk, self.H, self.rope)], -1).permute(1, 0, 2)
        v = rnd(dec[..., self.nope:].permute(1, 0, 2))  # [H, Tk, v]
        k = rnd(k)
        outs = []
        for s in range(0, q.shape[0], QUERY_CHUNK):
            qh = rnd(q[s:s + QUERY_CHUNK].permute(1, 0, 2))  # [H, tq, 192]
            sc = qh @ k.transpose(-1, -2) * self.scale
            sc = torch.where(mask[s:s + QUERY_CHUNK], sc, torch.full_like(sc, -math.inf))
            p = torch.softmax(sc, dim=-1)
            outs.append((rnd(p) @ v).permute(1, 0, 2).reshape(-1, self.H * self.vd))
        return torch.cat(outs)

    def _swiglu(self, x, gate, up, down):
        return self._mm(torch.nn.functional.silu(self._mm(x, gate)) * self._mm(x, up), down)

    def _moe(self, lp, h):
        scores = torch.softmax(self._mm(h, lp["router"]), dim=-1)
        weight, idx = torch.topk(scores, self.k, dim=-1)
        if self.norm_topk:
            weight = weight / weight.sum(-1, keepdim=True)
        else:
            weight = weight * self.route_scale
        routed = torch.zeros(h.shape[0], self.k, self.E, device=h.device)  # [T, k, E]
        for e in range(self.n_exp):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            y = self._swiglu(h[tok], lp["experts_gate"][e], lp["experts_up"][e],
                             lp["experts_down"][e])
            routed[tok, slot] = y * weight[tok, slot][:, None]
        return routed.sum(1) + self._swiglu(h, lp["shared_gate"], lp["shared_up"],
                                            lp["shared_down"])

    def post(self, layer, x, attn):
        lp = self.w["layers"][layer]
        x = x + self._mm(attn, lp["o_proj"])
        h = self._norm(x, lp["post_attn_norm"])
        if layer < self.first_dense:
            return x + self._swiglu(h, lp["gate_proj"], lp["up_proj"], lp["down_proj"])
        return x + self._moe(lp, h)

    def logits(self, x):
        return self._mm(self._norm(x, self.w["final_norm"]), self.w["lm_head"])
