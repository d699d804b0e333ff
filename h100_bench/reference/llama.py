"""Plain Mistral / Llama decoder in float32, from the published config.

Pre-norm blocks: RMSNorm, q/k/v projections, rotary embedding (the
rotate-half pairing, angles in float64), grouped-query attention (done by
the caller, over the protected cache), o projection with its residual,
RMSNorm and the SwiGLU MLP with its residual; a final RMSNorm and the LM
head. Weights are the tensors the benchmark made, in the port's layout
(``embed`` [V, E], ``lm_head`` [E, V], per layer ``q_proj`` [E, H*D] and so
on, applied as x @ W), widened to float32 here. No sliding window: the
configurations benchmarked have none.
"""

from __future__ import annotations

import torch


class Model:
    def __init__(self, config: dict, weights: dict, rnd):
        self.E = config["hidden_size"]
        self.H = config["num_attention_heads"]
        self.Hkv = config["num_key_value_heads"]
        self.D = config.get("head_dim") or self.E // self.H
        self.L = config["num_hidden_layers"]
        self.eps = config["rms_norm_eps"]
        self.theta = float(config["rope_theta"])
        self.tied = bool(config.get("tie_word_embeddings", False))
        if config.get("sliding_window"):
            raise ValueError("the reference has no sliding window")
        self.w = weights
        self.rnd = rnd  # rounds both operands of every product (the control)

    def _mm(self, a, w):
        return self.rnd(a) @ self.rnd(w.to(torch.float32))

    def _norm(self, x, g):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * g.to(torch.float32)

    def cache(self, layer):
        """The rows a token stores in ``layer``'s cache, (kind, count,
        width): a K and a V row of every KV head."""
        return [("k", self.Hkv, self.D), ("v", self.Hkv, self.D)]

    def window(self, layer):
        """Every layer attends the whole context."""
        return None

    def embed(self, tokens, positions):
        return self.w["embed"][tokens].to(torch.float32)

    def _rope(self, x, positions):
        half = self.D // 2
        inv = 1.0 / self.theta ** (torch.arange(0, self.D, 2, dtype=torch.float64,
                                                device=x.device) / self.D)
        ang = positions.to(torch.float64)[:, None] * inv[None, :]
        cos, sin = ang.cos().to(torch.float32)[:, None, :], ang.sin().to(torch.float32)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def qkv(self, layer, x, positions):
        lp = self.w["layers"][layer]
        T = x.shape[0]
        h = self._norm(x, lp["input_norm"])
        q = self._mm(h, lp["q_proj"]).reshape(T, self.H, self.D)
        k = self._mm(h, lp["k_proj"]).reshape(T, self.Hkv, self.D)
        v = self._mm(h, lp["v_proj"]).reshape(T, self.Hkv, self.D)
        return self._rope(q, positions), self._rope(k, positions), v

    def post(self, layer, x, attn):
        lp = self.w["layers"][layer]
        x = x + self._mm(attn, lp["o_proj"])
        h = self._norm(x, lp["post_attn_norm"])
        h = torch.nn.functional.silu(self._mm(h, lp["gate_proj"])) * self._mm(h, lp["up_proj"])
        return x + self._mm(h, lp["down_proj"])

    def logits(self, x):
        h = self._norm(x, self.w["final_norm"])
        head = self.w["embed"].T if self.tied else self.w["lm_head"]
        return self._mm(h, head)
