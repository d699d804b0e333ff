"""Plain GPT-2 in float32, from the published config.

Pre-LayerNorm blocks: LayerNorm, the combined q/k/v projection with its
bias, attention (done by the caller, over the protected cache), the output
projection with its residual, LayerNorm and the tanh-GELU MLP with its
residual; a final LayerNorm and the head tied to the token embedding.
Learned absolute positions. Weights are the tensors the benchmark made, in
the port's layout (``wte`` [V, E], ``wpe`` [P, E], per layer ``c_attn``
{"w" [E, 3E], "b"} and so on, applied as x @ w + b).
"""

from __future__ import annotations

import torch


class Model:
    def __init__(self, config: dict, weights: dict, rnd):
        self.E = config["n_embd"]
        self.H = self.Hkv = config["n_head"]
        self.D = self.E // self.H
        self.L = config["n_layer"]
        self.eps = config["layer_norm_epsilon"]
        self.w = weights
        self.rnd = rnd

    def _lin(self, a, p):
        return self.rnd(a) @ self.rnd(p["w"].to(torch.float32)) + p["b"].to(torch.float32)

    def _norm(self, x, p):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * p["g"].to(torch.float32) + \
            p["b"].to(torch.float32)

    def cache(self, layer):
        """The rows a token stores in ``layer``'s cache, (kind, count,
        width): a K and a V row of every KV head."""
        return [("k", self.Hkv, self.D), ("v", self.Hkv, self.D)]

    def window(self, layer):
        """Every layer attends the whole context."""
        return None

    def embed(self, tokens, positions):
        return (self.w["wte"][tokens].to(torch.float32)
                + self.w["wpe"][positions].to(torch.float32))

    def qkv(self, layer, x, positions):
        lp = self.w["layers"][layer]
        T = x.shape[0]
        q, k, v = self._lin(self._norm(x, lp["ln_1"]), lp["c_attn"]).chunk(3, dim=-1)
        return (q.reshape(T, self.H, self.D), k.reshape(T, self.Hkv, self.D),
                v.reshape(T, self.Hkv, self.D))

    def post(self, layer, x, attn):
        lp = self.w["layers"][layer]
        x = x + self._lin(attn, lp["c_proj"])
        h = torch.nn.functional.gelu(self._lin(self._norm(x, lp["ln_2"]), lp["c_fc"]),
                                     approximate="tanh")
        return x + self._lin(h, lp["mlp_proj"])

    def logits(self, x):
        h = self._norm(x, self.w["ln_f"])
        return self.rnd(h) @ self.rnd(self.w["wte"].to(torch.float32)).T
