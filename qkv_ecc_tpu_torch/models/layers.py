"""Model building blocks (counterpart of ``qkv_ecc_tpu/models/layers.py``,
llama part): RMSNorm, rotary embeddings with Llama-3.1 scaling, causal GQA
attention with an optional sliding window. Large products are plain
``torch.matmul``."""

from __future__ import annotations

import numpy as np
import torch


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def _llama3_freq_scaling(inv_freq: np.ndarray) -> np.ndarray:
    """Llama-3.1 NTK-by-parts rope scaling (factor 8, low 1, high 4,
    original context 8192)."""
    factor = 8.0
    low_freq_factor = 1.0
    high_freq_factor = 4.0
    old_context_len = 8192.0
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2 * np.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (old_context_len / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1 - smooth) * inv_freq / factor + smooth * inv_freq
    is_medium = (wavelen <= low_freq_wavelen) & (wavelen >= high_freq_wavelen)
    return np.where(is_medium, smoothed, scaled)


def rope_frequencies(head_dim: int, theta: float, llama3_scaling: bool = False,
                     device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] float32, computed in float64 on the
    host as the JAX package does."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if llama3_scaling:
        inv_freq = _llama3_freq_scaling(inv_freq)
    return torch.tensor(inv_freq.astype(np.float32), device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate [B, S, H, D] by position, HF 'rotate_half' convention: pairs
    are (x[..., :D/2], x[..., D/2:])."""
    angles = positions[..., None].to(torch.float32) * inv_freq  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def causal_attention(q, k, v, num_kv_groups: int, *, kv_offset: int = 0,
                     sliding_window=None):
    """Grouped-query causal attention with a float32 softmax.

    q: [B, S, Hq, D]; k, v: [B, T, Hkv, D]; the last S query positions align
    with the last S of T context positions. With sliding_window W, query
    position p attends to context positions j with p - W < j <= p.
    Returns [B, S, Hq, D]."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, num_kv_groups, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k).to(torch.float32) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32))
    qi = torch.arange(S, device=q.device)[:, None]
    tj = torch.arange(T, device=q.device)[None, :]
    mask = tj <= qi + kv_offset
    if sliding_window is not None:
        mask = mask & (tj > qi + kv_offset - sliding_window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(B, S, Hq, D)
