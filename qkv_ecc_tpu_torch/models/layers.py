"""Model building blocks (counterpart of ``qkv_ecc_tpu/models/layers.py``):
LayerNorm, RMSNorm, rotary embeddings with Llama-3.1 or YaRN scaling,
causal GQA attention with an optional sliding window, a softmax scale and a
V width of its own. Large products are plain ``torch.matmul``."""

from __future__ import annotations

import numpy as np
import torch


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * g + b over the last axis, the
    population variance, in x's dtype (as jnp.var)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


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


def _yarn_correction_dim(rotations: float, dim: int, theta: float, max_pos: int) -> float:
    """The dimension index whose wavelength turns ``rotations`` times over
    ``max_pos`` positions."""
    return dim * np.log(max_pos / (rotations * 2 * np.pi)) / (2 * np.log(theta))


def _yarn_freq_scaling(inv_freq: np.ndarray, theta: float, factor: float, original_max: int,
                       beta_fast: float, beta_slow: float) -> np.ndarray:
    """YaRN's frequencies (DeepSeek-V2's DeepseekV2YarnRotaryEmbedding):
    the pairs below the correction range [floor(dim at beta_fast rotations),
    ceil(dim at beta_slow)] keep their frequency, those above it are divided
    by ``factor``, and a linear ramp over the range blends the two."""
    dim = 2 * inv_freq.shape[0]
    low = max(int(np.floor(_yarn_correction_dim(beta_fast, dim, theta, original_max))), 0)
    high = min(int(np.ceil(_yarn_correction_dim(beta_slow, dim, theta, original_max))), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
    keep = 1.0 - ramp
    return inv_freq / factor * (1.0 - keep) + inv_freq * keep


def yarn_mscale(factor: float, mscale: float) -> float:
    """0.1 * mscale * ln(factor) + 1 (1 at factor <= 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * float(np.log(factor)) + 1.0


def rope_frequencies(head_dim: int, theta: float, llama3_scaling: bool = False,
                     device=None, yarn=None) -> torch.Tensor:
    """Inverse frequencies [head_dim/2] float32, computed in float64 on the
    host as the JAX package does. ``yarn``: (factor, original context,
    beta_fast, beta_slow) for YaRN's frequencies."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if llama3_scaling:
        inv_freq = _llama3_freq_scaling(inv_freq)
    if yarn is not None:
        inv_freq = _yarn_freq_scaling(inv_freq, theta, *yarn)
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
                     sliding_window=None, scale=None):
    """Grouped-query causal attention with a float32 softmax.

    q: [B, S, Hq, D]; k: [B, T, Hkv, D]; v: [B, T, Hkv, Dv]; the last S
    query positions align with the last S of T context positions. With
    sliding_window W, query position p attends to context positions j with
    p - W < j <= p. The scores are divided by sqrt(D), or multiplied by
    ``scale`` when given. Returns [B, S, Hq, Dv]."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, num_kv_groups, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k).to(torch.float32)
    if scale is None:
        s = s / torch.sqrt(torch.tensor(float(D), dtype=torch.float32))
    else:
        s = s * scale
    qi = torch.arange(S, device=q.device)[:, None]
    tj = torch.arange(T, device=q.device)[None, :]
    mask = tj <= qi + kv_offset
    if sliding_window is not None:
        mask = mask & (tj > qi + kv_offset - sliding_window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(B, S, Hq, v.shape[-1])
