"""Fused quantize+encode and decode+dequantize chains (counterpart of
``qkv_ecc_tpu/codecs/fused.py``), as torch functions on the caller's
device.

Semantics (the JAX module's):
    - fused_quantize_encode_*: per-row absmax -> scale = absmax/7 ->
      q = round(x/scale) + 8 clamped to [0,15] -> Hamming encode. Zero rows
      get scale 1.0.
    - fused_decode_dequantize_hamming84: SECDED decode -> (q - 8) * scale.
      Like the reference's fused kernel, double errors are ZEROED here
      (q = 0, so the value dequantizes to -8 * scale); the standalone
      decoder preserves them.
"""

from __future__ import annotations

import torch

from .algebra import ErrorType
from .quantizers import compute_quantization_scales
from .reference import hamming74_decode, hamming74_encode, hamming84_decode, hamming84_encode


def _quantize_rows(x):
    x = torch.as_tensor(x).to(torch.float32)
    scales = compute_quantization_scales(x, axis=-1)
    q = torch.clamp(torch.round(x / scales[..., None]), -8, 7) + 8
    return q.to(torch.uint8), scales


def fused_quantize_encode_hamming84(x):
    """float rows -> (codewords uint8, scales)."""
    q, scales = _quantize_rows(x)
    return hamming84_encode(q), scales


def fused_quantize_encode_hamming74(x):
    q, scales = _quantize_rows(x)
    return hamming74_encode(q), scales


def fused_decode_dequantize_hamming84(codewords, scales):
    """codewords + per-row scales -> (float rows, (corrected, detected)),
    double errors zeroed."""
    data, error_type, corrected, detected = hamming84_decode(codewords)
    data = torch.where(error_type == ErrorType.DOUBLE_DETECTED, 0, data)
    x = (data.to(torch.float32) - 8.0) * torch.as_tensor(scales)[..., None]
    return x, (corrected, detected)


def fused_decode_dequantize_hamming74(codewords, scales):
    data, _err, corrected = hamming74_decode(codewords)
    x = (data.to(torch.float32) - 8.0) * torch.as_tensor(scales)[..., None]
    return x, (corrected,)
