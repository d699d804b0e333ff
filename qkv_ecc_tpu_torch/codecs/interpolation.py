"""Temporal interpolation of SECDED double errors (counterpart of
``qkv_ecc_tpu/codecs/interpolation.py``).

Where Hamming(8,4) detects a double error, the INT4 code at sequence
position t is replaced by the rounded mean of its decoded neighbours:

    v_hat[t] = floor((v[t-1] + v[t+1]) / 2 + 0.5), clipped to [0, 15],

with each end of the sequence axis taking itself as its missing neighbour.
Neighbours are the decoded values whatever their own error class, and the
interpolation runs in code space (the token's own scale is applied after).
"""

from __future__ import annotations

import torch

from .algebra import ErrorType


def interpolate_double_errors(q: torch.Tensor, error_type: torch.Tensor,
                              seq_dim: int = -1) -> torch.Tensor:
    """Replace the DOUBLE_DETECTED positions of q (codes 0-15, any shape) by
    the interpolation of their neighbours along ``seq_dim``; returns q's
    dtype, every other position untouched."""
    if q.shape != error_type.shape:
        raise ValueError(f"shape mismatch: {tuple(q.shape)} vs {tuple(error_type.shape)}")
    if q.dim() == 0:
        return q
    moved = torch.movedim(q, seq_dim, -1)
    moved_err = torch.movedim(error_type, seq_dim, -1)
    left = torch.cat([moved[..., :1], moved[..., :-1]], dim=-1)
    right = torch.cat([moved[..., 1:], moved[..., -1:]], dim=-1)
    interp = (left.to(torch.float32) + right.to(torch.float32)) * 0.5
    interp = torch.clamp(torch.floor(interp + 0.5), 0.0, 15.0).to(q.dtype)
    out = torch.where(moved_err == ErrorType.DOUBLE_DETECTED, interp, moved)
    return torch.movedim(out, -1, seq_dim)
