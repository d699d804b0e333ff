"""Model zoo dispatch (counterpart of ``qkv_ecc_tpu/models/registry.py``;
llama only in this slice)."""

from __future__ import annotations

import torch

from ..device import resolve_device
from . import llama
from .config import ModelConfig

_ARCH = {"llama": llama.init_params}


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (None: the card)."""
    if cfg.arch not in _ARCH:
        raise NotImplementedError(f"architecture '{cfg.arch}' is a later slice")
    generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return _ARCH[cfg.arch](cfg, generator, dtype=dtype)
