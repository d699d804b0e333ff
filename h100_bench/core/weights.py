"""Random weights made on the device from the seed, in the port's parameter
layout and the configuration's dtype: one generator, one draw per kind of
matrix (all layers at once), in the order and at the stds that the
architecture's module (``archs/<name>.py`` ``make_weights``) gives, as the
published models are initialised. Both the program and the reference are
handed these tensors."""

from __future__ import annotations

import torch

from .traffic import WEIGHTS, sub_seed


def make_weights(arch, cfg, seed: int, device) -> dict:
    """arch: archs/<name>.py; cfg: the port's ModelConfig."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    dtype = cfg.torch_dtype

    def normal(shape, std):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(std)

    def full(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    return arch.make_weights(cfg, normal, full)
