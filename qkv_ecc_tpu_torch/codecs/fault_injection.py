"""Bernoulli bit-flip masks from an explicit ``torch.Generator``
(counterpart of ``qkv_ecc_tpu/codecs/fault_injection.py:flip_mask_for``).

Each of the low ``n_bits`` bits of every element flips independently with
probability ``ber``. The draws are not the JAX package's threefry bits:
only the distribution and the determinism per (generator state, shape) carry
over. Every function that injects also takes the mask as an explicit tensor,
which is how the tests feed both packages the same noise.
"""

from __future__ import annotations

import torch


def flip_mask(shape, ber: float, n_bits: int, generator: torch.Generator) -> torch.Tensor:
    """int32 XOR mask of ``shape`` on the generator's device: bit b of each
    element is set when a uniform draw for (element, b) is below ``ber``."""
    device = generator.device
    draws = torch.rand((n_bits,) + tuple(shape), generator=generator, device=device)
    flips = (draws < ber).to(torch.int32)
    bits = torch.arange(n_bits, dtype=torch.int32, device=device).reshape(
        (n_bits,) + (1,) * len(tuple(shape)))
    return (flips << bits).sum(0, dtype=torch.int32)
