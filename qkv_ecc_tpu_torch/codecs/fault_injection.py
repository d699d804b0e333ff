"""Bernoulli bit-flip fault injection from an explicit ``torch.Generator``
(counterpart of ``qkv_ecc_tpu/codecs/fault_injection.py``).

Each of the low ``n_bits`` bits of every element flips independently with
probability ``ber``. The JAX module's contract, kept here: a fixed (seed,
shape, n_bits) always gives the same flips, and the flip rate is ``ber``
(statistical equivalence; the bits are not the JAX package's threefry
bits). Every function that injects also takes the mask as an explicit
tensor, which is how the tests feed both packages the same noise.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..kernels.common import popcount


def flip_mask(shape, ber: float, n_bits: int, generator: torch.Generator) -> torch.Tensor:
    """int32 XOR mask of ``shape`` on the generator's device: bit b of each
    element is set when a uniform draw for (element, b) is below ``ber``."""
    device = generator.device
    draws = torch.rand((n_bits,) + tuple(shape), generator=generator, device=device)
    flips = (draws < ber).to(torch.int32)
    bits = torch.arange(n_bits, dtype=torch.int32, device=device).reshape(
        (n_bits,) + (1,) * len(tuple(shape)))
    return (flips << bits).sum(0, dtype=torch.int32)


def flip_mask_for(generator: torch.Generator, shape, ber: float, n_bits: int) -> torch.Tensor:
    """flip_mask with the JAX function's argument order (the generator takes
    the key's place)."""
    return flip_mask(shape, ber, n_bits, generator)


def inject_bit_errors(data, ber, n_bits, seed=0, generator=None, return_stats=False):
    """Flip the low ``n_bits`` bits of every element of ``data`` (uint8 or
    int32 codewords) with probability ``ber``, drawing from ``generator``,
    or from a generator seeded with ``seed`` on data's device.

    Returns the corrupted tensor (data's type), or (corrupted,
    (total_flips, elements_affected)) with ``return_stats``."""
    data = torch.as_tensor(data)
    if ber <= 0:
        return (data, (0, 0)) if return_stats else data
    if generator is None:
        generator = torch.Generator(device=data.device).manual_seed(seed)
    mask = flip_mask(data.shape, float(ber), int(n_bits), generator).to(data.device)
    corrupted = (data.to(torch.int32) ^ mask).to(data.dtype)
    if return_stats:
        return corrupted, (int(popcount(mask).sum()), int((mask != 0).sum()))
    return corrupted


def verify_ber_fidelity(ber=0.01, n_bits=8, n=1_000_000, seed=0, tolerance=0.15, device=None):
    """The empirical flip rate over n zero elements on ``device`` (None: the
    card) is within ``tolerance`` (relative) of ``ber``. Returns (ok,
    empirical rate)."""
    data = torch.zeros((n,), dtype=torch.uint8 if n_bits <= 8 else torch.int32,
                       device=resolve_device(device))
    _, (flips, _) = inject_bit_errors(data, ber, n_bits, seed=seed, return_stats=True)
    empirical = flips / (n * n_bits)
    return abs(empirical - ber) <= tolerance * ber, empirical


def verify_determinism(ber=0.01, n_bits=8, n=4096, seed=123, device=None):
    """The same seed gives the same corruption, the next seed another, on
    ``device`` (None: the card)."""
    data = (torch.arange(n, dtype=torch.int32, device=resolve_device(device)) % 256).to(
        torch.uint8)
    a = inject_bit_errors(data, ber, n_bits, seed=seed)
    b = inject_bit_errors(data, ber, n_bits, seed=seed)
    c = inject_bit_errors(data, ber, n_bits, seed=seed + 1)
    return bool(torch.equal(a, b)) and not bool(torch.equal(a, c))
