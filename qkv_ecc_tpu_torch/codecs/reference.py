"""The ECC codecs as elementwise torch functions (counterpart of
``qkv_ecc_tpu/codecs/reference.py``): the oracles of the codec kernels and
the user-facing codec classes.

Semantics are the JAX package's, bit for bit:
    - hamming74_*  : a nonzero syndrome always corrects (and counts) one bit;
    - hamming84_*  : double errors PRESERVE the data bits, classified by
                     ``ErrorType``;
    - golay_*      : uncorrectable codewords preserve their data, error
                     count sentinel 4.

Every function takes tensors of any shape on any device and returns the
error statistics as int32 tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.common import popcount
from .algebra import (
    ErrorType,
    GOLAY_B_ROW_MASKS,
    GOLAY_H_ROW_MASKS,
    GOLAY_SYNDROME_TABLE,
    GOLAY_UNCORRECTABLE_COUNT,
    SYNDROME_LUT_HAMMING74,
)

_B_MASKS = tuple(int(m) for m in GOLAY_B_ROW_MASKS)
_H_MASKS = tuple(int(m) for m in GOLAY_H_ROW_MASKS)


@functools.lru_cache(maxsize=None)
def _lut(name: str, device: torch.device) -> torch.Tensor:
    table = {"h74": SYNDROME_LUT_HAMMING74, "golay": GOLAY_SYNDROME_TABLE}[name]
    return torch.as_tensor(np.asarray(table, np.int32), device=device)


def _bit(x, i):
    return (x >> i) & 1


# =============================================================================
# Hamming(7,4)
# =============================================================================


def hamming74_encode(values: torch.Tensor) -> torch.Tensor:
    """INT4 values (low nibble) -> 7-bit codewords (uint8), layout
    [d0 d1 d2 d3 p0 p1 p2]: p0 = d0^d1^d3, p1 = d0^d2^d3, p2 = d1^d2^d3."""
    d = values.to(torch.int32) & 0xF
    d0, d1, d2, d3 = (_bit(d, i) for i in range(4))
    p0 = d0 ^ d1 ^ d3
    p1 = d0 ^ d2 ^ d3
    p2 = d1 ^ d2 ^ d3
    return (d | (p0 << 4) | (p1 << 5) | (p2 << 6)).to(torch.uint8)


def _hamming7_syndrome(cw7: torch.Tensor) -> torch.Tensor:
    c = [_bit(cw7, i) for i in range(7)]
    s0 = c[0] ^ c[1] ^ c[3] ^ c[4]
    s1 = c[0] ^ c[2] ^ c[3] ^ c[5]
    s2 = c[1] ^ c[2] ^ c[3] ^ c[6]
    return s0 | (s1 << 1) | (s2 << 2)


def _flip_at(cw: torch.Tensor, pos: torch.Tensor, where: torch.Tensor) -> torch.Tensor:
    """cw with bit ``pos`` flipped where ``where`` holds (pos >= 0 there)."""
    return torch.where(where, cw ^ (1 << pos.clamp(min=0)), cw)


def hamming74_decode(codewords: torch.Tensor):
    """7-bit codewords -> (data uint8, error_detected bool, corrected count
    int32): single-error correction through the 8-entry syndrome table; a
    nonzero syndrome always corrects one bit and counts."""
    cw = codewords.to(torch.int32) & 0x7F
    syndrome = _hamming7_syndrome(cw)
    pos = _lut("h74", cw.device)[syndrome]
    data = (_flip_at(cw, pos, pos >= 0) & 0xF).to(torch.uint8)
    detected = syndrome != 0
    return data, detected, detected.sum(dtype=torch.int32)


# =============================================================================
# Hamming(8,4) SECDED
# =============================================================================


def _parity7(cw7: torch.Tensor) -> torch.Tensor:
    p = cw7 ^ (cw7 >> 4)
    p = p ^ (p >> 2)
    p = p ^ (p >> 1)
    return p & 1


def hamming84_encode(values: torch.Tensor) -> torch.Tensor:
    """INT4 values -> 8-bit SECDED codewords (uint8; bit 7 = overall
    parity)."""
    cw7 = hamming74_encode(values).to(torch.int32)
    return (cw7 | (_parity7(cw7) << 7)).to(torch.uint8)


def hamming84_decode(codewords: torch.Tensor):
    """SECDED codewords -> (data uint8, error_type uint8 of ``ErrorType``,
    corrected count, detected count): double errors keep their (corrupt)
    data bits."""
    cw = codewords.to(torch.int32) & 0xFF
    cw7 = cw & 0x7F
    syndrome = _hamming7_syndrome(cw7)
    parity_error = ((cw >> 7) & 1) != _parity7(cw7)
    error_type = torch.where(
        syndrome == 0,
        torch.where(parity_error, ErrorType.PARITY_ONLY, ErrorType.NO_ERROR),
        torch.where(parity_error, ErrorType.SINGLE_CORRECTED, ErrorType.DOUBLE_DETECTED),
    ).to(torch.uint8)
    pos = _lut("h74", cw.device)[syndrome]
    single = error_type == ErrorType.SINGLE_CORRECTED
    data = (_flip_at(cw7, pos, single & (pos >= 0)) & 0xF).to(torch.uint8)
    return (data, error_type, single.sum(dtype=torch.int32),
            (error_type == ErrorType.DOUBLE_DETECTED).sum(dtype=torch.int32))


# =============================================================================
# Golay(24,12)
# =============================================================================


def _parity(x: torch.Tensor) -> torch.Tensor:
    return popcount(x) & 1


def golay_syndrome(codewords: torch.Tensor) -> torch.Tensor:
    """12-bit syndromes of 24-bit codewords (int32)."""
    cw = codewords.to(torch.int32)
    s = torch.zeros_like(cw)
    for i, mask in enumerate(_H_MASKS):
        s = s | (_parity(cw & mask) << i)
    return s


def golay_pack(nibbles: torch.Tensor) -> torch.Tensor:
    """INT4 triplets [..., 3] -> 12-bit data words [...] (int32)."""
    n = nibbles.to(torch.int32) & 0xF
    return n[..., 0] | (n[..., 1] << 4) | (n[..., 2] << 8)


def golay_unpack(data12: torch.Tensor) -> torch.Tensor:
    """12-bit data words [...] -> INT4 triplets [..., 3] (uint8)."""
    d = data12.to(torch.int32)
    return torch.stack([d & 0xF, (d >> 4) & 0xF, (d >> 8) & 0xF], dim=-1).to(torch.uint8)


def golay_encode(nibbles: torch.Tensor) -> torch.Tensor:
    """INT4 triplets [..., 3] -> 24-bit codewords [...] (int32): parity bit
    j is the parity of data & B row j (B is symmetric)."""
    data = golay_pack(nibbles)
    parity = torch.zeros_like(data)
    for j, mask in enumerate(_B_MASKS):
        parity = parity | (_parity(data & mask) << j)
    return data | (parity << 12)


def _golay_result(cw, correctable, e):
    """(triplets, error_count, corrected bits, uncorrectable count) of a
    decode whose error pattern is e where correctable."""
    corrected = torch.where(correctable, cw ^ e, cw)
    count = torch.where(correctable, popcount(e), GOLAY_UNCORRECTABLE_COUNT).to(torch.int32)
    return (golay_unpack(corrected & 0xFFF), count,
            torch.where(correctable, count, 0).sum(dtype=torch.int32),
            (~correctable).sum(dtype=torch.int32))


def golay_decode(codewords: torch.Tensor):
    """Syndrome-table Golay decode (the oracle). Returns (triplets [..., 3]
    uint8, error_count [...] int32: 0-3, or 4 for an uncorrectable codeword,
    whose data bits are kept; corrected bits, uncorrectable count)."""
    cw = codewords.to(torch.int32)
    pattern = _lut("golay", cw.device)[golay_syndrome(cw)]
    return _golay_result(cw, pattern >= 0, pattern.clamp(min=0))


def golay_decode_algebraic(codewords: torch.Tensor):
    """LUT-free Golay decode (IMLD), as golay_decode for every error pattern
    of weight <= 3. With r = (d, p) and s = B d ^ p:
        1. wt(s) <= 3                  -> e = (0, s)
        2. exists i: wt(s ^ B_i) <= 2  -> e = (u_i, s ^ B_i)
        3. q = B s; wt(q) <= 3         -> e = (q, 0)
        4. exists i: wt(q ^ B_i) <= 2  -> e = (q ^ B_i, u_i)
        5. otherwise uncorrectable."""
    cw = codewords.to(torch.int32)
    d = cw & 0xFFF
    p = (cw >> 12) & 0xFFF
    s = torch.zeros_like(cw)
    for i, mask in enumerate(_B_MASKS):
        s = s | (_parity(d & mask) << i)
    s = s ^ p
    q = torch.zeros_like(cw)
    for i, mask in enumerate(_B_MASKS):
        q = q | (_parity(s & mask) << i)
    ok2 = torch.zeros_like(cw, dtype=torch.bool)
    ok4 = torch.zeros_like(cw, dtype=torch.bool)
    e2 = torch.zeros_like(cw)
    e4 = torch.zeros_like(cw)
    for i, mask in enumerate(_B_MASKS):
        cand = s ^ mask
        hit = (popcount(cand) <= 2) & ~ok2
        e2 = torch.where(hit, (1 << i) | (cand << 12), e2)
        ok2 = ok2 | hit
        cand = q ^ mask
        hit = (popcount(cand) <= 2) & ~ok4
        e4 = torch.where(hit, cand | (1 << (12 + i)), e4)
        ok4 = ok4 | hit
    ok1, ok3 = popcount(s) <= 3, popcount(q) <= 3
    e = torch.where(ok1, s << 12, torch.where(ok2, e2, torch.where(ok3, q, e4)))
    return _golay_result(cw, ok1 | ok2 | ok3 | ok4, e)


# =============================================================================
# Codec classes
# =============================================================================


class Hamming74:
    """Hamming(7,4) SEC codec."""

    n_bits = 7
    data_bits = 4

    def encode(self, values):
        return hamming74_encode(torch.as_tensor(values))

    def decode(self, codewords):
        data, error_detected, corrected = hamming74_decode(torch.as_tensor(codewords))
        return data, error_detected, int(corrected)


class Hamming84:
    """Hamming(8,4) SECDED codec."""

    n_bits = 8
    data_bits = 4

    def encode(self, values):
        return hamming84_encode(torch.as_tensor(values))

    def decode(self, codewords, return_error_types=False):
        data, error_type, corrected, detected = hamming84_decode(torch.as_tensor(codewords))
        if return_error_types:
            return data, error_type, (int(corrected), int(detected))
        return data, (int(corrected), int(detected))


class Golay2412:
    """Golay(24,12) codec."""

    n_bits = 24
    data_bits = 12

    def encode(self, triplets):
        return golay_encode(torch.as_tensor(triplets))

    def decode(self, codewords):
        triplets, _, corrected_bits, uncorrectable = golay_decode(torch.as_tensor(codewords))
        return triplets, (int(corrected_bits), int(uncorrectable))

    def verify_properties(self, device=None):
        """Spot-check the code on ``device`` (None: the card): G H^T = 0 over
        GF(2), and 64 random triplets decode back from every weight 1-3 flip
        pattern drawn for them."""
        from . import algebra as A

        device = resolve_device(device)
        ok = ((A.GOLAY_G.astype(int) @ A.GOLAY_H.astype(int).T) % 2).sum() == 0
        rng = np.random.default_rng(0)
        trip = torch.from_numpy(rng.integers(0, 16, size=(64, 3), dtype=np.uint8)).to(device)
        cw = golay_encode(trip)
        for weight in (1, 2, 3):
            flips = np.zeros(cw.shape, dtype=np.int64)
            for r in range(cw.shape[0]):
                for b in rng.choice(24, size=weight, replace=False):
                    flips[r] |= 1 << int(b)
            dec, _, _, unc = golay_decode(cw ^ torch.from_numpy(flips.astype(np.int32)).to(device))
            ok = ok and bool(torch.equal(dec, trip)) and int(unc) == 0
        return bool(ok)
