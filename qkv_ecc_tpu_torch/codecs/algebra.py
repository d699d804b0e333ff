"""Algebraic structures of the ECC codecs (counterpart of
``qkv_ecc_tpu/codecs/algebra.py``): generator and parity-check matrices,
syndrome lookup tables, error classes and storage types.

Codes:
    - Hamming(7,4) SEC           : 4 data bits -> 7-bit codeword
    - Hamming(8,4) SECDED        : Hamming(7,4) + overall parity bit
    - Golay(24,12) perfect code  : 12 data bits (three INT4 nibbles) -> 24 bits

Bit layouts:
    Hamming(7,4):  codeword bits [d0 d1 d2 d3 p0 p1 p2]  (data in the low nibble)
    Hamming(8,4):  bit 7 = overall parity of the 7-bit codeword
    Golay(24,12):  codeword = data(12 low bits) | parity << 12,
                   data = n0 | n1 << 4 | n2 << 8  (three INT4 nibbles),
                   G = [I12 | B], H = [B^T | I12]

The tables are numpy arrays built once at import.
"""

from __future__ import annotations

import numpy as np
import torch

# =============================================================================
# Storage types and bit counts
# =============================================================================

CODEC_CODEWORD_BITS = {"hamming74": 7, "hamming84": 8, "golay": 24}
CODEC_DATA_BITS = {"hamming74": 4, "hamming84": 4, "golay": 12}


def get_codeword_bits(codec: str) -> int:
    try:
        return CODEC_CODEWORD_BITS[codec]
    except KeyError:
        raise ValueError(f"Unknown codec: {codec}")


def get_data_bits(codec: str) -> int:
    try:
        return CODEC_DATA_BITS[codec]
    except KeyError:
        raise ValueError(f"Unknown codec: {codec}")


def get_physical_dtype(codec: str) -> torch.dtype:
    """Storage type of one codeword, one codeword per element (the packed
    cache layouts are the cache module's): uint8 for codewords of up to 8
    bits, int32 for Golay, bfloat16 for the unprotected fp16 values."""
    if codec in ("hamming74", "hamming84", "int4"):
        return torch.uint8
    if codec == "golay":
        return torch.int32
    if codec in ("none", "fp16"):
        return torch.bfloat16
    raise ValueError(f"Unknown codec: {codec}")


# =============================================================================
# Error classification (SECDED)
# =============================================================================


class ErrorType:
    """Hamming(8,4) SECDED decode classification.

    (syndrome, overall parity) -> class:
        syndrome==0, parity ok   -> NO_ERROR
        syndrome!=0, parity bad  -> SINGLE_CORRECTED
        syndrome!=0, parity ok   -> DOUBLE_DETECTED  (data preserved, corrupt)
        syndrome==0, parity bad  -> PARITY_ONLY      (data valid)
    """

    NO_ERROR = 0
    SINGLE_CORRECTED = 1
    DOUBLE_DETECTED = 2
    PARITY_ONLY = 3


# Sentinel error_count for an uncorrectable Golay codeword (>3 bit errors).
GOLAY_UNCORRECTABLE_COUNT = 4

# =============================================================================
# Hamming(7,4) / Hamming(8,4)
# =============================================================================

# Systematic generator matrix G (4x7): codeword = data @ G (mod 2), columns
# [d0 d1 d2 d3 p0 p1 p2].
HAMMING74_G = np.array(
    [
        [1, 0, 0, 0, 1, 1, 0],
        [0, 1, 0, 0, 1, 0, 1],
        [0, 0, 1, 0, 0, 1, 1],
        [0, 0, 0, 1, 1, 1, 1],
    ],
    dtype=np.uint8,
)

# Parity-check matrix H (3x7): syndrome = H @ received (mod 2).
HAMMING74_H = np.array(
    [
        [1, 1, 0, 1, 1, 0, 0],
        [1, 0, 1, 1, 0, 1, 0],
        [0, 1, 1, 1, 0, 0, 1],
    ],
    dtype=np.uint8,
)

HAMMING84_G = HAMMING74_G
HAMMING84_H = HAMMING74_H

# 3-bit syndrome -> the codeword bit whose H column it is (-1: no error).
SYNDROME_LUT_HAMMING74 = np.array([-1, 4, 5, 0, 6, 1, 2, 3], dtype=np.int8)
SYNDROME_LUT_HAMMING84 = SYNDROME_LUT_HAMMING74

# =============================================================================
# Golay(24,12)
# =============================================================================


def _build_golay_b_matrix() -> np.ndarray:
    """The 12x12 B matrix: back-circulant of the quadratic residues mod 11
    {1, 3, 4, 5, 9} bordered by an (almost) all-ones row and column. B is
    symmetric and B @ B = I over GF(2)."""
    residues = {1, 3, 4, 5, 9}
    b = np.zeros((12, 12), dtype=np.uint8)
    for i in range(11):
        for j in range(11):
            d = (i + j) % 11
            b[i, j] = 1 if (d == 0 or d in residues) else 0
        b[i, 11] = 1
        b[11, i] = 1
    b[11, 11] = 0
    return b


GOLAY_B_MATRIX = _build_golay_b_matrix()

# Row i of B packed into the low 12 bits of an int (bit j = B[i, j]).
GOLAY_B_ROW_MASKS = np.array(
    [int(sum(int(GOLAY_B_MATRIX[i, j]) << j for j in range(12))) for i in range(12)],
    dtype=np.int32,
)

# Row i of H = [B^T | I12] packed into 24 bits: syndrome bit i is the parity
# of popcount(received & mask_i).
GOLAY_H_ROW_MASKS = np.array(
    [int(GOLAY_B_ROW_MASKS[i]) | (1 << (12 + i)) for i in range(12)], dtype=np.int32)


def _golay_syndromes(patterns: np.ndarray) -> np.ndarray:
    """12-bit syndromes of 24-bit words (int64 numpy)."""
    s = np.zeros_like(patterns)
    for i, mask in enumerate(GOLAY_H_ROW_MASKS.astype(np.int64)):
        bits = patterns & mask
        parity = np.zeros_like(bits)
        for j in range(24):
            parity ^= (bits >> j) & 1
        s |= parity << i
    return s


def build_golay_syndrome_table() -> np.ndarray:
    """Each 12-bit syndrome -> its unique error pattern of weight <= 3.

    Golay(24,12) is perfect: the 1 + 24 + C(24,2) + C(24,3) = 2325 patterns
    of weight <= 3 have distinct syndromes; the other 4096 - 2325 = 1771
    syndromes are uncorrectable and stay -1."""
    bits = [1 << i for i in range(24)]
    patterns = [0] + bits
    patterns += [a | b for n, a in enumerate(bits) for b in bits[n + 1:]]
    patterns += [a | b | c for n, a in enumerate(bits) for m, b in enumerate(bits[n + 1:], n + 1)
                 for c in bits[m + 1:]]
    patterns = np.array(patterns, dtype=np.int64)
    table = np.full(4096, -1, dtype=np.int64)
    table[_golay_syndromes(patterns)] = patterns  # distinct syndromes: no collisions
    return table.astype(np.int32)


GOLAY_SYNDROME_TABLE = build_golay_syndrome_table()

# Generator matrix of the full code, G = [I12 | B] (12 x 24), and the parity
# check H = [B^T | I12] (12 x 24).
GOLAY_G = np.concatenate([np.eye(12, dtype=np.uint8), GOLAY_B_MATRIX], axis=1)
GOLAY_H = np.concatenate([GOLAY_B_MATRIX.T, np.eye(12, dtype=np.uint8)], axis=1)
