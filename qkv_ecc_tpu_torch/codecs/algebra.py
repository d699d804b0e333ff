"""Golay(24,12) tables and the SECDED error classes shared by the
packed-cache codecs (counterpart of ``qkv_ecc_tpu/codecs/algebra.py``; only
what the port's paths need).

Golay(24,12): codeword = data(12 low bits) | parity << 12, data = three INT4
nibbles, G = [I12 | B], H = [B^T | I12].
"""

from __future__ import annotations

import numpy as np


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
