"""int32 Golay helpers on torch tensors (counterpart of
``qkv_ecc_tpu/kernels/common.py``, golay part).

Unsigned 32-bit arithmetic is done in int32 with explicit masks: every value
these helpers see is a 24-bit codeword or a 12-bit word, so no sign bit is
ever set.
"""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int32 element (SWAR byte sums)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


def _parity(x: torch.Tensor) -> torch.Tensor:
    return popcount(x) & 1


def golay_encode_i32(data12: torch.Tensor, b_masks) -> torch.Tensor:
    """12-bit data words -> 24-bit codewords. b_masks: 12 ints."""
    parity = torch.zeros_like(data12)
    for j in range(12):
        parity = parity | (_parity(data12 & b_masks[j]) << j)
    return data12 | (parity << 12)


def golay_decode_i32(cw: torch.Tensor, b_masks, *, zero_uncorrectable: bool):
    """Arithmetic (LUT-free) IMLD Golay decode on int32 elements.

    Returns (data12, error_count) with error_count 0-3 or the sentinel 4.
    With zero_uncorrectable, uncorrectable codewords decode to 0 (the fused
    attention semantics); otherwise their corrupt data bits are kept."""
    d = cw & 0xFFF
    p = (cw >> 12) & 0xFFF

    s = torch.zeros_like(cw)
    for i in range(12):
        s = s | (_parity(d & b_masks[i]) << i)
    s = s ^ p

    e1 = s << 12
    ok1 = popcount(s) <= 3

    ok2 = torch.zeros_like(cw, dtype=torch.bool)
    e2 = torch.zeros_like(cw)
    for i in range(12):
        cand = s ^ b_masks[i]
        hit = (popcount(cand) <= 2) & ~ok2
        e2 = torch.where(hit, (1 << i) | (cand << 12), e2)
        ok2 = ok2 | hit

    q = torch.zeros_like(cw)
    for i in range(12):
        q = q | (_parity(s & b_masks[i]) << i)

    e3 = q
    ok3 = popcount(q) <= 3

    ok4 = torch.zeros_like(cw, dtype=torch.bool)
    e4 = torch.zeros_like(cw)
    for i in range(12):
        cand = q ^ b_masks[i]
        hit = (popcount(cand) <= 2) & ~ok4
        e4 = torch.where(hit, cand | (1 << (12 + i)), e4)
        ok4 = ok4 | hit

    zero = torch.zeros_like(cw)
    e = torch.where(ok1, e1, torch.where(ok2, e2, torch.where(ok3, e3, torch.where(ok4, e4, zero))))
    correctable = ok1 | ok2 | ok3 | ok4

    data = (cw ^ e) & 0xFFF
    if zero_uncorrectable:
        data = torch.where(correctable, data, zero)
    else:
        data = torch.where(correctable, data, cw & 0xFFF)
    error_count = torch.where(correctable, popcount(e), torch.full_like(cw, 4))
    return data, error_count


def golay_correct_data_i32(cw: torch.Tensor, b_masks) -> torch.Tensor:
    """Data-half-only IMLD correction (no error counts). B rows are pairwise
    >= 6 apart, so within a stage at most one candidate can hit and hits may
    be OR-accumulated. Uncorrectable codewords decode to 0."""
    d = cw & 0xFFF
    p = (cw >> 12) & 0xFFF

    s = torch.zeros_like(cw)
    for i in range(12):
        s = s | (_parity(d & b_masks[i]) << i)
    s = s ^ p

    ok1 = popcount(s) <= 3

    ok2 = torch.zeros_like(cw, dtype=torch.bool)
    e2 = torch.zeros_like(cw)
    for i in range(12):
        hit = popcount(s ^ b_masks[i]) <= 2
        e2 = torch.where(hit, torch.full_like(cw, 1 << i), e2)
        ok2 = ok2 | hit

    q = torch.zeros_like(cw)
    for i in range(12):
        q = q | (_parity(s & b_masks[i]) << i)

    ok3 = popcount(q) <= 3

    ok4 = torch.zeros_like(cw, dtype=torch.bool)
    e4 = torch.zeros_like(cw)
    for i in range(12):
        cand = q ^ b_masks[i]
        hit = popcount(cand) <= 2
        e4 = torch.where(hit, cand, e4)
        ok4 = ok4 | hit

    zero = torch.zeros_like(cw)
    ed = torch.where(ok1, zero, torch.where(ok2, e2, torch.where(ok3, q, e4)))
    correctable = ok1 | ok2 | ok3 | ok4
    return torch.where(correctable, d ^ ed, zero)
