"""int32 Hamming and Golay helpers on torch tensors (counterpart of
``qkv_ecc_tpu/kernels/common.py``).

Unsigned 32-bit arithmetic is done in int32 with explicit masks: every value
these helpers see is a 7/8-bit Hamming codeword, a 24-bit Golay codeword or
a 12-bit word, so no sign bit is ever set.
"""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def i32_bits(x: int) -> int:
    """An unsigned 32-bit value as the C int with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int32 element (SWAR byte sums)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


# Hamming(7,4) syndrome -> bit position (-1: no error).
_H74_LUT_PACKED = (-1, 4, 5, 0, 6, 1, 2, 3)


def hamming7_syndrome_i32(cw7: torch.Tensor) -> torch.Tensor:
    c = [(cw7 >> i) & 1 for i in range(7)]
    s0 = c[0] ^ c[1] ^ c[3] ^ c[4]
    s1 = c[0] ^ c[2] ^ c[3] ^ c[5]
    s2 = c[1] ^ c[2] ^ c[3] ^ c[6]
    return s0 | (s1 << 1) | (s2 << 2)


def h74_error_mask_i32(syndrome: torch.Tensor) -> torch.Tensor:
    """Syndrome -> XOR correction mask of the 7-bit codeword."""
    mask = torch.zeros_like(syndrome)
    for s_val, pos in enumerate(_H74_LUT_PACKED):
        if pos >= 0:
            mask = torch.where(syndrome == s_val, 1 << pos, mask)
    return mask


def hamming74_decode_i32(cw: torch.Tensor):
    """7-bit codewords -> (data nibbles, error detected)."""
    cw7 = cw & 0x7F
    syndrome = hamming7_syndrome_i32(cw7)
    return (cw7 ^ h74_error_mask_i32(syndrome)) & 0xF, syndrome != 0


def _odd_parity7(cw7: torch.Tensor) -> torch.Tensor:
    p = cw7 ^ (cw7 >> 4)
    p = p ^ (p >> 2)
    p = p ^ (p >> 1)
    return p & 1


def hamming84_decode_i32(cw: torch.Tensor):
    """8-bit SECDED codewords -> (data, ErrorType as int32)."""
    cw7 = cw & 0x7F
    parity_error = ((cw >> 7) & 1) != _odd_parity7(cw7)
    syndrome = hamming7_syndrome_i32(cw7)
    error_type = torch.where(
        syndrome == 0,
        torch.where(parity_error, 3, 0),
        torch.where(parity_error, 1, 2),
    ).to(torch.int32)
    correction = torch.where(error_type == 1, h74_error_mask_i32(syndrome), 0)
    return (cw7 ^ correction) & 0xF, error_type


def _h74_data_correction_i32(syndrome: torch.Tensor) -> torch.Tensor:
    """XOR mask for the data nibble only: syndromes {3, 5, 6, 7} flip data
    bits {0, 1, 2, 3}; the others are parity-bit errors."""
    return torch.where(
        syndrome == 3,
        1,
        torch.where(syndrome >= 5,
                    torch.ones_like(syndrome) << torch.clamp(syndrome - 4, min=0), 0),
    )


def hamming74_correct_data_i32(cw: torch.Tensor) -> torch.Tensor:
    """Data-only Hamming(7,4) correction (no error flags)."""
    cw7 = cw & 0x7F
    return (cw7 ^ _h74_data_correction_i32(hamming7_syndrome_i32(cw7))) & 0xF


def hamming84_correct_data_i32(cw: torch.Tensor) -> torch.Tensor:
    """Data-only SECDED correction: singles corrected, doubles keep their
    corrupt data bits (the data output of hamming84_decode_i32)."""
    cw7 = cw & 0x7F
    syndrome = hamming7_syndrome_i32(cw7)
    single = (syndrome != 0) & ((popcount(cw & 0xFF) & 1) == 1)
    corr = torch.where(single, _h74_data_correction_i32(syndrome), 0)
    return (cw7 ^ corr) & 0xF


def hamming74_encode_i32(d: torch.Tensor) -> torch.Tensor:
    d = d & 0xF
    b = [(d >> i) & 1 for i in range(4)]
    p0 = b[0] ^ b[1] ^ b[3]
    p1 = b[0] ^ b[2] ^ b[3]
    p2 = b[1] ^ b[2] ^ b[3]
    return d | (p0 << 4) | (p1 << 5) | (p2 << 6)


def hamming84_encode_i32(d: torch.Tensor) -> torch.Tensor:
    cw7 = hamming74_encode_i32(d)
    return cw7 | (_odd_parity7(cw7) << 7)


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


def golay_nibble_tables(b_masks) -> torch.Tensor:
    """[48] int32: entry 16 k + n is the XOR of B's rows 4 k + i over the
    set bits i of n, so that d . B = t[d & 15] ^ t[16 + (d >> 4 & 15)] ^
    t[32 + (d >> 8)] (B is symmetric): golay.cuh fill_encode_tables."""
    n = torch.arange(16, dtype=torch.int32)
    rows = [torch.zeros_like(n) for _ in range(3)]
    for k in range(3):
        for i in range(4):
            rows[k] = rows[k] ^ torch.where((n >> i) & 1 == 1, b_masks[4 * k + i], 0)
    return torch.cat(rows).to(torch.int32)


GOLAY_WEIGHT_SHIFT = 12  # a syndrome-table entry: correction | weight << 12


def golay_syndrome_table(b_masks) -> torch.Tensor:
    """[4096] int16, the correcting reads' decode table (golay.cuh
    decode_table): entry s holds the IMLD's data correction (bits 0-11) and
    the error weight (bits 12-14: 0-3, or 4 when uncorrectable, correction
    0) of a codeword whose syndrome d . B ^ p is s. Both depend on s alone,
    so they are read off the arithmetic IMLD (golay_decode_i32 and
    golay_correct_data_i32, which must agree) at d = 0, p = s."""
    cw = torch.arange(4096, dtype=torch.int32) << 12
    data, weight = golay_decode_i32(cw, b_masks, zero_uncorrectable=True)
    if not torch.equal(data, golay_correct_data_i32(cw, b_masks)):
        raise AssertionError("the two arithmetic IMLDs disagree")
    return (data | (weight << GOLAY_WEIGHT_SHIFT)).to(torch.int16)


def golay_lane_index(s: torch.Tensor) -> torch.Tensor:
    """The byte-lane read's table index of syndrome s: (s >> 4) | (s & 15)
    << 8. golay.cuh decode_group forms s in two planes, bits 4-11 a byte a
    lane and bits 0-3 a nibble, and joins a lane's two with one prmt, high
    plane first; this is the one place the order is decided for the host."""
    return (s >> 4) | ((s & 15) << 8)


def golay_read_table(b_masks) -> torch.Tensor:
    """[4096] int16, golay_syndrome_table in the byte-lane read's order:
    entry golay_lane_index(s) holds syndrome s's entry."""
    table = golay_syndrome_table(b_masks)
    out = torch.empty_like(table)
    out[golay_lane_index(torch.arange(4096))] = table
    return out


def golay_table_decode(cw: torch.Tensor, nibble_tables: torch.Tensor,
                       syndrome_table: torch.Tensor):
    """The kernels' syndrome-table decode of 24-bit codewords, in plain
    torch: s from three nibble-table lookups and the parity bits, then one
    lookup. Returns (data12, weight 0-3 | 4); an uncorrectable codeword's
    data reads as 0. The same bits as golay_decode_i32(zero_uncorrectable=
    True)."""
    cw = cw.to(torch.int32)
    d = cw & 0xFFF
    t = nibble_tables.to(cw.device).long()
    s = t[d & 15] ^ t[16 + ((d >> 4) & 15)] ^ t[32 + (d >> 8)] ^ ((cw >> 12) & 0xFFF)
    e = syndrome_table.to(cw.device).to(torch.int32)[s]
    weight = e >> GOLAY_WEIGHT_SHIFT
    return torch.where(weight == 4, 0, d ^ (e & 0xFFF)), weight


# =============================================================================
# The float codecs' storage types, rounded as JAX's astype rounds
# =============================================================================

FP8_E4M3_OVERFLOW = 464.0  # the midpoint of 448 (the largest finite value) and 480
# the float codecs' storage types (the JAX package's)
FLOAT_STORAGE_DTYPES = {"fp16": torch.bfloat16, "fp8": torch.float8_e4m3fn}


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> bfloat16 (the fp16 codec's storage): round to nearest
    even, NaN stored as JAX stores it (0x7fc0, with the sign kept). The
    result is the cast itself where x is not NaN, so autograd carries the
    gradient through it as JAX's does through its astype (the cotangent
    rounded to bfloat16)."""
    x = x.to(torch.float32)
    nan = torch.where(torch.signbit(x), -0x40, 0x7FC0).to(torch.int16)  # -0x40 is 0xffc0
    return torch.where(torch.isnan(x), nan.view(torch.bfloat16), x.to(torch.bfloat16))


def to_fp8_e4m3(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float8_e4m3fn (the fp8 codec's storage) as JAX's astype:
    round to nearest even for |x| <= 464; NaN (0x7f, 0xff with the sign
    kept) for larger |x| and for +-inf, where torch's conversion saturates
    to +-448. Elsewhere the result is the cast itself, which autograd
    differentiates as JAX does its astype."""
    x = x.to(torch.float32)
    nan = torch.where(torch.signbit(x), 0xFF, 0x7F).to(torch.uint8)
    return torch.where(x.abs() > FP8_E4M3_OVERFLOW, nan.view(torch.float8_e4m3fn),
                       x.to(torch.float8_e4m3fn))


def fp8_as_bytes(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 tensor as a view of its bytes, for gathers and index_put_
    (which do not take float8 types on every build); others as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def to_float_storage(codec: str, x: torch.Tensor) -> torch.Tensor:
    """The stored values of a float codec: fp16 -> bfloat16, fp8 -> e4m3."""
    return to_bf16(x) if codec == "fp16" else to_fp8_e4m3(x)
