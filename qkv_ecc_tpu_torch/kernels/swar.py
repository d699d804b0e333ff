"""Packed-cache codec math on torch int32 tensors (counterpart of
``qkv_ecc_tpu/kernels/swar.py``).

The storage format is the JAX package's, bit for bit. Every row is
data-first: the int4-packed data nibbles, then the codec's parity.

  int4       8 nibbles per int32 word (``pack_int4``): byte k of word j holds
             value 4j+k in its low nibble and value D/2+4j+k in its high
             nibble.
  hamming84  data nibbles int4-packed, then the parity nibbles (codeword
             bits 4-7) int4-packed the same way.
  hamming74  data nibbles int4-packed, then 3 bit-sliced parity planes of G
             words each: bit t of plane p word g is parity bit p of value
             t*G + g.
  golay      codeword c protects values (c, c+C, c+2C) (third-partitioned
             over the padded codeword count C). The int4-packed data
             nibbles, then a nibble plane (codeword bits 12-15 and the
             padding values) and a byte plane (bits 16-23).

Every ECC row keeps its data nibbles in the int4 layout, so a scrubbed read
is an int4 read and never touches parity.

Unsigned arithmetic runs in int32 with explicit masks; shifts left wrap as
two's complement and shifts right are arithmetic, as in XLA.
"""

from __future__ import annotations

import functools

import torch

from ..codecs.algebra import GOLAY_B_ROW_MASKS
from . import common as C

_B_MASKS = tuple(int(m) for m in GOLAY_B_ROW_MASKS)
M1 = 0x01010101  # bit 0 of each byte

FLOAT_CODECS = ("fp16", "fp8")  # raw values, one element per value: no packing


def unsupported(codec: str):
    """Raise ValueError for a codec that has no branch here: an unknown one,
    or a float codec in the packed-int codec math."""
    what = "a float codec: its values are not packed" if codec in FLOAT_CODECS else "unknown"
    raise ValueError(f"codec '{codec}': {what}")


round_up = C.round_up


def _last(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(x, axis, -1).to(torch.int32)


# =============================================================================
# int4: 8 nibbles per int32 word
# =============================================================================


def pack_bytes4(cw: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """[..., 4W] byte-sized values -> [..., W] int32 words, byte k of word j
    = element 4j+k: the little-endian reading of the bytes as int32."""
    b = torch.movedim(cw, axis, -1).to(torch.uint8).contiguous()
    return torch.movedim(b.view(torch.int32), -1, axis)


def unpack_bytes4(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_bytes4: [..., W] int32 -> [..., 4W] bytes (int32)."""
    b = torch.movedim(w, axis, -1).to(torch.int32).contiguous().view(torch.uint8)
    return torch.movedim(b.to(torch.int32), -1, axis)


def pack_int4(vals: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """[..., D] nibbles -> [..., D/8] int32 words. Byte k of word j holds
    value 4j+k in its LOW nibble and value D/2 + 4j+k in its HIGH nibble."""
    v = _last(vals, axis) & 0xF
    D = v.shape[-1]
    lo, hi = v[..., : D // 2], v[..., D // 2 :]
    w = pack_bytes4(lo | (hi << 4), axis=-1)
    return torch.movedim(w, -1, axis)


def unpack_int4(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of pack_int4: [..., W] -> [..., 8W] nibbles (int32)."""
    by = unpack_bytes4(torch.movedim(w, axis, -1))
    out = torch.cat([by & 0xF, by >> 4], dim=-1)
    return torch.movedim(out, -1, axis)


def int4_split(x: torch.Tensor):
    """Packed int4 words -> (lo, hi) nibble-in-byte-slot words."""
    return x & 0x0F0F0F0F, (x >> 4) & 0x0F0F0F0F


# =============================================================================
# hamming84: 4 codewords per int32 word, byte slots (SWAR)
# =============================================================================


def h84_swar_syndromes(x: torch.Tensor):
    """Per-byte SECDED syndromes of 4 codewords per int32 word: (a, b, c,
    podd), the syndrome bits s0/s1/s2 and odd overall parity, each in bit 0
    of every byte."""
    x1, x2, x3 = x >> 1, x >> 2, x >> 3
    x4, x5, x6 = x >> 4, x >> 5, x >> 6
    a = (x ^ x1 ^ x3 ^ x4) & M1
    b = (x ^ x2 ^ x3 ^ x5) & M1
    c = (x1 ^ x2 ^ x3 ^ x6) & M1
    p = x ^ x4
    p = p ^ (p >> 2)
    p = p ^ (p >> 1)
    return a, b, c, p & M1


def _h84_data_correction(a, b, c, single):
    """Data-nibble XOR masks from per-byte syndrome bits: syndromes
    {3, 5, 6, 7} flip data bits {0, 1, 2, 3}, the rest are parity-bit flips."""
    ab = a & b
    corr = (
        (ab & (c ^ M1))
        | ((a & (b ^ M1) & c) << 1)
        | (((a ^ M1) & b & c) << 2)
        | ((ab & c) << 3)
    )
    return corr & (single * 0xF)


def h84_swar_correct_data(x: torch.Tensor) -> torch.Tensor:
    """4 SECDED codewords per word -> 4 corrected data nibbles (byte slots);
    doubles keep their corrupt data (hamming84_correct_data_i32)."""
    a, b, c, podd = h84_swar_syndromes(x)
    single = (a | b | c) & podd
    return (x ^ _h84_data_correction(a, b, c, single)) & 0x0F0F0F0F


def h84_swar_decode(x: torch.Tensor):
    """h84_swar_correct_data plus the (singles, doubles) masks, bit 0 of
    each byte."""
    a, b, c, podd = h84_swar_syndromes(x)
    nonzero = a | b | c
    single = nonzero & podd
    double = nonzero & (podd ^ M1)
    corr = _h84_data_correction(a, b, c, single)
    return (x ^ corr) & 0x0F0F0F0F, single, double


def h84_swar_encode(n: torch.Tensor) -> torch.Tensor:
    """4 nibbles per word (byte slots) -> 4 SECDED codewords per word."""
    p0 = (n ^ (n >> 1) ^ (n >> 3)) & M1
    p1 = (n ^ (n >> 2) ^ (n >> 3)) & M1
    p2 = ((n >> 1) ^ (n >> 2) ^ (n >> 3)) & M1
    cw = n | (p0 << 4) | (p1 << 5) | (p2 << 6)
    q = cw ^ (cw >> 4)
    q = q ^ (q >> 2)
    q = q ^ (q >> 1)
    return cw | ((q & M1) << 7)


def h84_split_pack(cw: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """[..., pv] 8-bit codewords -> [..., pv/4] words: pack_int4 of the data
    nibbles, then pack_int4 of the parity nibbles (cw >> 4)."""
    cw = _last(cw, axis)
    out = torch.cat([pack_int4(cw & 0xF), pack_int4((cw >> 4) & 0xF)], dim=-1)
    return torch.movedim(out, -1, axis)


def h84_split_unpack(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of h84_split_pack: [..., W] -> [..., 4W] codewords."""
    w = _last(w, axis)
    half = w.shape[-1] // 2
    out = unpack_int4(w[..., :half]) | (unpack_int4(w[..., half:]) << 4)
    return torch.movedim(out, -1, axis)


def h84_rebuild_cw_words(dw: torch.Tensor, pw: torch.Tensor):
    """(data words, parity words) -> byte-slot codeword words (lo, hi): lo
    holds the codewords of values [0, pv/2), hi those of [pv/2, pv)."""
    lo = (dw & 0x0F0F0F0F) | ((pw & 0x0F0F0F0F) << 4)
    hi = ((dw >> 4) & 0x0F0F0F0F) | (((pw >> 4) & 0x0F0F0F0F) << 4)
    return lo, hi


# =============================================================================
# hamming74: int4-packed data nibbles + 3 bit-sliced parity planes
# =============================================================================


def _slice_pack(bits_vals: torch.Tensor, nbits: int, axis: int = -1) -> torch.Tensor:
    """[..., 32G] small ints -> [..., nbits*G] bit-sliced plane words
    (plane-major: word p*G + g holds bit p of value t*G + g at bit t). The
    32 bits of a word are gathered as 4 bytes, so no sum leaves int32."""
    x = _last(bits_vals, axis)
    pre = x.shape[:-1]
    G = x.shape[-1] // 32
    c = x.reshape(pre + (4, 8, G))  # value (8k + i) * G + g
    shifts = torch.arange(nbits, dtype=torch.int32, device=x.device)
    planes = (c[..., None] >> shifts) & 1  # [..., k, i, g, p]
    ibits = torch.arange(8, dtype=torch.int32, device=x.device).reshape(8, 1, 1)
    by = (planes << ibits).sum(-3, dtype=torch.int32)  # [..., k, g, p]: byte k
    by = by.movedim(-3, -1).movedim(-2, -3)  # [..., p, g, k]
    words = pack_bytes4(by).reshape(pre + (nbits * G,))
    return torch.movedim(words, -1, axis)


def _slice_unpack(w: torch.Tensor, nbits: int, axis: int = -1) -> torch.Tensor:
    """Inverse of _slice_pack: [..., nbits*G] plane words -> [..., 32G]."""
    w = _last(w, axis)
    pre = w.shape[:-1]
    G = w.shape[-1] // nbits
    planes = w.reshape(pre + (nbits, G))
    t = torch.arange(32, dtype=torch.int32, device=w.device).reshape(32, 1, 1)
    bits = (planes[..., None, :, :] >> t) & 1  # [..., t, p, g]
    p = torch.arange(nbits, dtype=torch.int32, device=w.device).reshape(nbits, 1)
    cw = (bits << p).sum(-2, dtype=torch.int32).reshape(pre + (32 * G,))
    return torch.movedim(cw, -1, axis)


def h74_split_pack(cw: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """[..., pv] 7-bit codewords -> [..., 7*pv/32] words: pack_int4 of the
    data nibbles (pv/8 words), then 3 bit-sliced parity planes (3*pv/32)."""
    cw = _last(cw, axis)
    out = torch.cat([pack_int4(cw & 0xF), _slice_pack((cw >> 4) & 7, 3)], dim=-1)
    return torch.movedim(out, -1, axis)


def h74_split_unpack(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of h74_split_pack: [..., W] -> [..., 32*W/7] codewords."""
    w = _last(w, axis)
    pv = 32 * w.shape[-1] // 7
    out = unpack_int4(w[..., : pv // 8]) | (_slice_unpack(w[..., pv // 8 :], 3) << 4)
    return torch.movedim(out, -1, axis)


def h74_plane_bits(plane: torch.Tensor, G: int) -> torch.Tensor:
    """One parity plane [G, bs] -> per-value bits [32G, bs] int32 0/1 (value
    v = t*G + g is bit t of plane word g)."""
    rep = torch.cat([plane.to(torch.int32)] * 32, dim=0)
    t = torch.arange(rep.shape[0], dtype=torch.int32, device=plane.device) // G
    return (rep >> t[:, None]) & 1


def h74_value_correct(d, p0, p1, p2):
    """Per-value Hamming(7,4) correction of data nibbles d with parity bits
    p0-p2 (0/1): returns (corrected nibbles, nonzero-syndrome mask 0/1)."""
    s0 = (d ^ (d >> 1) ^ (d >> 3) ^ p0) & 1
    s1 = (d ^ (d >> 2) ^ (d >> 3) ^ p1) & 1
    s2 = ((d >> 1) ^ (d >> 2) ^ (d >> 3) ^ p2) & 1
    corr = (
        (s0 & s1 & (s2 ^ 1))
        | ((s0 & (s1 ^ 1) & s2) << 1)
        | (((s0 ^ 1) & s1 & s2) << 2)
        | ((s0 & s1 & s2) << 3)
    )
    return d ^ corr, s0 | s1 | s2


# =============================================================================
# golay: third-partitioned 12-bit data words, data-first split rows
# =============================================================================


def golay_pack_thirds(vals: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """[..., 3C] nibbles -> [..., C] 12-bit data words:
    word c = v[c] | v[c+2C]<<4 | v[c+C]<<8."""
    v = _last(vals, axis) & 0xF
    c = v.shape[-1] // 3
    w = v[..., :c] | (v[..., 2 * c :] << 4) | (v[..., c : 2 * c] << 8)
    return torch.movedim(w, -1, axis)


def golay_unpack_thirds(data12: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of golay_pack_thirds: [..., C] -> [..., 3C] nibbles."""
    d = _last(data12, axis)
    out = torch.cat([d & 0xF, (d >> 8) & 0xF, (d >> 4) & 0xF], dim=-1)
    return torch.movedim(out, -1, axis)


def golay_pack4(cw: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """[..., 4G] 24-bit codewords -> [..., 3G] int32 words, byte-plane
    packed: plane p (words [p G, (p + 1) G)) holds byte p of the codewords,
    byte k of word j codeword 4j + k. 8.0 bits a value; no decode path
    stores it (JAX's layout of an earlier TPU round)."""
    cw = _last(cw, axis).to(torch.int32)
    planes = [pack_bytes4((cw >> (8 * p)) & 0xFF, axis=-1) for p in range(3)]
    return torch.movedim(torch.cat(planes, dim=-1), -1, axis)


def golay_unpack4(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of golay_pack4: [..., 3G] words -> [..., 4G] codewords."""
    w = _last(w, axis).to(torch.int32)
    G = w.shape[-1] // 3
    cw = torch.zeros(w.shape[:-1] + (4 * G,), dtype=torch.int32, device=w.device)
    for p in range(3):
        cw = cw | (unpack_bytes4(w[..., p * G:(p + 1) * G], axis=-1) << (8 * p))
    return torch.movedim(cw, -1, axis)


def golay_data_nibbles(head_dim: int) -> int:
    """Nibble count of the golay row's int4-packed data prefix:
    round_up(head_dim, 8) when the padded value count allows it, else the
    previous multiple of 8 below it."""
    pv = padded_values("golay", head_dim)
    rd = round_up(head_dim, 8)
    return rd if rd <= pv else pv - pv % 8


def golay_prefix_covers_values(head_dim: int) -> bool:
    """True iff values [0, head_dim) all live in the golay data prefix."""
    return golay_data_nibbles(head_dim) >= head_dim


def golay_split_pack(cw: torch.Tensor, head_dim: int, axis: int = -1) -> torch.Tensor:
    """[..., C4] 24-bit codewords -> [..., 3*C4/4] int32 words, data-first:
    pack_int4 of the data nibbles [0, rD), then pack_int4 of [codeword bits
    12-15 (C4 nibbles), padding data nibbles [rD, 3*C4)], then the byte
    plane of bits 16-23."""
    cw = _last(cw, axis)
    rd = golay_data_nibbles(head_dim)
    nib = golay_unpack_thirds(cw & 0xFFF, axis=-1)
    d = pack_int4(nib[..., :rd], axis=-1)
    p = pack_int4(torch.cat([(cw >> 12) & 0xF, nib[..., rd:]], dim=-1), axis=-1)
    ph = pack_bytes4((cw >> 16) & 0xFF, axis=-1)
    return torch.movedim(torch.cat([d, p, ph], dim=-1), -1, axis)


def golay_split_unpack(w: torch.Tensor, head_dim: int, axis: int = -1) -> torch.Tensor:
    """Inverse of golay_split_pack: [..., W] -> [..., 4W/3] codewords."""
    w = _last(w, axis)
    W = w.shape[-1]
    c4 = 4 * W // 3
    rd = golay_data_nibbles(head_dim)
    d_nib = unpack_int4(w[..., : rd // 8], axis=-1)
    ptail = unpack_int4(w[..., rd // 8 : W - c4 // 4], axis=-1)
    plo, padnib = ptail[..., :c4], ptail[..., c4:]
    d12 = golay_pack_thirds(torch.cat([d_nib, padnib], dim=-1), axis=-1)
    phi = unpack_bytes4(w[..., W - c4 // 4 :], axis=-1)
    return torch.movedim(d12 | (plo << 12) | (phi << 16), -1, axis)


def _bm_bcast(ndim: int, device) -> torch.Tensor:
    """B-row masks on a leading candidate axis, broadcastable against an
    ndim-rank codeword tensor."""
    return torch.tensor(_B_MASKS, dtype=torch.int32, device=device).reshape(
        (12,) + (1,) * ndim)


def _imld_error(s: torch.Tensor):
    """Arithmetic IMLD on 12-bit syndromes, the 12-candidate loops on a
    leading axis: returns (24-bit error pattern, correctable). At most one
    candidate can hit per stage (B rows are pairwise >= 6 apart), so hits are
    summed. Same arithmetic as common.golay_decode_i32."""
    pc = C.popcount
    bm = _bm_bcast(s.ndim, s.device)
    iv = torch.arange(12, dtype=torch.int32, device=s.device).reshape((12,) + (1,) * s.ndim)
    zero = torch.zeros_like(s)
    e1 = s << 12
    ok1 = pc(s) <= 3
    cand2 = s[None] ^ bm
    hit2 = pc(cand2) <= 2
    e2 = torch.where(hit2, (1 << iv) | (cand2 << 12), 0).sum(0, dtype=torch.int32)
    ok2 = hit2.any(0)
    q = ((pc(s[None] & bm) & 1) << iv).sum(0, dtype=torch.int32)
    ok3 = pc(q) <= 3
    cand4 = q[None] ^ bm
    hit4 = pc(cand4) <= 2
    e4 = torch.where(hit4, cand4 | (1 << (12 + iv)), 0).sum(0, dtype=torch.int32)
    ok4 = hit4.any(0)
    e = torch.where(ok1, e1, torch.where(ok2, e2, torch.where(ok3, q, torch.where(ok4, e4, zero))))
    return e, ok1 | ok2 | ok3 | ok4


@functools.lru_cache(maxsize=None)
def _golay_tables(device: torch.device):
    """Per-device tables over all 4096 12-bit words: the parity p(d) = d . B
    (XOR of B's rows j over the set bits j of d; B is symmetric), and the
    IMLD error pattern of each syndrome, -1 where uncorrectable. A
    syndrome alone determines the decoder's error estimate, so looking it up
    gives the arithmetic decoder's bits."""
    d = torch.arange(4096, dtype=torch.int32)
    parity = torch.zeros_like(d)
    for j in range(12):
        parity = parity ^ (-((d >> j) & 1) & _B_MASKS[j])
    err, ok = _imld_error(d)
    return parity.to(device), torch.where(ok, err, -1).to(device)


def golay_parity_xor(d12: torch.Tensor) -> torch.Tensor:
    """12 parity bits of 12-bit data words, p = d12 . B over GF(2) (looked
    up). Same bits as (golay_encode_wide(d12) >> 12) & 0xFFF."""
    return _golay_tables(d12.device)[0][d12]


def golay_encode_wide(data12: torch.Tensor) -> torch.Tensor:
    """12-bit data -> 24-bit codewords."""
    return data12 | (golay_parity_xor(data12) << 12)


def golay_pack_rows_from_nibbles(qn: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Padded data nibbles [..., 3*C4] (thirds order) -> packed storage rows
    [..., W]. Same bits as golay_split_pack(golay_encode_wide(
    golay_pack_thirds(qn)), head_dim), without the pack/unpack round trip."""
    qn = qn.to(torch.int32) & 0xF
    p12 = golay_parity_xor(golay_pack_thirds(qn))
    rd = golay_data_nibbles(head_dim)
    d = pack_int4(qn[..., :rd])
    ptail = pack_int4(torch.cat([p12 & 0xF, qn[..., rd:]], dim=-1))
    ph = pack_bytes4((p12 >> 4) & 0xFF)
    return torch.cat([d, ptail, ph], dim=-1)


def golay_decode_wide(cw: torch.Tensor, *, zero_uncorrectable: bool):
    """IMLD Golay decode: the syndrome is looked up in the table of the
    arithmetic decoder's error patterns. Same bits as
    common.golay_decode_i32.

    Returns (data12, error_count 0-3 | 4)."""
    cw = cw.to(torch.int32)
    err = _golay_tables(cw.device)[1][golay_parity_xor(cw & 0xFFF) ^ ((cw >> 12) & 0xFFF)]
    ok = err >= 0
    fallback = torch.zeros_like(cw) if zero_uncorrectable else cw & 0xFFF
    data = torch.where(ok, (cw ^ err) & 0xFFF, fallback)
    return data, torch.where(ok, C.popcount(err & 0xFFFFFF), 4)


# =============================================================================
# Counter-hash Bernoulli flips (read-time injection inside the kernels)
# =============================================================================

_M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2^32 for z in [0, 2^32) held in int64: the product is
    split at 16 bits of c, so no partial product leaves int64."""
    lo = z * (c & 0xFFFF)
    hi = ((z * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _murmur_mix(z: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on unsigned 32-bit values held in int64
    (JAX's int32 version: its arithmetic shifts are masked to the logical
    ones, its products wrap)."""
    z = z ^ (z >> 16)
    z = _mul32(z, 0x85EBCA6B)
    z = z ^ (z >> 13)
    z = _mul32(z, 0xC2B2AE35)
    return z ^ (z >> 16)


def hash_flip_mask(seed, base, shape, threshold: int, n_bits: int = 32) -> torch.Tensor:
    """Deterministic Bernoulli bit-flip mask, bit for bit JAX's
    ``swar.hash_flip_mask``: bit b of the element at (r, ..., l) of
    ``shape`` flips when murmur((((base + r * shape[-1] + l) * n_bits + b)
    * 0x9E3779B9 + seed) mod 2^32) < threshold, unsigned. ``seed``: an int
    or an integer tensor (read as int32); ``base``: an int or an integer
    tensor broadcastable against ``shape`` (each tile its own base).
    Returns int32."""
    dev = base.device if torch.is_tensor(base) else (
        seed.device if torch.is_tensor(seed) else None)
    r = torch.arange(shape[0], dtype=torch.int64, device=dev).reshape(
        (shape[0],) + (1,) * (len(shape) - 1))
    l = torch.arange(shape[-1], dtype=torch.int64, device=dev)
    elem = (r * shape[-1] + l).expand(tuple(shape))
    base = torch.as_tensor(base, device=dev).to(torch.int64)
    seed = torch.as_tensor(seed, device=dev).to(torch.int64) & _M32
    c0 = (((base + elem) & _M32) * n_bits) & _M32
    mask = torch.zeros(torch.broadcast_shapes(base.shape, elem.shape), dtype=torch.int64,
                       device=dev)
    for b in range(n_bits):
        z = _murmur_mix((_mul32((c0 + b) & _M32, 0x9E3779B9) + seed) & _M32)
        mask = mask | ((z < int(threshold)).to(torch.int64) << b)
    return (mask - ((mask >> 31) << 32)).to(torch.int32)


# =============================================================================
# Row packing by codec
# =============================================================================


def padded_values(codec: str, head_dim: int) -> int:
    """Protected values per row after padding to the codec's granularity."""
    if codec in ("int4", "hamming84"):
        return round_up(head_dim, 8)
    if codec == "hamming74":
        return round_up(head_dim, 32)
    if codec == "golay":
        return 3 * round_up(-(-head_dim // 3), 4)
    if codec in FLOAT_CODECS:
        return head_dim
    unsupported(codec)


def row_words(codec: str, head_dim: int) -> int:
    """int32 storage words per (token, head) row (fp16 / fp8: elements)."""
    pv = padded_values(codec, head_dim)
    if codec in FLOAT_CODECS:
        return head_dim
    if codec == "int4":
        return pv // 8
    if codec == "hamming74":
        return 7 * pv // 32
    if codec == "hamming84":
        return pv // 4
    return 3 * (pv // 3) // 4  # golay


def data_words(codec: str, head_dim: int) -> int:
    """int32 words of the row's data prefix - the only words a scrubbed read
    streams (16 for head_dim 128 in every codec)."""
    if codec == "golay":
        return golay_data_nibbles(head_dim) // 8
    if codec in ("int4", "hamming74", "hamming84"):
        return padded_values(codec, head_dim) // 8
    if codec in FLOAT_CODECS:
        return head_dim  # the whole row is data
    unsupported(codec)


def parity_words(codec: str, head_dim: int) -> int:
    """int32 words of the row's parity suffix (0 for int4, fp16, fp8)."""
    return row_words(codec, head_dim) - data_words(codec, head_dim)


def split_rows(codec: str, packed: torch.Tensor, head_dim: int, axis: int = -1):
    """Full packed rows -> (data, parity) of the split cache arrays; parity
    is None when the codec has none."""
    dw = data_words(codec, head_dim)
    packed = torch.movedim(packed, axis, -1)
    if parity_words(codec, head_dim) == 0:
        return torch.movedim(packed, -1, axis), None
    return (torch.movedim(packed[..., :dw], -1, axis),
            torch.movedim(packed[..., dw:], -1, axis))


def join_rows(codec: str, data: torch.Tensor, parity, axis: int = -1):
    """Inverse of split_rows."""
    if parity is None:
        return data
    return torch.cat([data, parity], dim=axis)


def scrub_extract_ok(codec: str, head_dim: int) -> bool:
    """True iff every value in [0, head_dim) lives in the int4-packed data
    prefix, so a scrubbed read extracts nibbles without decoding."""
    if codec == "golay":
        return golay_prefix_covers_values(head_dim)
    if codec in ("int4", "hamming74", "hamming84") or codec in FLOAT_CODECS:
        return True
    unsupported(codec)


def pack_codewords(codec: str, cw: torch.Tensor, head_dim: int, axis: int = -1):
    """Per-value logical codewords -> packed int32 storage words (int4 /
    hamming74 / hamming84: padded_values() nibbles / 7-bit / 8-bit codewords;
    golay: padded_values()//3 24-bit codewords)."""
    if codec == "int4":
        return pack_int4(cw, axis=axis)
    if codec == "hamming74":
        return h74_split_pack(cw, axis=axis)
    if codec == "hamming84":
        return h84_split_pack(cw, axis=axis)
    if codec == "golay":
        return golay_split_pack(cw, head_dim, axis=axis)
    unsupported(codec)


def unpack_codewords(codec: str, w: torch.Tensor, head_dim: int, axis: int = -1):
    """Inverse of pack_codewords."""
    if codec == "int4":
        return unpack_int4(w, axis=axis)
    if codec == "hamming74":
        return h74_split_unpack(w, axis=axis)
    if codec == "hamming84":
        return h84_split_unpack(w, axis=axis)
    if codec == "golay":
        return golay_split_unpack(w, head_dim, axis=axis)
    unsupported(codec)


def _pad_values(q: torch.Tensor, pv: int) -> torch.Tensor:
    pad = pv - q.shape[-1]
    return torch.nn.functional.pad(q, (0, pad)) if pad else q


def golay_data12(q: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Quantized nibbles [..., head_dim] -> third-partitioned 12-bit data
    words [..., C4] (the golay padding + packing step)."""
    q = _pad_values(q.to(torch.int32), padded_values("golay", head_dim))
    return golay_pack_thirds(q & 0xF)


def encode_codewords(codec: str, q: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Quantized nibbles [..., head_dim] -> per-value logical codewords (the
    injection domain), padded to the codec's packing granularity."""
    if codec == "golay":
        return golay_encode_wide(golay_data12(q, head_dim))
    q = _pad_values(q.to(torch.int32), padded_values(codec, head_dim)) & 0xF
    if codec == "int4":
        return q
    if codec == "hamming74":
        return C.hamming74_encode_i32(q)
    return C.hamming84_encode_i32(q)


def encode_row(codec: str, q: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Quantized nibbles [..., head_dim] -> packed int32 words [..., W],
    without fault injection (inject on the logical codewords of
    encode_codewords, then pack_codewords)."""
    return pack_codewords(codec, encode_codewords(codec, q, head_dim), head_dim)


def scrub_fold_mask(codec: str, mask: torch.Tensor) -> torch.Tensor:
    """Fold the write-path scrub into the injection mask.

    For a linear code the scrub's correction of encode(q) ^ mask depends on
    the mask alone, so the scrubbed codeword is encode(q ^ delta). Returns the
    delta in the nibble domain:
      int4 / hamming74 / hamming84: the nibble delta (mask shape);
      golay: per-value nibble | (uncorrectable << 4) over the padded values
             [..., 3C]; apply as where(bit4, 0, q ^ (delta & 0xF))."""
    mask = mask.to(torch.int32)
    if codec == "int4":
        return mask & 0xF
    if codec == "hamming74":
        return C.hamming74_correct_data_i32(mask)
    if codec == "hamming84":
        return C.hamming84_correct_data_i32(mask)
    if codec == "golay":
        d, cnt = golay_decode_wide(mask, zero_uncorrectable=False)
        dn = golay_unpack_thirds(d)
        # value v lives in codeword v % C: the flag tiles three times
        un = torch.cat([(cnt == 4).to(torch.int32)] * 3, dim=-1)
        return dn | (un << 4)
    unsupported(codec)


def scrub_codewords(codec: str, cw: torch.Tensor) -> torch.Tensor:
    """Write-path scrub: decode each logical codeword and re-encode its
    corrected data (uncorrectable golay -> the all-zero codeword; hamming84
    doubles re-encode their kept data)."""
    if codec == "int4":
        return cw
    if codec == "hamming74":
        return C.hamming74_encode_i32(C.hamming74_correct_data_i32(cw))
    if codec == "hamming84":
        return C.hamming84_encode_i32(C.hamming84_correct_data_i32(cw))
    if codec == "golay":
        d12, _ = golay_decode_wide(cw, zero_uncorrectable=True)
        return golay_encode_wide(d12)
    unsupported(codec)


def decode_values(codec: str, cw: torch.Tensor, head_dim: int, *,
                  zero_uncorrectable: bool = False) -> torch.Tensor:
    """Logical codewords -> corrected nibbles [..., head_dim]."""
    if codec == "int4":
        dec = cw.to(torch.int32) & 0xF
    elif codec == "hamming74":
        dec = C.hamming74_correct_data_i32(cw.to(torch.int32))
    elif codec == "hamming84":
        dec = C.hamming84_correct_data_i32(cw.to(torch.int32))
    elif codec == "golay":
        d12, _ = golay_decode_wide(cw, zero_uncorrectable=zero_uncorrectable)
        dec = golay_unpack_thirds(d12)
    else:
        unsupported(codec)
    return dec[..., :head_dim]
