"""The cache's arithmetic written from its definitions: symmetric INT4
quantization, Hamming(8,4) SECDED, Hamming(7,4), the extended Golay(24,12)
code, the bit-flip draw, and the packed storage rows.

Plain torch on whatever device the tensors are on. Nothing here imports the
program: every table is built from the code's definition (the generator
matrices, the syndrome of each error pattern), and the storage format and
the flip draw are written out as the program documents them, so that this
side can say what a stored word and a read value ought to be.

A linear code makes the read a function of the clean nibble q and the flip
pattern e alone: decoding encode(q) ^ e gives q ^ delta(e), where delta(e) is
the data part of e minus the decoder's correction. So the tables below are
indexed by error patterns.
"""

from __future__ import annotations

import functools
import itertools

import torch

# ---------------------------------------------------------------- the draw


def flip_pattern(shape, ber: float, n_bits: int, generator: torch.Generator,
                 select=None) -> torch.Tensor:
    """Bit b of each element is set where a uniform draw for (element, b) is
    below ``ber``: one torch.rand of (n_bits, *shape) on the generator's
    device, as the program draws its write flips (int32). ``select`` picks
    the elements wanted from the draws (the bit axis first) before they are
    combined."""
    u = torch.rand((n_bits,) + tuple(shape), generator=generator, device=generator.device)
    if select is not None:
        u = select(u)
    out = torch.zeros(u.shape[1:], dtype=torch.int32, device=u.device)
    for b in range(n_bits):
        out |= (u[b] < ber).to(torch.int32) << b
    return out


# ---------------------------------------------------------------- INT4


def quantize_int4(x: torch.Tensor):
    """Per-row symmetric INT4 of x [..., D] float32: scale absmax / 7 (1 for
    an all-zero row), q = clamp(round_half_even(x / scale), -8, 7) + 8.
    Returns (q uint8 in 0..15, scale float32 [...])."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, torch.ones_like(absmax), absmax / 7.0)
    q = torch.clamp(torch.round(x / scale[..., None]), -8, 7) + 8
    return q.to(torch.uint8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.float32) - 8.0) * scale[..., None]


def _bit(x, i):
    return (x >> i) & 1


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


# ---------------------------------------------------------------- Hamming


def h74_encode(d: int) -> int:
    """Data bits 0-3, parity p0 = d0^d1^d3 (bit 4), p1 = d0^d2^d3 (bit 5),
    p2 = d1^d2^d3 (bit 6)."""
    p0 = _bit(d, 0) ^ _bit(d, 1) ^ _bit(d, 3)
    p1 = _bit(d, 0) ^ _bit(d, 2) ^ _bit(d, 3)
    p2 = _bit(d, 1) ^ _bit(d, 2) ^ _bit(d, 3)
    return d | p0 << 4 | p1 << 5 | p2 << 6


def h84_encode(d: int) -> int:
    """Hamming(7,4) and bit 7 making the byte's parity even."""
    c = h74_encode(d)
    return c | _parity(c) << 7


def _h7_syndrome(c: int) -> int:
    """The syndrome of a 7-bit word: the column of H that a single flipped
    bit adds (H's columns are each bit's parity checks)."""
    s = 0
    for i in range(7):
        if _bit(c, i):
            s ^= _H7_COLUMNS[i]
    return s


# each bit's checks: data bit j takes part in the parities that cover it,
# parity bit k in its own check alone
_H7_COLUMNS = tuple(
    (_bit(h74_encode(1 << i), 4) | _bit(h74_encode(1 << i), 5) << 1 | _bit(h74_encode(1 << i), 6) << 2)
    if i < 4 else 1 << (i - 4) for i in range(7))
_H7_BIT_OF = {col: i for i, col in enumerate(_H7_COLUMNS)}


@functools.lru_cache(maxsize=None)
def hamming_tables(device: str):
    """Tables over error patterns: (h84 data delta [256], h84 class [256]
    with 0 clean, 1 single, 2 double, 3 the overall parity bit alone; h74
    data delta [128]; h74 nonzero syndrome [128]). SECDED: a nonzero syndrome with odd overall parity
    is a single error, corrected; with even parity a double, detected and
    left; Hamming(7,4) corrects any nonzero syndrome as a single."""
    d84, k84, d74, s74 = [], [], [], []
    for e in range(256):
        s, odd = _h7_syndrome(e & 0x7F), _parity(e)
        corr = 1 << _H7_BIT_OF[s] if (s and odd) else 0
        d84.append((e ^ corr) & 0xF)
        k84.append(0 if (s == 0 and not odd) else 3 if s == 0 else 1 if odd else 2)
    for e in range(128):
        s = _h7_syndrome(e)
        d74.append((e ^ (1 << _H7_BIT_OF[s] if s else 0)) & 0xF)
        s74.append(int(s != 0))
    t = lambda v: torch.tensor(v, dtype=torch.uint8, device=device)  # noqa: E731
    return t(d84), t(k84), t(d74), t(s74)


def h84_valid(w: torch.Tensor) -> torch.Tensor:
    """Whether 8-bit words are codewords: the data's parities and an even
    byte."""
    w = w.to(torch.int32)
    return _h84_encode_t(w & 0xF) == (w & 0xFF)


def h74_valid(w: torch.Tensor) -> torch.Tensor:
    w = w.to(torch.int32)
    return (_h84_encode_t(w & 0xF) & 0x7F) == (w & 0x7F)


def _h84_encode_t(d: torch.Tensor) -> torch.Tensor:
    table = torch.tensor([h84_encode(i) for i in range(16)], dtype=torch.int32, device=d.device)
    return table[d.long()]


def h84_encode_t(d: torch.Tensor) -> torch.Tensor:
    return _h84_encode_t(d.to(torch.int32))


def h74_encode_t(d: torch.Tensor) -> torch.Tensor:
    return _h84_encode_t(d.to(torch.int32)) & 0x7F


# ---------------------------------------------------------------- Golay


def golay_b_rows() -> tuple:
    """The 12 x 12 matrix B of the extended Golay code, bit j of row i =
    B[i, j]: the back-circulant of the quadratic residues mod 11 {1, 3, 4,
    5, 9} (and 0), bordered by ones, with B[11, 11] = 0."""
    residues = {0, 1, 3, 4, 5, 9}
    rows = []
    for i in range(12):
        r = 0
        for j in range(12):
            if i == 11 or j == 11:
                b = int(i != j)
            else:
                b = int((i + j) % 11 in residues)
            r |= b << j
        rows.append(r)
    return tuple(rows)


_B = golay_b_rows()


def golay_parity(d: int) -> int:
    """12 parity bits of 12 data bits: bit j = parity(d & B[j])."""
    return sum(_parity(d & _B[j]) << j for j in range(12))


def golay_syndrome(w: int) -> int:
    return golay_parity(w & 0xFFF) ^ (w >> 12 & 0xFFF)


@functools.lru_cache(maxsize=None)
def golay_tables(device: str):
    """(parity of each 12-bit word [4096], the error pattern of weight <= 3
    of each syndrome or -1 [4096]). The code has distance 8, so the
    patterns of weight 0-3 (2325 of them) have distinct syndromes; every
    other syndrome (weight-4 cosets) is uncorrectable."""
    parity = [golay_parity(d) for d in range(4096)]
    leader = [-1] * 4096
    for w in range(4):
        for bits in itertools.combinations(range(24), w):
            e = sum(1 << b for b in bits)
            s = parity[e & 0xFFF] ^ (e >> 12)
            if leader[s] != -1:
                raise AssertionError("two patterns of weight <= 3 share a syndrome")
            leader[s] = e
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return t(parity), t(leader)


def golay_syndrome_t(w: torch.Tensor) -> torch.Tensor:
    parity, _ = golay_tables(str(w.device))
    w = w.to(torch.int32)
    return parity[(w & 0xFFF).long()] ^ (w >> 12 & 0xFFF)


def golay_decode_error(e: torch.Tensor):
    """For flip patterns e (int32, 24 bits): (data delta, 12 bits, that
    decoding encode(d) ^ e adds to d; correctable; errors the decoder
    counts: the weight of its estimate, 4 where uncorrectable)."""
    _, leader = golay_tables(str(e.device))
    est = leader[golay_syndrome_t(e).long()]
    ok = est >= 0
    delta = torch.where(ok, (e ^ est) & 0xFFF, e & 0xFFF)
    weight = torch.zeros_like(est)
    for b in range(24):
        weight += (est >> b) & 1
    return delta, ok, torch.where(ok, weight, 4)


# ---------------------------------------------------------------- storage


def padded_values(codec: str, head_dim: int) -> int:
    """Values a row protects after padding: int4 and hamming84 to 8,
    hamming74 to 32, golay to three times a multiple of 4 codewords."""
    if codec in ("int4", "hamming84"):
        return -(-head_dim // 8) * 8
    if codec == "hamming74":
        return -(-head_dim // 32) * 32
    if codec == "golay":
        codewords = -(-head_dim // 3)
        return 3 * (-(-codewords // 4) * 4)
    raise ValueError(codec)


def golay_codeword_of_value(pv: int) -> tuple:
    """Value v of pv = 3C values lives in codeword v % C: nibble 0 (bits
    0-3) holds value c, nibble 1 value c + 2C, nibble 2 value c + C.
    Returns (codeword index [pv], shift [pv])."""
    C = pv // 3
    v = torch.arange(pv)
    third = v // C
    shift = torch.tensor([0, 8, 4], dtype=torch.int32)[third]
    return v % C, shift


def unpack_nibbles(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words -> [..., 8W] nibbles: byte k of word j (little
    endian) holds value 4j + k in its low nibble and value 4W + 4j + k in
    its high nibble."""
    b = unpack_bytes(words)
    return torch.cat([b & 0xF, b >> 4], dim=-1)


def unpack_bytes(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 -> [..., 4W] bytes (int32), byte k of word j at 4j + k."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    parts = [(w >> (8 * k)) & 0xFF for k in range(4)]
    return torch.stack(parts, dim=-1).reshape(w.shape[:-1] + (4 * w.shape[-1],)).to(torch.int32)


def stored_codewords(codec: str, rows: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Full stored rows [..., W] (data words, then parity words) -> the
    logical codewords [..., n] int32: hamming84 and int4 one per padded
    value; golay one per third of the padded values.

      int4:      the data words' nibbles;
      hamming84: the data nibbles, then the parity nibbles (codeword bits
                 4-7) packed the same way;
      golay:     the data nibbles of values [0, rD) (rD = head_dim rounded
                 up to 8, or down when the padding is narrower), then the
                 nibbles of [parity bits 0-3 of each codeword, values
                 [rD, 3C)], then the bytes of parity bits 4-11."""
    pv = padded_values(codec, head_dim)
    if codec == "int4":
        return unpack_nibbles(rows)
    if codec == "hamming84":
        dw = pv // 8
        return unpack_nibbles(rows[..., :dw]) | unpack_nibbles(rows[..., dw:2 * dw]) << 4
    if codec == "golay":
        C = pv // 3
        rd = -(-head_dim // 8) * 8
        if rd > pv:
            rd = pv - pv % 8
        dwords = rd // 8
        tail_words = (C + pv - rd) // 8
        data = unpack_nibbles(rows[..., :dwords])
        tail = unpack_nibbles(rows[..., dwords:dwords + tail_words])
        high = unpack_bytes(rows[..., dwords + tail_words:dwords + tail_words + C // 4])
        values = torch.cat([data, tail[..., C:]], dim=-1)  # [..., pv]
        cw_idx, shift = golay_codeword_of_value(pv)
        d12 = torch.zeros(values.shape[:-1] + (C,), dtype=torch.int32, device=rows.device)
        d12.index_add_(-1, cw_idx.to(rows.device), values << shift.to(rows.device))
        return d12 | tail[..., :C] << 12 | high << 16
    raise ValueError(f"no storage reading for codec {codec}")


def golay_values_of_data(d12: torch.Tensor, pv: int) -> torch.Tensor:
    """[..., C] 12-bit words -> [..., pv] nibbles (value order)."""
    cw_idx, shift = golay_codeword_of_value(pv)
    return (d12[..., cw_idx.to(d12.device)] >> shift.to(d12.device)) & 0xF


def golay_data_of_values(values: torch.Tensor) -> torch.Tensor:
    """[..., pv] nibbles -> [..., C] 12-bit words."""
    pv = values.shape[-1]
    cw_idx, shift = golay_codeword_of_value(pv)
    out = torch.zeros(values.shape[:-1] + (pv // 3,), dtype=torch.int32, device=values.device)
    out.index_add_(-1, cw_idx.to(values.device), values.to(torch.int32) << shift.to(values.device))
    return out
