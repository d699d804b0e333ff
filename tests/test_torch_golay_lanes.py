"""The byte-lane Golay decode of decode_attend.cu (golay.cuh
decode_row_lanes), held on the CPU.

Its premise: in a row of swar.golay_split_pack, every field of codeword c
= 4g + k - the three data nibbles (values c, c + 2C, c + C), the low parity
nibble and the high parity byte - lies in byte k of a word, in the half the
decode reads, at every Golay instance of DECODE_KERNEL_SHAPES. Then a plain
model of the decode's steps (prmt lookups of the products by B, the bit-3
rows under masks, the gather from golay_read_table) against the
plain decode of the correcting reads (decode_rows, count_errors' counts),
on codewords with 0 to 6 bit errors.
"""

import pytest
import torch

from qkv_ecc_tpu_torch.kernels import common as C
from qkv_ecc_tpu_torch.kernels import paged_attention as pa
from qkv_ecc_tpu_torch.kernels import swar

# (data words, parity words, head_dim) of every Golay instance
GOLAY_WORDS = sorted({(w, p, h) for c, w, p, _, h in pa.DECODE_KERNEL_SHAPES if c == "golay"})


def value_lanes(wd, pw, v):
    """golay.cuh value_lanes: (word of the row, high nibble) of value v."""
    c4 = 4 * (wd + pw) // 3
    pt = pw - c4 // 4
    if v < 8 * wd:
        return v % (4 * wd) // 4, v >= 4 * wd
    n = c4 + v - 8 * wd
    return wd + n % (4 * pt) // 4, n >= 4 * pt


def group_fields(wd, pw, g):
    """The (word, high nibble) of each field of group g's codewords, in
    decode_group's order: data nibbles 0-2 of d12 (values c, c + 2C,
    c + C), the low parity nibble; and the high parity bytes' word."""
    c4 = 4 * (wd + pw) // 3
    pt = pw - c4 // 4
    c = 4 * g
    data = [value_lanes(wd, pw, c + off) for off in (0, 2 * c4, c4)]
    low_parity = (wd + c % (4 * pt) // 4, c >= 4 * pt)
    return data + [low_parity], wd + pt + g


@pytest.mark.parametrize("wd,pw,head_dim", GOLAY_WORDS)
def test_fields_lie_in_the_byte_lanes_the_decode_reads(wd, pw, head_dim):
    c4 = 4 * (wd + pw) // 3
    assert c4 % 4 == 0 and (wd + pw) % 3 == 0
    # each codeword's fields made distinct: field f of codeword c reads
    # (c + f) % 16, its parity byte 255 - c
    cw = torch.zeros(c4, dtype=torch.int32)
    for c in range(c4):
        d12 = (c % 16) | ((c + 1) % 16) << 4 | ((c + 2) % 16) << 8
        cw[c] = d12 | ((c + 3) % 16) << 12 | (255 - c) << 16
    row = swar.golay_split_pack(cw, head_dim)
    assert row.shape == (wd + pw,)
    assert torch.equal(swar.golay_split_unpack(row, head_dim), cw)
    words = [int(x) & 0xFFFFFFFF for x in row]
    for g in range(c4 // 4):
        nibbles, parity_word = group_fields(wd, pw, g)
        for k in range(4):
            c = 4 * g + k
            for f, (word, hi) in enumerate(nibbles):
                assert (words[word] >> (8 * k + 4 * hi)) & 0xF == (c + f) % 16, (g, k, f)
            assert (words[parity_word] >> (8 * k)) & 0xFF == 255 - c, (g, k)


def prmt(lo, hi, sel):
    """prmt.b32 on int64 tensors (golay.cuh prmt)."""
    b = (hi << 32) | lo
    sel = torch.as_tensor(sel, dtype=torch.int64)
    out = torch.zeros_like(lo)
    for k in range(4):
        n = (sel >> (4 * k)) & 15
        byte = (b >> (8 * (n & 7))) & 0xFF
        byte = torch.where((n & 8) != 0, torch.where(byte >= 0x80, 0xFF, 0), byte)
        out = out | (byte << (8 * k))
    return out


def lane_table(f, hi, half):
    t = 0
    for k in range(4):
        n = 4 * half + k
        s = 0
        for b in range(3):
            if n >> b & 1:
                s ^= swar._B_MASKS[4 * f + b]
        t |= ((s >> 4) & 0xFF if hi else s & 0xF) << (8 * k)
    return t


def lane_row3(f, hi):
    r = swar._B_MASKS[4 * f + 3]
    return ((r >> 4) & 0xFF if hi else r & 0xF) * 0x01010101


def lane_decode(rows, wd, pw, table):
    """The steps of decode_row_lanes on int64 rows [n, wd + pw] -> (data
    words [n, wd], corrected, detected)."""
    m32 = 0xFFFFFFFF
    w = rows.long() & m32
    out = [w[:, j].clone() for j in range(wd)]
    corrected = torch.zeros(len(rows), dtype=torch.int64)
    detected = torch.zeros_like(corrected)
    nibble = {False: 0x0F0F0F0F, True: 0xF0F0F0F0}
    for g in range((wd + pw) // 3):
        nibbles, parity_word = group_fields(wd, pw, g)
        hi = w[:, parity_word]
        pword, phi = nibbles[3]
        lo = (w[:, pword] >> 4 if phi else w[:, pword]) & 0x0F0F0F0F
        for f, (word, half) in enumerate(nibbles[:3]):
            x = w[:, word]
            packed = ((x & 0x70707070) * 0x11 if half else (x & 0x07070707) * 0x110) & m32
            sel = prmt(packed, torch.zeros_like(x), 0x0031)
            b3 = prmt(x if half else (x * 16) & m32, torch.zeros_like(x), 0xBA98)
            for plane in (True, False):
                product = prmt(torch.full_like(x, lane_table(f, plane, 0)),
                               torch.full_like(x, lane_table(f, plane, 1)), sel)
                term = product ^ (b3 & lane_row3(f, plane))
                if plane:
                    hi = hi ^ term
                else:
                    lo = lo ^ term
        e = [table[prmt(hi, lo, sel) & 0xFFFF] for sel in (0xCC40, 0xDD51, 0xEE62, 0xFF73)]
        e01, e23 = prmt(e[0], e[1], 0x5140), prmt(e[2], e[3], 0x5140)
        low, top = prmt(e01, e23, 0x5410), prmt(e01, e23, 0x7632)
        bad = prmt((top * 2) & m32, torch.zeros_like(top), 0xBA98)
        for f, (word, half) in enumerate(nibbles[:3]):
            if word >= wd:
                continue
            src, src_hi = (low, True) if f == 1 else (low if f == 0 else top, False)
            v = src if src_hi == half else (src >> 4 if src_hi else (src * 16) & m32)
            out[word] = (out[word] ^ (v & nibble[half])) & ~(bad & nibble[half]) & m32
        for k in range(4):
            weight = (top >> (8 * k + 4)) & 7
            corrected += torch.where(weight < 4, weight, 0)
            detected += weight == 4
    return torch.stack(out, dim=1), corrected, detected


@pytest.mark.parametrize("wd,pw,head_dim", GOLAY_WORDS)
def test_lane_decode_model_matches_the_plain_decode(wd, pw, head_dim):
    gen = torch.Generator().manual_seed(wd * 100 + pw)
    n, c4 = 512, 4 * (wd + pw) // 3
    cw = swar.golay_encode_wide(torch.randint(0, 4096, (n, c4), generator=gen,
                                              dtype=torch.int32))
    weight = torch.randint(0, 7, (n, c4), generator=gen)
    weight = torch.where(torch.rand((n, c4), generator=gen) < 0.4, 0, weight)
    err = torch.zeros_like(cw)
    for k in range(6):
        bit = torch.randint(0, 24, (n, c4), generator=gen)
        err = err ^ torch.where(weight > k, 1 << bit, 0).to(torch.int32)
    rows = swar.golay_split_pack(cw ^ err, head_dim)
    table = pa.golay_read_table(torch.device("cpu")).long() & 0xFFFF
    got, corrected, detected = lane_decode(rows, wd, pw, table)
    nib, _ = pa.decode_rows("golay", rows, wd, head_dim)
    assert torch.equal(got, swar.pack_int4(nib).long() & 0xFFFFFFFF)
    _, cnt = swar.golay_decode_wide(swar.golay_split_unpack(rows, head_dim),
                                    zero_uncorrectable=True)
    assert torch.equal(corrected, torch.where(cnt < 4, cnt, 0).sum(-1).long())
    assert torch.equal(detected, (cnt == 4).sum(-1).long())
    assert int(detected.sum()) > 0 and int(corrected.sum()) > 0


def test_read_table_is_the_syndrome_table_reordered():
    table = C.golay_syndrome_table(swar._B_MASKS)
    read = pa.golay_read_table(torch.device("cpu"))
    s = torch.arange(4096)
    index = C.golay_lane_index(s)
    assert sorted(index.tolist()) == list(range(4096))
    assert torch.equal(read[index], table)
