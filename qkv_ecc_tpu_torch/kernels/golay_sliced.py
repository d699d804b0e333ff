"""Bit-sliced Golay(24,12) IMLD decode: 32 codewords a 32-bit word
(counterpart of ``qkv_ecc_tpu/kernels/golay_sliced.py``), plain PyTorch on
int32 tensors.

The JAX module holds a layout and decoder measured on the TPU and dropped
there: bit b of 32 codewords in one word, so each AND/XOR/OR of the IMLD
network serves 32 codewords, and the per-codeword popcounts become full-adder
networks over bit planes. It lies on no decode path, has no Pallas kernel,
and so has no CUDA kernel here either; this is its reference, bit for bit.

Layout. Codeword row r (h x cw_per_head + c: KV head h, codeword c of the
head) sits at bit z of plane word g, with u = r // 4, k = r % 4,
g = u % G, z = 4 (u // G) + k: the four codewords 4u..4u+3 take adjacent
bits of one word. Planes are plane-major: plane p holds words
[p G, (p + 1) G).

The IMLD network (golay_sliced_correct_planes) takes the four stages of the
per-lane decoder (codecs/reference.py golay_decode_algebraic):
  1. wt(s) <= 3                -> e = (0 | s)
  2. wt(s ^ B_i) <= 2 some i   -> e = (u_i | s ^ B_i)
  3. wt(q) <= 3, q = B s       -> e = (q | 0)
  4. wt(q ^ B_i) <= 2 some i   -> e = (q ^ B_i | u_i)
each stage's weights from shared full-adder triples.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..codecs.algebra import GOLAY_B_ROW_MASKS
from .common import popcount

_B = tuple(int(m) for m in GOLAY_B_ROW_MASKS)
_TRIPLES = ((0, 1, 2), (3, 4, 5), (6, 7, 8), (9, 10, 11))
_SPREAD = 0x00204081  # bit b -> byte b (b < 4): x * _SPREAD & 0x01010101
_M1 = 0x01010101


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def cw_per_head(head_dim: int) -> int:
    """Codewords per (token, head): ceil(head_dim / 3) padded to 8 (48 at
    head_dim 128)."""
    return round_up(cdiv(head_dim, 3), 8)


def sliced_values_per_head(head_dim: int) -> int:
    return 3 * cw_per_head(head_dim)


def num_groups(kv_heads: int, head_dim: int) -> int:
    """G, plane words per token: 32 G >= kv_heads x cw_per_head."""
    return cdiv(kv_heads * cw_per_head(head_dim), 32)


def sliced_row_words(kv_heads: int, head_dim: int) -> int:
    """int32 storage words per token over all the KV heads."""
    return 24 * num_groups(kv_heads, head_dim)


@functools.cache
def _row_of_gz(G: int):
    """numpy [G, 32]: the codeword row of (g, z)."""
    g = np.arange(G)[:, None]
    z = np.arange(32)[None, :]
    return (4 * (g + G * (z // 4)) + z % 4).astype(np.int32)


@functools.cache
def _gz_of_row(G: int):
    """numpy [32 G] each: (g, z) of codeword row r."""
    u, k = np.arange(32 * G) // 4, np.arange(32 * G) % 4
    return (u % G).astype(np.int32), (4 * (u // G) + k).astype(np.int32)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as the int32 of their low 32 bits."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _bit_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., 32] 0/1 -> [...] int32 with bit z from bits[..., z]."""
    weights = torch.tensor([1 << z for z in range(32)], dtype=torch.int64, device=bits.device)
    return _i32((bits.to(torch.int64) * weights).sum(dim=-1))


def valid_row_masks(G: int, n_rows: int) -> torch.Tensor:
    """int32 [G]: bit z set where row r(g, z) < n_rows (the padding
    codewords of odd head counts kept out of the error counts)."""
    return _bit_words(torch.from_numpy(_row_of_gz(G) < n_rows))


def golay_slice_pack(cw: torch.Tensor, G: int, axis: int = -1) -> torch.Tensor:
    """[..., R] 24-bit codewords (R <= 32 G, zero-padded) -> [..., 24 G]
    plane words, plane-major."""
    cw = cw.movedim(axis, -1).to(torch.int32)
    R = cw.shape[-1]
    if R < 32 * G:
        cw = torch.nn.functional.pad(cw, (0, 32 * G - R))
    c = cw[..., torch.from_numpy(_row_of_gz(G)).long().to(cw.device)]  # [..., G, 32]
    words = torch.cat([_bit_words((c >> p) & 1) for p in range(24)], dim=-1)
    return words.movedim(-1, axis)


def golay_slice_unpack(w: torch.Tensor, G: int, n_rows: int | None = None,
                       axis: int = -1) -> torch.Tensor:
    """Inverse of golay_slice_pack: [..., 24 G] plane words -> [..., R]
    codewords (R = n_rows or 32 G)."""
    w = w.movedim(axis, -1).to(torch.int32)
    gi, zi = (torch.from_numpy(a).to(w.device) for a in _gz_of_row(G))
    cw = None
    for p in range(24):
        plane = w[..., p * G:(p + 1) * G]
        b = ((plane[..., gi.long()] >> zi) & 1) << p
        cw = b if cw is None else cw | b
    if n_rows is not None:
        cw = cw[..., :n_rows]
    return cw.movedim(-1, axis)


# -- the bit-sliced IMLD network -----------------------------------------------


def _xor_planes(planes, mask: int, extra=None):
    acc = extra
    for j in range(12):
        if (mask >> j) & 1:
            acc = planes[j] if acc is None else acc ^ planes[j]
    return acc


class _TripleBank:
    """Shared masked full-adder triples over one 12-plane vector: for
    triple (a, b, c) and 3-bit complement mask m, (sum, carry) of
    (a ^ m0) + (b ^ m1) + (c ^ m2), deduplicated by sum_m = sum ^
    parity(m) and maj(~a, ~b, ~c) = ~maj(a, b, c)."""

    def __init__(self, planes):
        self.p = planes
        self._sum = {}
        self._nsum = {}
        self._maj = {}
        self._x = {}
        self._ab = {}

    def _base(self, t):
        if t not in self._sum:
            a, b, c = (self.p[j] for j in _TRIPLES[t])
            x = a ^ b
            self._x[t] = x
            self._ab[t] = a & b
            self._sum[t] = x ^ c
            self._maj[(t, 0)] = self._ab[t] | (c & x)

    def sum(self, t, m):
        self._base(t)
        if bin(m).count("1") % 2 == 0:
            return self._sum[t]
        if t not in self._nsum:
            self._nsum[t] = ~self._sum[t]
        return self._nsum[t]

    def carry(self, t, m):
        self._base(t)
        if (t, m) in self._maj:
            return self._maj[(t, m)]
        comp = (~m) & 7
        if (t, comp) in self._maj:
            v = ~self._maj[(t, comp)]
        else:
            a, b, c = (self.p[j] for j in _TRIPLES[t])
            base = m if bin(m).count("1") == 1 else comp
            if base == 1:
                v = (b & c) | (~a & (b ^ c))
            elif base == 2:
                v = (a & c) | (~b & (a ^ c))
            else:  # base == 4
                v = self._ab[t] | (~c & self._x[t])
            self._maj[(t, base)] = v
            if base != m:
                v = ~v
        self._maj[(t, m)] = v
        return v

    def pairs(self, mask12: int):
        """[(sum, carry)] of the 4 triples for complement mask mask12."""
        return [(self.sum(t, (mask12 >> (3 * t)) & 7), self.carry(t, (mask12 >> (3 * t)) & 7))
                for t in range(4)]


def _wt_le3(pairs):
    """wt <= 3 from 4 (sum, carry) pairs: C == 0 and S <= 3, or C == 1 and
    S <= 1."""
    (s1, c1), (s2, c2), (s3, c3), (s4, c4) = pairs
    o01, o23 = s1 | s2, s3 | s4
    a01, a23 = s1 & s2, s3 & s4
    oc01, oc23 = c1 | c2, c3 | c4
    any_c = oc01 | oc23
    two_c = (oc01 & oc23) | (c1 & c2) | (c3 & c4)
    ge2_s = a01 | a23 | (o01 & o23)
    le3_s = ~(a01 & a23)
    return (~any_c & le3_s) | (any_c & ~two_c & ~ge2_s)


def _wt_le2(pairs):
    """wt <= 2 from 4 (sum, carry) pairs: C == 0 and S <= 2, or C == 1 and
    S == 0."""
    (s1, c1), (s2, c2), (s3, c3), (s4, c4) = pairs
    o01, o23 = s1 | s2, s3 | s4
    a01, a23 = s1 & s2, s3 & s4
    ge3_s = (a01 & o23) | (a23 & o01)
    any_s = o01 | o23
    oc01, oc23 = c1 | c2, c3 | c4
    any_c = oc01 | oc23
    two_c = (oc01 & oc23) | (c1 & c2) | (c3 & c4)
    return ~two_c & ((~any_c & ~ge3_s) | (any_c & ~any_s))


def _sweep(planes):
    """One IMLD half-stage over 12 planes: (le3, [hit_i of the 12
    candidates], any hit)."""
    bank = _TripleBank(planes)
    le3 = _wt_le3(bank.pairs(0))
    hits = [_wt_le2(bank.pairs(_B[i])) for i in range(12)]
    any_hit = hits[0]
    for h in hits[1:]:
        any_hit = any_hit | h
    return le3, hits, any_hit


def _col_or(hits, j: int):
    """OR of hit_i over the candidates whose B row has bit j (B is
    symmetric)."""
    acc = None
    for i in range(12):
        if (_B[j] >> i) & 1:
            acc = hits[i] if acc is None else acc | hits[i]
    return acc


def golay_sliced_correct_plane_list(d, p, *, full_errors: bool = False):
    """Bit-sliced IMLD over 12 data planes ``d`` and 12 parity planes ``p``
    (each [G, bs] int32). Returns (data plane list, correctable, errs),
    errs = (e_data list, e_par list) with full_errors, else None."""
    s = [_xor_planes(d, _B[i], p[i]) for i in range(12)]
    ok1, hits2, any2 = _sweep(s)

    q = [_xor_planes(s, _B[i]) for i in range(12)]
    ok3, hits4, any4 = _sweep(q)

    n1 = ~ok1
    sel2 = n1 & any2
    n12 = n1 & ~any2
    sel3 = n12 & ok3
    sel4 = n12 & ~ok3 & any4
    correctable = ok1 | any2 | sel3 | sel4
    sel34 = sel3 | sel4

    out, ed = [], []
    for j in range(12):
        e = (hits2[j] & sel2) | (q[j] & sel34)
        x4 = _col_or(hits4, j)
        if x4 is not None:
            e = e ^ (x4 & sel4)
        out.append((d[j] ^ e) & correctable)
        if full_errors:
            ed.append(e)

    errs = None
    if full_errors:
        pe = []
        for j in range(12):
            ep = s[j] & (ok1 | sel2)
            x2 = _col_or(hits2, j)
            if x2 is not None:
                ep = ep ^ (x2 & sel2)
            pe.append(ep | (hits4[j] & sel4))
        errs = (ed, pe)
    return out, correctable, errs


def golay_sliced_correct_planes(w: torch.Tensor, G: int, *, full_errors: bool = False):
    """Bit-sliced IMLD over plane words w [24 G, bs] int32 (plane-major).

    Returns (data planes [12 G, bs] corrected, uncorrectable codewords
    zeroed; correctable [G, bs], bit set where the codeword was
    correctable; errs (e_data [12 G, bs], e_par [12 G, bs]) with
    full_errors, else None)."""
    d = [w[j * G:(j + 1) * G] for j in range(12)]
    p = [w[(12 + j) * G:(13 + j) * G] for j in range(12)]
    out, correctable, errs = golay_sliced_correct_plane_list(d, p, full_errors=full_errors)
    data = torch.cat(out, dim=0)
    if full_errors:
        errs = (torch.cat(errs[0], dim=0), torch.cat(errs[1], dim=0))
    return data, correctable, errs


# -- the decode side's value unpack --------------------------------------------


def sliced_nibble_words(data, G: int):
    """Corrected data planes (a list of 12 [G, bs], or [12 G, bs]
    plane-major) -> 3 nibble-word arrays [8 G, bs] int32: byte k of word u
    of array t is nibble t of codeword row 4u + k."""
    if not isinstance(data, (list, tuple)):
        data = [data[j * G:(j + 1) * G] for j in range(12)]
    rows = torch.arange(8 * G, dtype=torch.int32, device=data[0].device)[:, None]
    sv = 4 * (rows // G)  # constant within each G-row block
    out = []
    for t in range(3):
        acc = None
        for b in range(4):
            rep = torch.cat([data[4 * t + b]] * 8, dim=0)  # row u -> plane[u % G]
            t4 = (rep >> sv) & 0xF
            spread = ((t4 * _SPREAD) & _M1) << b
            acc = spread if acc is None else acc | spread
        out.append(acc)
    return out


def sliced_error_count(e_data, e_par, correctable, valid_mask, G: int):
    """(corrected bits, uncorrectable codewords) int32 scalars from the
    error planes (lists of 12 [G, bs], or [12 G, bs]); valid_mask [G, bs]
    int32. golay_decode_i32's accounting: corrected counts the error bits of
    correctable codewords, detected the uncorrectable ones."""
    if not isinstance(e_data, (list, tuple)):
        e_data = [e_data[j * G:(j + 1) * G] for j in range(12)]
    if not isinstance(e_par, (list, tuple)):
        e_par = [e_par[j * G:(j + 1) * G] for j in range(12)]
    corr = torch.zeros((), dtype=torch.int32, device=correctable.device)
    ok = correctable & valid_mask
    for j in range(12):
        corr = corr + popcount(e_data[j] & ok).sum(dtype=torch.int32)
        corr = corr + popcount(e_par[j] & ok).sum(dtype=torch.int32)
    det = popcount(~correctable & valid_mask).sum(dtype=torch.int32)
    return corr, det
