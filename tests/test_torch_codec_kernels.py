"""The port's codec kernels (qkv_ecc_tpu_torch.kernels.codec_kernels, K5-K9)
against the JAX package's Pallas kernels (qkv_ecc_tpu.kernels.codec_kernels,
in interpret mode on the CPU). On CPU tensors the wrappers run their plain
versions, which must equal the JAX kernels bit for bit, dtypes included:
every byte through K5 and K6, all 4096 Golay data words (and words with
bits above 12) through K7's encode, every error pattern of weight 0-3 and a
sample of weight 4 on a sample of codewords and words with bits 24-31 set
through its decode, K8 with masks wider than 24 bits, odd shapes and empty
input. K9 draws other bits than the JAX function on the CPU (threefry
there, a counter hash here), so it is held to the JAX contract: the rate,
the low n_bits only, dtype and shape, the identity at BER 0, and
determinism per seed. The card's own formulation of K5-K8
(csrc/codec_kernels.cu: four Hamming codewords a 32-bit word with prmt
lookups, Golay's syndrome-table decode) is emulated in numpy with the
source's tables and held to the plain versions and the JAX kernels too."""

import os
import re
from itertools import combinations
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.kernels import codec_kernels as jk  # noqa: E402
from qkv_ecc_tpu_torch.kernels import codec_kernels as tk  # noqa: E402
from qkv_ecc_tpu_torch.kernels import swar as ts  # noqa: E402

torch.set_num_threads(1)
HAMMING = ("hamming74_encode", "hamming74_decode", "hamming84_encode", "hamming84_decode")
ODD_SHAPES = ((3, 5, 7), (1,), (2, 0, 3))


def same(want, got, err_msg=""):
    """JAX output(s) and torch output(s): equal values of the same dtype."""
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got), err_msg
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, (err_msg, w.dtype, g.dtype, w.shape)
        np.testing.assert_array_equal(w, g, err_msg=err_msg)


def counts():
    return [w.launches for w in tk.WRAPPERS]


@pytest.mark.parametrize("name", HAMMING)
def test_hamming_every_byte_matches_jax(name):
    """K5 and K6 on every byte 0-255 (the encoders read the low nibble, the
    decoders every bit), as uint8 and as int32 values past 255 (both
    packages cast to uint8 first), and on odd shapes."""
    before = counts()
    x = np.arange(256, dtype=np.uint8)
    same(getattr(jk, name + "_tpu")(x), getattr(tk, name + "_cuda")(torch.from_numpy(x)), name)
    wide = np.arange(-300, 700, 7, dtype=np.int32)
    same(getattr(jk, name + "_tpu")(wide), getattr(tk, name + "_cuda")(torch.from_numpy(wide)),
         name + " int32")
    rng = np.random.default_rng(5)
    for shape in ODD_SHAPES:
        v = rng.integers(0, 256, shape, dtype=np.uint8)
        same(getattr(jk, name + "_tpu")(v), getattr(tk, name + "_cuda")(torch.from_numpy(v)),
             f"{name} {shape}")
    assert counts() == before  # the CPU runs the plain version: no launch


def _golay_words():
    """Every data word, and words with bits above 12 (bit 31 too)."""
    rng = np.random.default_rng(11)
    high = rng.integers(-(2 ** 31), 2 ** 31, 512, dtype=np.int64).astype(np.int32)
    return np.concatenate([np.arange(4096, dtype=np.int32), high])


def _error_patterns(rng):
    """Every 24-bit pattern of weight 0-3, 2000 of weight 4, and 64 with
    bits 24-31 set (which the decoder ignores)."""
    pats = [0]
    for w in (1, 2, 3):
        pats += [sum(1 << b for b in bits) for bits in combinations(range(24), w)]
    for _ in range(2000):
        pats.append(sum(1 << int(b) for b in rng.choice(24, 4, replace=False)))
    wide = rng.integers(1, 256, 64, dtype=np.int64) << 24
    pats += [int(p) for p in wide | rng.integers(0, 1 << 24, 64)]
    return np.asarray(pats, dtype=np.int64)


def test_golay_matches_jax():
    """K7: encode of every data word and of wide words; decode of a sample
    of codewords under every weight 0-3 pattern, 2000 weight-4 patterns and
    patterns with bits 24-31 set; the triplet forms; odd shapes."""
    words = _golay_words()
    cw_j = jk.golay_encode_packed_tpu(words)
    cw_t = tk.golay_encode_packed_cuda(torch.from_numpy(words), sublanes=8)
    same(cw_j, cw_t, "golay encode")

    rng = np.random.default_rng(3)
    pats = _error_patterns(rng)
    base = np.asarray(cw_j)[rng.choice(4096, 24, replace=False)]
    rx = (base[:, None].astype(np.int64) ^ pats[None, :])
    rx = (rx - ((rx >> 31 & 1) << 32)).astype(np.int32)  # wrap to int32 bits
    assert (rx < 0).any()
    want = jk.golay_decode_packed_tpu(rx)
    got = tk.golay_decode_packed_cuda(torch.from_numpy(rx))
    same(want, got, "golay decode")
    counts4 = got[1].numpy()
    assert set(np.unique(counts4)) == {0, 1, 2, 3, 4}

    trip = rng.integers(0, 16, (5, 7, 3), dtype=np.uint8)
    same(jk.golay_encode_tpu(trip), tk.golay_encode_cuda(torch.from_numpy(trip)), "triplets")
    bad = np.asarray(jk.golay_encode_tpu(trip)) ^ rng.integers(0, 1 << 24, (5, 7), dtype=np.int32)
    same(jk.golay_decode_tpu(bad), tk.golay_decode_cuda(torch.from_numpy(bad)), "triplet decode")


def test_golay_write_scrub_matches_jax():
    """K8 with random masks, dense enough for uncorrectable and miscorrected
    codewords, whose bits above 24 are also set, and with a zero mask."""
    rng = np.random.default_rng(7)
    d12 = rng.integers(-(2 ** 31), 2 ** 31, (4, 1, 8, 44), dtype=np.int64).astype(np.int32)
    bits = rng.random((4, 1, 8, 44, 32)) < 0.12
    mask = (bits.astype(np.int64) << np.arange(32)).sum(-1)
    mask = (mask - ((mask >> 31 & 1) << 32)).astype(np.int32)
    want = jk.golay_write_scrub_tpu(d12, mask)
    got = tk.golay_write_scrub_cuda(torch.from_numpy(d12), torch.from_numpy(mask))
    same(want, got, "write scrub")
    zero = np.zeros_like(mask)
    same(jk.golay_write_scrub_tpu(d12, zero),
         tk.golay_write_scrub_cuda(torch.from_numpy(d12), torch.from_numpy(zero)), "zero mask")
    with pytest.raises(ValueError, match="one shape"):
        tk.golay_write_scrub_cuda(torch.from_numpy(d12), torch.from_numpy(mask[:2]))


@pytest.mark.parametrize("form", ["rows", "nibble tables"])
def test_golay_encode_without_popcounts(form):
    """The plain form of K7's encode on the card: B (the port's and the JAX
    package's row masks) equals its transpose, so x . B is the XOR of the
    rows that x's bits select, and by linearity the XOR of three 16-entry
    tables, one per nibble of x (csrc/golay.cuh's encode tables); either
    gives golay_encode_plain's codeword for all 4096 data words."""
    from qkv_ecc_tpu.codecs.algebra import GOLAY_B_ROW_MASKS as jax_rows
    from qkv_ecc_tpu_torch.codecs.algebra import GOLAY_B_ROW_MASKS as rows

    np.testing.assert_array_equal(rows, jax_rows)
    b = (rows[:, None] >> np.arange(12)) & 1  # b[i, j] = B[i, j]
    np.testing.assert_array_equal(b, b.T)
    x = np.arange(4096, dtype=np.int64)
    sel = (x[:, None] >> np.arange(12)) & 1  # [word, row i]: bit i of x
    if form == "rows":
        parity = np.bitwise_xor.reduce(np.where(sel == 1, rows.astype(np.int64), 0), axis=1)
    else:
        tables = np.array([[np.bitwise_xor.reduce([int(rows[4 * k + i]) for i in range(4)
                                                   if n >> i & 1] or [0]) for n in range(16)]
                           for k in range(3)], dtype=np.int64)
        parity = tables[0][x & 15] ^ tables[1][x >> 4 & 15] ^ tables[2][x >> 8]
    want = tk.golay_encode_plain(torch.arange(4096, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal((x | parity << 12).astype(np.int32), want)


# The card's formulation of K5-K8 (csrc/codec_kernels.cu), emulated in numpy
# on uint32 words: the tables are read from the source itself
_CU = (Path(tk.__file__).resolve().parent.parent / "csrc" / "codec_kernels.cu").read_text()
_CU_CONST = {k: int(v, 16) for k, v in re.findall(r"\b(k\w+) = (0x[0-9A-Fa-f]+)u\b", _CU)}
M1 = 0x01010101


def prmt(lo, hi, sel):
    """prmt.b32 in its default mode: byte k of the result is byte (sel >>
    4k) & 7 of {hi, lo}, or that byte's bit 7 over all 8 bits when bit 4k + 3
    of sel is set."""
    src = (np.uint64(hi) << np.uint64(32)) | np.uint64(lo)
    out = np.zeros(np.shape(sel), dtype=np.uint64)
    for k in range(4):
        nib = (np.asarray(sel, dtype=np.uint64) >> np.uint64(4 * k)) & np.uint64(15)
        byte = (src >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(0xFF)
        byte = np.where(nib & np.uint64(8), np.where(byte & np.uint64(0x80), 0xFF, 0), byte)
        out |= byte.astype(np.uint64) << np.uint64(8 * k)
    return out.astype(np.uint32)


def pack_nibbles(v):
    """codec_kernels.cu pack_nibbles: a value 0-15 in each byte slot -> the
    four one a nibble in bits 0-15."""
    return prmt(v | (v >> 4), np.uint32(0), np.full(v.shape, 0x0020, dtype=np.uint32))


def hamming_word_emulated(op, x):
    """codec_kernels.cu hamming_word on uint32 words x: (y0, y1), four
    outputs each in the byte slots (y1 None for an encode)."""
    c = _CU_CONST
    x = x.astype(np.uint32)
    if op.endswith("encode"):
        lo, hi = (c["kH74Lo"], c["kH74Hi"]) if op.startswith("hamming74") else (c["kH84Lo"],
                                                                                c["kH84Hi"])
        cw = prmt(lo, hi, pack_nibbles(x & 0x07070707))
        return cw ^ ((x & 0x08080808) * np.uint32(15)), None
    x1, x2, x3, x4, x5, x6 = (x >> k for k in range(1, 7))
    a = (x ^ x1 ^ x3 ^ x4) & M1
    b = (x ^ x2 ^ x3 ^ x5) & M1
    cc = (x1 ^ x2 ^ x3 ^ x6) & M1
    nonzero = a | b | cc
    s = a | (b << 1) | (cc << 2)
    if op.startswith("hamming74"):
        y1 = nonzero
    else:
        p = x ^ x4
        p ^= p >> 2
        p = (p ^ (p >> 1)) & M1
        s |= (p ^ M1) << 3
        y1 = p | ((nonzero ^ p) << 1)
    return (x ^ prmt(c["kCorrLo"], c["kCorrHi"], pack_nibbles(s))) & 0x0F0F0F0F, y1


def _bytes_of(words):
    return words.astype("<u4").view(np.uint8)


@pytest.mark.parametrize("name", HAMMING)
def test_hamming_swar_emulation_matches_jax(name):
    """K5 and K6 as the card computes them (four codewords a 32-bit word,
    the syndromes by shifts and XORs, the lookups by prmt, whose sign mode
    cancels Hamming(8,4)'s correction where the parity holds) equal the
    plain versions and the JAX kernels on every byte 0-255 in every byte
    slot of a word, beside random neighbours, and alone in slot 0 (the
    one-byte path), and the source's tables are the codes' own."""
    b = np.arange(256, dtype=np.uint32)
    rng = np.random.default_rng(9)
    words = np.concatenate([
        b | ((b + 85) % 256) << 8 | ((b + 170) % 256) << 16 | ((b + 255) % 256) << 24,
        b,
        rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)])
    for k in range(4):  # every byte in slot k, random bytes beside it
        rand = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
        words = np.concatenate([words, (rand & ~np.uint32(0xFF << 8 * k)) | b << (8 * k)])
    x = _bytes_of(words)
    y0, y1 = hamming_word_emulated(name, words)
    got = (torch.from_numpy(_bytes_of(y0).copy()),)
    if y1 is not None:
        got += (torch.from_numpy(_bytes_of(y1).copy()),)
    got = got if len(got) > 1 else got[0]
    same(getattr(jk, name + "_tpu")(x), got, name + " against JAX")
    want = getattr(tk, name + "_plain")(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got if isinstance(got, tuple) else (got,), want):
        assert torch.equal(g, w), name
    code = "hamming74" if name.startswith("hamming74") else "hamming84"
    enc = getattr(tk, code + "_encode_plain")(torch.arange(8, dtype=torch.uint8))
    key = "kH74" if code == "hamming74" else "kH84"
    table = np.array([_CU_CONST[key + "Lo"], _CU_CONST[key + "Hi"]], dtype="<u4").view(np.uint8)
    np.testing.assert_array_equal(table, enc.numpy())


def _golay_tables():
    from qkv_ecc_tpu_torch.kernels import common as C

    masks = tuple(int(m) for m in ts._B_MASKS)
    return (C.golay_nibble_tables(masks).numpy().astype(np.int64),
            C.golay_syndrome_table(masks).numpy().astype(np.int64) & 0xFFFF)


def _times_b(tab, x):
    return tab[x & 15] ^ tab[16 + (x >> 4 & 15)] ^ tab[32 + (x >> 8 & 15)]


def _wrap_i32(x):
    x = np.asarray(x, dtype=np.int64) & 0xFFFFFFFF
    return (x - ((x >> 31) << 32)).astype(np.int32)


def test_golay_table_decode_emulation_matches_jax():
    """K7's decode as the card computes it (s = d . B ^ p in three
    nibble-table lookups, then the 4096-entry syndrome table; data d ^
    correction, whose entry is 0 at weight 4, so an uncorrectable word keeps
    its corrupt data) over every syndrome beside 8 data words, bits 24-31
    set in half of them, equals golay_decode_plain and JAX's kernel on data
    and count; K8's form (the syndrome m_lo . B ^ m_hi of the mask alone,
    uncorrectable -> 0, encoded again) equals golay_write_scrub_plain and
    JAX's over every data word under masks of every syndrome."""
    tab, syn = _golay_tables()
    rng = np.random.default_rng(13)
    s = np.arange(4096, dtype=np.int64)
    d = rng.integers(0, 4096, (8, 1), dtype=np.int64)
    high = np.where(np.arange(8)[:, None] % 2 == 1,
                    rng.integers(0, 256, (8, 4096), dtype=np.int64) << 24, 0)
    cw = _wrap_i32(d | ((_times_b(tab, d) ^ s) << 12) | high).reshape(-1)
    u = cw.astype(np.int64) & 0xFFFFFFFF
    dd = u & 0xFFF
    e = syn[_times_b(tab, dd) ^ (u >> 12 & 0xFFF)]
    got = (torch.from_numpy((dd ^ (e & 0xFFF)).astype(np.int32)),
           torch.from_numpy((e >> 12).astype(np.int32)))
    assert set(np.unique(got[1].numpy())) == {0, 1, 2, 3, 4}
    same(jk.golay_decode_packed_tpu(cw), got, "golay table decode against JAX")
    want = tk.golay_decode_plain(torch.from_numpy(cw))
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    v = _wrap_i32(np.concatenate([np.arange(4096), rng.integers(-2 ** 31, 2 ** 31, 4096)]))
    r = rng.integers(0, 4096, 8192, dtype=np.int64)
    syndromes = rng.permutation(np.tile(s, 2))
    m = _wrap_i32(r | ((_times_b(tab, r) ^ syndromes) << 12)
                  | rng.integers(0, 256, 8192, dtype=np.int64) << 24)
    vu, mu = v.astype(np.int64) & 0xFFFFFFFF, m.astype(np.int64) & 0xFFFFFFFF
    e = syn[_times_b(tab, mu & 0xFFF) ^ (mu >> 12 & 0xFFF)]
    data = np.where(e >> 14 == 1, 0, (vu ^ mu ^ e) & 0xFFF)
    scrubbed = torch.from_numpy((data | (_times_b(tab, data) << 12)).astype(np.int32))
    same(jk.golay_write_scrub_tpu(v, m), scrubbed, "golay table scrub against JAX")
    assert torch.equal(scrubbed, tk.golay_write_scrub_plain(torch.from_numpy(v),
                                                            torch.from_numpy(m)))


@pytest.mark.parametrize("name", HAMMING + ("golay_encode_packed", "golay_decode_packed"))
def test_empty_input_matches_jax(name):
    """Empty input: zeros of the shape and the JAX dtypes, no launch."""
    before = counts()
    dtype = np.int32 if name.startswith("golay") else np.uint8
    x = np.zeros((0, 3), dtype)
    same(getattr(jk, name + "_tpu")(x), getattr(tk, name + "_cuda")(torch.from_numpy(x)), name)
    assert counts() == before


@pytest.mark.parametrize("dtype,n_bits", [(np.uint8, 8), (np.int32, 24), (np.int32, 32)])
def test_injection_meets_the_jax_contract(dtype, n_bits):
    """K9's plain version against inject_bit_errors_tpu on the CPU
    (threefry there): both flip within 15% of the BER at n = 100k, only the
    low n_bits, keep dtype and shape, are deterministic per seed and differ
    for the next seed; BER 0 returns the data itself."""
    n, ber = 100_000, 0.01
    rng = np.random.default_rng(2)
    hi = 256 if dtype == np.uint8 else 2 ** 31
    data = rng.integers(0, hi, (4, n // 4)).astype(dtype)
    t = torch.from_numpy(data)
    for name, fn, x in (("jax", jk.inject_bit_errors_tpu, jnp.asarray(data)),
                        ("torch", tk.inject_bit_errors_cuda, t)):
        out = fn(x, ber, n_bits, 42)
        arr = np.asarray(out) if name == "jax" else out.numpy()
        assert arr.dtype == data.dtype and arr.shape == data.shape, name
        diff = (arr ^ data).astype(np.int64) & 0xFFFFFFFF
        if n_bits < 32:
            assert not (diff >> n_bits).any(), name
        rate = sum(int(((diff >> b) & 1).sum()) for b in range(n_bits)) / (n * n_bits)
        assert abs(rate - ber) <= 0.15 * ber, (name, rate)
        again = np.asarray(fn(x, ber, n_bits, 42)) if name == "jax" else fn(x, ber, n_bits, 42).numpy()
        other = np.asarray(fn(x, ber, n_bits, 43)) if name == "jax" else fn(x, ber, n_bits, 43).numpy()
        assert np.array_equal(arr, again) and not np.array_equal(arr, other), name
    assert tk.inject_bit_errors_cuda(t, 0.0, n_bits, 42) is t
    assert tk.inject_bit_errors_cuda(t, -1.0, n_bits, 42) is t
    empty = torch.zeros((0,), dtype=t.dtype)
    assert tk.inject_bit_errors_cuda(empty, ber, n_bits, 42) is empty


def test_injection_plain_is_the_counter_hash():
    """K9's plain version is swar.hash_flip_mask over one row of the flat
    elements - bit b of element i flips when murmur(((i * n_bits + b) *
    0x9E3779B9 + seed) mod 2^32) < threshold, the kernel's formula, which
    chip_smoke.py holds the kernel to with torch.equal - with the threshold
    of codec_kernels.py:270 (saturating at BER 1)."""
    data = torch.arange(3 * 7 * 5, dtype=torch.int32).reshape(3, 7, 5)
    for ber, thr in ((0.25, 1 << 30), (1.0, 0xFFFFFFFF), (2.0, 0xFFFFFFFF)):
        got = tk.inject_bit_errors_cuda(data, ber, 24, -5)
        mask = ts.hash_flip_mask(-5, 0, (1, data.numel()), thr, 24)
        assert torch.equal(got, (data.reshape(1, -1) ^ mask).reshape(3, 7, 5))

    def fmix32(z):
        z ^= z >> 16
        z = z * 0x85EBCA6B & 0xFFFFFFFF
        z ^= z >> 13
        z = z * 0xC2B2AE35 & 0xFFFFFFFF
        return z ^ z >> 16

    thr, seed = int(0.3 * 2 ** 32), 0xFFFFFFFB  # seed -5 as uint32
    want = [sum(int(fmix32(((i * 24 + b) * 0x9E3779B9 + seed) & 0xFFFFFFFF) < thr) << b
                for b in range(24)) for i in range(data.numel())]
    got = tk.inject_bit_errors_cuda(data, 0.3, 24, -5).reshape(-1) ^ data.reshape(-1)
    assert got.tolist() == want
    with pytest.raises(ValueError, match="uint8 or int32"):
        tk.inject_bit_errors_cuda(data.to(torch.int16), 0.1, 8, 0)
    with pytest.raises(ValueError, match="n_bits"):
        tk.inject_bit_errors_cuda(data, 0.1, 33, 0)
