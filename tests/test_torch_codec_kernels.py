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
determinism per seed."""

import os
from itertools import combinations

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
