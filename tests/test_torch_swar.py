"""The port's packed-cache codec math (qkv_ecc_tpu_torch.kernels.swar and
.common) against the JAX package's, bit for bit, on the same numpy inputs."""

import os
from itertools import combinations

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs.algebra import GOLAY_B_ROW_MASKS as J_B_MASKS  # noqa: E402
from qkv_ecc_tpu.kernels import common as jc  # noqa: E402
from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu_torch.codecs.algebra import GOLAY_B_ROW_MASKS as T_B_MASKS  # noqa: E402
from qkv_ecc_tpu_torch.kernels import common as tc  # noqa: E402
from qkv_ecc_tpu_torch.kernels import swar as ts  # noqa: E402

torch.set_num_threads(1)
B_MASKS = tuple(int(m) for m in J_B_MASKS)
HEAD_DIMS = [16, 32, 33, 60, 64, 128]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.int32)))


def same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def test_b_masks_copied():
    np.testing.assert_array_equal(J_B_MASKS, T_B_MASKS)


@pytest.mark.parametrize("head_dim", list(range(8, 257, 8)) + [33, 60, 100])
def test_word_counts(head_dim):
    for codec in ("int4", "golay", "fp16", "fp8"):
        for fn in ("padded_values", "row_words", "data_words", "parity_words",
                   "scrub_extract_ok"):
            assert getattr(ts, fn)(codec, head_dim) == getattr(js, fn)(codec, head_dim), fn
    assert ts.golay_data_nibbles(head_dim) == js.golay_data_nibbles(head_dim)
    assert ts.golay_prefix_covers_values(head_dim) == js.golay_prefix_covers_values(head_dim)


@pytest.mark.parametrize("codec", ["hamming74", "hamming84", "fp16", "fp8"])
def test_later_codecs_raise(codec):
    """(The name is from before the float codecs were ported, when they
    raised "not ported yet".) The row math of fp16 and fp8 is JAX's: one
    element per value, no parity, the scrub extract allowed; their masks are
    not folded (ValueError, as in JAX); an unknown codec raises ValueError.
    Every correcting read runs: a zero cache reads as -8 for the Hamming
    codecs (their codeword 0 is nibble 0) and as 0 for the float codecs,
    with no error counted."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc_write_attend

    for hd in (16, 33, 128):
        for fn in ("padded_values", "row_words", "data_words", "parity_words",
                   "scrub_extract_ok"):
            assert getattr(ts, fn)(codec, hd) == getattr(js, fn)(codec, hd), (fn, hd)
    with pytest.raises(ValueError, match="unknown"):
        ts.padded_values("int3", 128)
    if codec in ("fp16", "fp8"):
        with pytest.raises(ValueError, match="float codec"):
            ts.scrub_fold_mask(codec, torch.zeros(4, dtype=torch.int32))
        with pytest.raises(ValueError):
            js.scrub_fold_mask(codec, jnp.zeros(4, dtype=jnp.int32))
        D, bs = 32, 16
        dtype = torch.bfloat16 if codec == "fp16" else torch.float8_e4m3fn
        cache = torch.zeros((1, 2, 1, D, bs), dtype=dtype)
        scales = torch.ones((1, 2, 1, bs))
        new = torch.zeros((1, 1, D), dtype=dtype)
        out, stats = paged_attention_ecc_write_attend(
            torch.ones((1, 1, D)), new, new.clone(), torch.ones((1, 1)), torch.ones((1, 1)),
            cache, cache.clone(), scales, scales.clone(), torch.zeros((1, 2), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), 0, codec=codec, block_size=bs, collect_stats=True)
        torch.testing.assert_close(out, torch.zeros((1, 1, D)), rtol=0, atol=0)
        assert stats.tolist() == [[0, 0]]
        return
    D, bs = 32, 16
    dw, pw = ts.data_words(codec, D), ts.parity_words(codec, D)
    cache = torch.zeros((1, 2, 1, dw, bs), dtype=torch.int32)
    parity = torch.zeros((1, 2, 1, pw, bs), dtype=torch.int32)
    scales = torch.ones((1, 2, 1, bs))
    new = torch.zeros((1, 1, dw + pw), dtype=torch.int32)
    args = (torch.ones((1, 1, D)), new, new.clone(), torch.ones((1, 1)), torch.ones((1, 1)),
            cache, cache.clone(), scales, scales.clone(),
            torch.zeros((1, 2), dtype=torch.int32), torch.ones(1, dtype=torch.int32), 0,
            parity, parity.clone())
    out, stats = paged_attention_ecc_write_attend(*args, scrub=False, codec=codec,
                                                  block_size=bs, collect_stats=True)
    # hamming codeword 0 is nibble 0: every value dequantizes to -8
    torch.testing.assert_close(out, torch.full((1, 1, D), -8.0), rtol=0, atol=0)
    assert stats.tolist() == [[0, 0]]


SEEDS = [0, 1, -1, 7, -123456789, 2 ** 31 - 1, -2 ** 31]
THRESHOLDS = [0, 0xFFFFFFFF, int(1e-2 * 2 ** 32), int(0.3 * 2 ** 32), 1 << 31]


@pytest.mark.parametrize("shape", [(16, 128), (3, 5), (2, 3, 4)])
@pytest.mark.parametrize("base", [0, 12345, -40, 2 ** 31 - 100])
def test_hash_flip_mask_matches_jax(shape, base):
    """swar.hash_flip_mask bit for bit against JAX's over seeds (negative
    too) and thresholds 0, 2^32 - 1, 1e-2 and 0.3 of 2^32 and 2^31: the
    int32 wrap of JAX's products and shifts reproduced in int64."""
    for seed in SEEDS:
        for th in THRESHOLDS:
            want = js.hash_flip_mask(jnp.int32(seed), jnp.int32(base), shape, th)
            got = ts.hash_flip_mask(seed, base, shape, th)
            same(want, got)
    assert not ts.hash_flip_mask(3, base, shape, 0).any()
    assert (ts.hash_flip_mask(3, base, shape, THRESHOLDS[3]) != 0).any()
    # a tensor seed and a tensor of bases give the same bits as ints
    bases = torch.tensor([base, base + 7], dtype=torch.int64).reshape((2,) + (1,) * len(shape))
    many = ts.hash_flip_mask(torch.tensor(-5, dtype=torch.int32), bases, shape, THRESHOLDS[3])
    same(js.hash_flip_mask(jnp.int32(-5), jnp.int32(base + 7), shape, THRESHOLDS[3]), many[1])


@pytest.mark.parametrize("axis", [-1, 1])
def test_bytes_and_int4_packing(axis):
    rng = np.random.default_rng(0)
    by = rng.integers(0, 256, (3, 32, 5))
    nib = rng.integers(0, 16, (3, 64, 5))
    ax = axis if axis == 1 else -1
    by_ax = by if axis == 1 else np.moveaxis(by, 1, -1)
    nib_ax = nib if axis == 1 else np.moveaxis(nib, 1, -1)
    w = ts.pack_bytes4(t(by_ax), axis=ax)
    same(js.pack_bytes4(jnp.asarray(by_ax), axis=ax), w)
    same(js.unpack_bytes4(jnp.asarray(np.asarray(w)), axis=ax), ts.unpack_bytes4(w, axis=ax))
    w4 = ts.pack_int4(t(nib_ax), axis=ax)
    same(js.pack_int4(jnp.asarray(nib_ax), axis=ax), w4)
    same(js.unpack_int4(jnp.asarray(np.asarray(w4)), axis=ax), ts.unpack_int4(w4, axis=ax))
    np.testing.assert_array_equal(ts.unpack_int4(w4, axis=ax).numpy(), nib_ax)
    for a, b in zip(js.int4_split(jnp.asarray(np.asarray(w4))), ts.int4_split(w4)):
        same(a, b)


def test_pack_int4_bit_order():
    """Byte k of word j: value 4j+k in the low nibble, D/2+4j+k in the high."""
    D = 16
    vals = torch.arange(D, dtype=torch.int32) % 16
    w = ts.pack_int4(vals)
    for j in range(D // 8):
        for k in range(4):
            byte = (int(w[j]) >> (8 * k)) & 0xFF
            assert byte & 0xF == 4 * j + k
            assert byte >> 4 == D // 2 + 4 * j + k


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_golay_packing(head_dim):
    rng = np.random.default_rng(head_dim)
    pv = ts.padded_values("golay", head_dim)
    nib = rng.integers(0, 16, (4, 3, pv))
    d12 = ts.golay_pack_thirds(t(nib))
    same(js.golay_pack_thirds(jnp.asarray(nib)), d12)
    same(js.golay_unpack_thirds(jnp.asarray(np.asarray(d12))), ts.golay_unpack_thirds(d12))
    cw = rng.integers(0, 1 << 24, (4, 3, pv // 3))
    w = ts.golay_split_pack(t(cw), head_dim)
    same(js.golay_split_pack(jnp.asarray(cw), head_dim), w)
    same(js.golay_split_unpack(jnp.asarray(np.asarray(w)), head_dim),
         ts.golay_split_unpack(w, head_dim))
    np.testing.assert_array_equal(ts.golay_split_unpack(w, head_dim).numpy(), cw)
    # rows packed straight from nibbles == encode + split pack
    rows = ts.golay_pack_rows_from_nibbles(t(nib), head_dim)
    same(js.golay_pack_rows_from_nibbles(jnp.asarray(nib), head_dim), rows)
    same(js.golay_split_pack(js.golay_encode_wide(js.golay_pack_thirds(jnp.asarray(nib))),
                             head_dim), rows)


def test_golay_encode_forms():
    d12 = np.random.default_rng(1).integers(0, 1 << 12, (7, 44))
    wide = ts.golay_encode_wide(t(d12))
    same(js.golay_encode_wide(jnp.asarray(d12)), wide)
    same(jc.golay_encode_i32(jnp.asarray(d12), B_MASKS), tc.golay_encode_i32(t(d12), B_MASKS))
    same(js.golay_parity_xor(jnp.asarray(d12)), ts.golay_parity_xor(t(d12)))
    np.testing.assert_array_equal((wide.numpy() >> 12) & 0xFFF,
                                  ts.golay_parity_xor(t(d12)).numpy())


def _error_patterns(max_weight):
    pats = [0]
    for w in range(1, max_weight + 1):
        pats += [sum(1 << b for b in c) for c in combinations(range(24), w)]
    return np.asarray(pats, dtype=np.int64)


@pytest.fixture(scope="module")
def golay_received():
    """Codewords of a sample of data words with every error pattern of
    weight <= 3, plus 4000 random weight-4 and 2000 weight-5 patterns."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 1 << 12, 6)
    cw = np.asarray(js.golay_encode_wide(jnp.asarray(data, jnp.int32)), np.int64)
    pats = [_error_patterns(3)]
    for w, n in ((4, 4000), (5, 2000)):
        bits = np.argsort(rng.random((n, 24)), axis=1)[:, :w]
        pats.append((1 << bits).sum(axis=1))
    pats = np.concatenate(pats)
    return (cw[:, None] ^ pats[None, :]).astype(np.int32), pats.astype(np.int32)


@pytest.mark.parametrize("zero_uncorrectable", [False, True])
def test_golay_decoders_match(golay_received, zero_uncorrectable):
    rx, _ = golay_received
    jd, jn = js.golay_decode_wide(jnp.asarray(rx), zero_uncorrectable=zero_uncorrectable)
    td, tn = ts.golay_decode_wide(t(rx), zero_uncorrectable=zero_uncorrectable)
    same(jd, td)
    same(jn, tn)
    cd, cn = tc.golay_decode_i32(t(rx), B_MASKS, zero_uncorrectable=zero_uncorrectable)
    same(jd, cd)
    same(jn, cn)
    if zero_uncorrectable:
        same(jc.golay_correct_data_i32(jnp.asarray(rx), B_MASKS),
             tc.golay_correct_data_i32(t(rx), B_MASKS))


def test_scrub_fold_mask_matches(golay_received):
    _, pats = golay_received
    masks = pats[: (pats.size // 44) * 44].reshape(-1, 44)  # [..., C]
    same(js.scrub_fold_mask("golay", jnp.asarray(masks)), ts.scrub_fold_mask("golay", t(masks)))
    nib_masks = masks & 0xF
    same(js.scrub_fold_mask("int4", jnp.asarray(nib_masks)),
         ts.scrub_fold_mask("int4", t(nib_masks)))


@pytest.mark.parametrize("codec", ["int4", "golay"])
@pytest.mark.parametrize("head_dim", [16, 128, 60])
def test_codeword_paths(codec, head_dim):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 16, (2, 5, 3, head_dim))
    enc = ts.encode_codewords(codec, t(q), head_dim)
    same(js.encode_codewords(codec, jnp.asarray(q), head_dim), enc)
    mask = rng.integers(0, 1 << (24 if codec == "golay" else 4), enc.shape)
    noisy = enc ^ t(mask)
    jn = jnp.asarray(noisy.numpy())
    same(js.scrub_codewords(codec, jn), ts.scrub_codewords(codec, noisy))
    for zu in (False, True):
        same(js.decode_values(codec, jn, head_dim, zero_uncorrectable=zu),
             ts.decode_values(codec, noisy, head_dim, zero_uncorrectable=zu))
    packed = ts.pack_codewords(codec, noisy, head_dim, axis=-1)
    same(js.pack_codewords(codec, jn, head_dim), packed)
    same(js.unpack_codewords(codec, jnp.asarray(packed.numpy()), head_dim),
         ts.unpack_codewords(codec, packed, head_dim))
    d, p = ts.split_rows(codec, packed, head_dim)
    jd, jp = js.split_rows(codec, jnp.asarray(packed.numpy()), head_dim)
    same(jd, d)
    if jp is None:
        assert p is None
    else:
        same(jp, p)
    assert torch.equal(ts.join_rows(codec, d, p), packed)


# =============================================================================
# Hamming(7,4) / Hamming(8,4): every codeword, the SWAR words and the layouts
# =============================================================================

ALL7 = np.arange(128, dtype=np.int32)
ALL8 = np.arange(256, dtype=np.int32)


def test_hamming_scalar_helpers_all_codewords():
    same(jc.hamming7_syndrome_i32(jnp.asarray(ALL7)), tc.hamming7_syndrome_i32(t(ALL7)))
    syn = np.arange(8, dtype=np.int32)
    same(jc.h74_error_mask_i32(jnp.asarray(syn)), tc.h74_error_mask_i32(t(syn)))
    same(jc._h74_data_correction_i32(jnp.asarray(syn)), tc._h74_data_correction_i32(t(syn)))
    for a, b in zip(jc.hamming74_decode_i32(jnp.asarray(ALL7)), tc.hamming74_decode_i32(t(ALL7))):
        same(a, b)
    for a, b in zip(jc.hamming84_decode_i32(jnp.asarray(ALL8)), tc.hamming84_decode_i32(t(ALL8))):
        same(a, b)
    same(jc.hamming74_correct_data_i32(jnp.asarray(ALL7)), tc.hamming74_correct_data_i32(t(ALL7)))
    same(jc.hamming84_correct_data_i32(jnp.asarray(ALL8)), tc.hamming84_correct_data_i32(t(ALL8)))
    # every 8-bit value encodes its low nibble (the encoders mask)
    same(jc.hamming74_encode_i32(jnp.asarray(ALL8)), tc.hamming74_encode_i32(t(ALL8)))
    same(jc.hamming84_encode_i32(jnp.asarray(ALL8)), tc.hamming84_encode_i32(t(ALL8)))
    # the error classes: all four occur over the 256 received words
    _, et = tc.hamming84_decode_i32(t(ALL8))
    assert set(et.tolist()) == {0, 1, 2, 3}


def _byte_words(rng, n):
    """int32 words whose 4 byte slots run over all 256 codewords (slot k of
    word i holds codeword (i + 64k) % 256), then random words."""
    i = np.arange(256)
    b = np.stack([(i + 64 * k) % 256 for k in range(4)], axis=-1)
    words = np.ascontiguousarray(b.astype(np.uint8)).view(np.int32)[:, 0]
    return np.concatenate([words, rng.integers(-2**31, 2**31, n).astype(np.int32)])


def test_h84_swar_group():
    rng = np.random.default_rng(11)
    x = _byte_words(rng, 4096).reshape(-1, 16)
    jx, tx = jnp.asarray(x), t(x)
    for a, b in zip(js.h84_swar_syndromes(jx), ts.h84_swar_syndromes(tx)):
        same(a, b)
    a, b, c, podd = ts.h84_swar_syndromes(tx)
    single = (a | b | c) & podd
    same(js._h84_data_correction(*(jnp.asarray(v.numpy()) for v in (a, b, c, single))),
         ts._h84_data_correction(a, b, c, single))
    same(js.h84_swar_correct_data(jx), ts.h84_swar_correct_data(tx))
    for u, v in zip(js.h84_swar_decode(jx), ts.h84_swar_decode(tx)):
        same(u, v)
    nib = x & 0x0F0F0F0F
    same(js.h84_swar_encode(jnp.asarray(nib)), ts.h84_swar_encode(t(nib)))
    # byte slot k decodes as the scalar decoder decodes codeword k
    dec, _, dbl = ts.h84_swar_decode(tx)
    by = ts.unpack_bytes4(tx)
    d_s, et = tc.hamming84_decode_i32(by)
    assert torch.equal(ts.unpack_bytes4(dec), d_s)
    assert torch.equal(ts.unpack_bytes4(dbl), (et == 2).to(torch.int32))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_hamming_layouts(head_dim):
    rng = np.random.default_rng(head_dim + 1)
    pv7, pv8 = ts.padded_values("hamming74", head_dim), ts.padded_values("hamming84", head_dim)
    cw7 = rng.integers(0, 128, (3, 5, pv7))
    cw8 = rng.integers(0, 256, (3, 5, pv8))
    for nbits in (3, 4, 7):
        vals = rng.integers(0, 1 << nbits, (3, 5, pv7))
        w = ts._slice_pack(t(vals), nbits)
        same(js._slice_pack(jnp.asarray(vals), nbits), w)
        same(js._slice_unpack(jnp.asarray(np.asarray(w)), nbits), ts._slice_unpack(w, nbits))
        np.testing.assert_array_equal(ts._slice_unpack(w, nbits).numpy(), vals)
    w7 = ts.h74_split_pack(t(cw7))
    same(js.h74_split_pack(jnp.asarray(cw7)), w7)
    same(js.h74_split_unpack(jnp.asarray(np.asarray(w7))), ts.h74_split_unpack(w7))
    np.testing.assert_array_equal(ts.h74_split_unpack(w7).numpy(), cw7)
    cw8_ax1 = np.moveaxis(cw8, -1, 1)  # codewords on axis 1
    w8 = ts.h84_split_pack(t(cw8_ax1), axis=1)
    same(js.h84_split_pack(jnp.asarray(cw8_ax1), axis=1), w8)
    same(js.h84_split_unpack(jnp.asarray(np.asarray(w8)), axis=1), ts.h84_split_unpack(w8, axis=1))
    np.testing.assert_array_equal(ts.h84_split_unpack(w8, axis=1).numpy(), cw8_ax1)
    w8 = ts.h84_split_pack(t(cw8))
    half = w8.shape[-1] // 2
    jw = jnp.asarray(w8.numpy())
    for a, b in zip(js.h84_rebuild_cw_words(jw[..., :half], jw[..., half:]),
                    ts.h84_rebuild_cw_words(w8[..., :half], w8[..., half:])):
        same(a, b)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_h74_plane_correction(head_dim):
    """The correcting read's h74 tile math: parity planes expanded to bits,
    then per-value correction, on a [words, bs] page tile of noisy rows."""
    rng = np.random.default_rng(head_dim + 2)
    pv, bs = ts.padded_values("hamming74", head_dim), 16
    q = rng.integers(0, 16, (bs, pv))
    cw = np.array(jc.hamming74_encode_i32(jnp.asarray(q, jnp.int32)))
    cw ^= rng.integers(0, 128, cw.shape) * (rng.random(cw.shape) < 0.3)
    tile = ts.h74_split_pack(t(cw)).T.contiguous()  # [W, bs]: token-minor
    dw, G = pv // 8, pv // 32
    d = ts.unpack_int4(tile[:dw], axis=0)
    planes = [ts.h74_plane_bits(tile[dw + p * G: dw + (p + 1) * G], G) for p in range(3)]
    jplanes = [js.h74_plane_bits(jnp.asarray(tile[dw + p * G: dw + (p + 1) * G].numpy()), G)
               for p in range(3)]
    for a, b in zip(jplanes, planes):
        same(a, b)
    got = ts.h74_value_correct(d, *planes)
    want = js.h74_value_correct(jnp.asarray(d.numpy()), *jplanes)
    for a, b in zip(want, got):
        same(a, b)
    # the plane correction is the scalar data-only corrector
    np.testing.assert_array_equal(got[0].numpy().T,
                                  np.asarray(jc.hamming74_correct_data_i32(jnp.asarray(cw))))


@pytest.mark.parametrize("head_dim", list(range(8, 257, 8)) + [33, 60, 100])
def test_hamming_word_counts(head_dim):
    for codec in ("hamming74", "hamming84"):
        for fn in ("padded_values", "row_words", "data_words", "parity_words",
                   "scrub_extract_ok"):
            assert getattr(ts, fn)(codec, head_dim) == getattr(js, fn)(codec, head_dim), fn


@pytest.mark.parametrize("codec", ["hamming74", "hamming84"])
@pytest.mark.parametrize("head_dim", [16, 128, 60])
def test_hamming_codeword_paths(codec, head_dim):
    rng = np.random.default_rng(4)
    q = rng.integers(0, 16, (2, 5, 3, head_dim))
    enc = ts.encode_codewords(codec, t(q), head_dim)
    same(js.encode_codewords(codec, jnp.asarray(q), head_dim), enc)
    mask = rng.integers(0, 1 << (7 if codec == "hamming74" else 8), enc.shape)
    mask = mask * (rng.random(enc.shape) < 0.5)
    noisy = enc ^ t(mask)
    jn = jnp.asarray(noisy.numpy())
    same(js.scrub_codewords(codec, jn), ts.scrub_codewords(codec, noisy))
    same(js.decode_values(codec, jn, head_dim), ts.decode_values(codec, noisy, head_dim))
    fold = ts.scrub_fold_mask(codec, t(mask))
    same(js.scrub_fold_mask(codec, jnp.asarray(mask)), fold)
    # the fold is the scrub: encode(q ^ fold(mask)) == scrub(encode(q) ^ mask)
    qp = ts._pad_values(t(q), enc.shape[-1])
    assert torch.equal(ts.encode_codewords(codec, qp ^ fold, enc.shape[-1]),
                       ts.scrub_codewords(codec, noisy))
    packed = ts.pack_codewords(codec, noisy, head_dim)
    same(js.pack_codewords(codec, jn, head_dim), packed)
    same(js.unpack_codewords(codec, jnp.asarray(packed.numpy()), head_dim),
         ts.unpack_codewords(codec, packed, head_dim))
    d, p = ts.split_rows(codec, packed, head_dim)
    jd, jp = js.split_rows(codec, jnp.asarray(packed.numpy()), head_dim)
    same(jd, d)
    same(jp, p)
    assert torch.equal(ts.join_rows(codec, d, p), packed)


@pytest.mark.parametrize("seq_dim", [0, 1, -1])
def test_interpolation_matches(seq_dim):
    from qkv_ecc_tpu.codecs.algebra import ErrorType as JE
    from qkv_ecc_tpu.codecs.interpolation import interpolate_double_errors as j_interp
    from qkv_ecc_tpu_torch.codecs.algebra import ErrorType as TE
    from qkv_ecc_tpu_torch.codecs.interpolation import interpolate_double_errors as t_interp

    assert [getattr(JE, n) for n in ("NO_ERROR", "SINGLE_CORRECTED", "DOUBLE_DETECTED",
                                     "PARITY_ONLY")] == [0, 1, 2, 3]
    for n in ("NO_ERROR", "SINGLE_CORRECTED", "DOUBLE_DETECTED", "PARITY_ONLY"):
        assert getattr(JE, n) == getattr(TE, n)
    rng = np.random.default_rng(5)
    q = rng.integers(0, 16, (6, 7, 16)).astype(np.uint8)
    et = rng.integers(0, 4, q.shape).astype(np.int32)
    got = t_interp(torch.from_numpy(q), t(et), seq_dim=seq_dim)
    assert got.dtype == torch.uint8
    same(j_interp(jnp.asarray(q), jnp.asarray(et), seq_dim=seq_dim), got)
    # one-long sequence axis: the value is its own neighbour
    one = np.full((1, 3), 9, np.uint8)
    same(j_interp(jnp.asarray(one), jnp.full((1, 3), 2), seq_dim=0),
         t_interp(torch.from_numpy(one), torch.full((1, 3), 2), seq_dim=0))


@pytest.mark.parametrize("shape,axis", [((5, 12), -1), ((4, 7), 0), ((2, 3, 24), -1)])
def test_golay_pack4_matches_jax(shape, axis):
    """golay_pack4 / golay_unpack4 (JAX's byte-plane layout) bit for bit,
    and their roundtrip."""
    rng = np.random.default_rng(sum(shape))
    shp = list(shape)
    shp[axis] *= 4
    cw = rng.integers(0, 1 << 24, shp).astype(np.int32)
    w = ts.golay_pack4(t(cw), axis=axis)
    same(js.golay_pack4(jnp.asarray(cw), axis=axis), w)
    same(js.golay_unpack4(jnp.asarray(w.numpy()), axis=axis), ts.golay_unpack4(w, axis=axis))
    np.testing.assert_array_equal(ts.golay_unpack4(w, axis=axis).numpy(), cw)


@pytest.mark.parametrize("codec", ["int4", "hamming74", "hamming84", "golay"])
@pytest.mark.parametrize("head_dim", [16, 33, 64, 128])
def test_encode_row_matches_jax(codec, head_dim):
    q = np.random.default_rng(head_dim).integers(0, 16, (3, 2, head_dim)).astype(np.int32)
    got = ts.encode_row(codec, t(q), head_dim)
    same(js.encode_row(codec, jnp.asarray(q), head_dim), got)
    assert torch.equal(got, ts.pack_codewords(codec, ts.encode_codewords(codec, t(q), head_dim),
                                              head_dim))
