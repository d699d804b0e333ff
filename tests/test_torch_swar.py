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
    for codec in ("int4", "golay"):
        for fn in ("padded_values", "row_words", "data_words", "parity_words",
                   "scrub_extract_ok"):
            assert getattr(ts, fn)(codec, head_dim) == getattr(js, fn)(codec, head_dim), fn
    assert ts.golay_data_nibbles(head_dim) == js.golay_data_nibbles(head_dim)
    assert ts.golay_prefix_covers_values(head_dim) == js.golay_prefix_covers_values(head_dim)


@pytest.mark.parametrize("codec", ["hamming74", "hamming84", "fp16", "fp8"])
def test_later_codecs_raise(codec):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ts.padded_values(codec, 128)
    with pytest.raises(NotImplementedError):
        ts.scrub_fold_mask(codec, torch.zeros(4, dtype=torch.int32))


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
