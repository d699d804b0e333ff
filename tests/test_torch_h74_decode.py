"""Hamming(7,4)'s correcting read as csrc/decode_attend.cu decodes it, in
its plain PyTorch version (qkv_ecc_tpu_torch.kernels.paged_attention
h74_parity_lanes, h74_decode_rows), against the JAX package's swar
functions, bit for bit, at 4, 8 and 16 data words a row (G = 1, 2 and 4
parity words a plane): the parity moved onto the data words' nibble lanes
against ``_slice_unpack`` and ``h74_plane_bits``, and the decode against
``h74_value_correct`` on clean rows, rows flipped at BER 1e-2 and the
all-zero and all-ones words."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs import reference as jr  # noqa: E402
from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)
DATA_WORDS = (4, 8, 16)
ROWS = 96


def _parity_bits(parity, data_words):
    """JAX's per-value parity bits [rows, 8 * data_words, 3] of the planes
    [rows, 3 G]: through h74_plane_bits, plane by plane, on [G, rows]."""
    G = data_words // 4
    planes = jnp.asarray(parity).T  # [3 G, rows]
    bits = [np.asarray(js.h74_plane_bits(planes[p * G:(p + 1) * G], G)) for p in range(3)]
    return np.stack(bits, axis=-1).transpose(1, 0, 2)


@pytest.mark.parametrize("data_words", DATA_WORDS)
def test_parity_lanes_match_jax(data_words):
    """Bit 8k + 4hi + p of lane word J is parity bit p of value hi * 4
    data_words + 4J + k: pack_int4 of JAX's _slice_unpack, and each bit as
    h74_plane_bits gives it."""
    rng = np.random.default_rng(data_words)
    parity = rng.integers(-2 ** 31, 2 ** 31, size=(ROWS, 3 * data_words // 4),
                          dtype=np.int64).astype(np.int32)
    got = tpa.h74_parity_lanes(torch.from_numpy(parity), data_words).numpy()
    want = np.asarray(js.pack_int4(js._slice_unpack(jnp.asarray(parity), 3)))
    np.testing.assert_array_equal(got, want)
    nib = np.asarray(js.unpack_int4(jnp.asarray(got)))  # [rows, 8 * data_words]
    lanes = np.stack([(nib >> p) & 1 for p in range(3)], axis=-1)
    np.testing.assert_array_equal(lanes, _parity_bits(parity, data_words))
    assert not (nib & 8).any()


def _rows(kind, data_words, rng):
    """hamming74 rows [ROWS, data_words + 3 data_words / 4] of a kind."""
    width = data_words + 3 * data_words // 4
    if kind == "zeros":
        return np.zeros((ROWS, width), np.int32)
    if kind == "ones":
        return np.full((ROWS, width), -1, np.int32)
    values = rng.integers(0, 16, size=(ROWS, 8 * data_words))
    rows = np.asarray(js.h74_split_pack(jr.hamming74_encode(jnp.asarray(values, jnp.uint8))))
    if kind == "ber":
        flips = rng.random((ROWS, width, 32)) < 1e-2
        mask = (flips.astype(np.int64) << np.arange(32)).sum(-1)
        rows = (rows.astype(np.int64) ^ mask).astype(np.uint32).view(np.int32)
    return rows.astype(np.int32)


@pytest.mark.parametrize("kind", ("clean", "ber", "zeros", "ones"))
@pytest.mark.parametrize("data_words", DATA_WORDS)
def test_decode_rows_match_jax(data_words, kind):
    """h74_decode_rows (the kernel's SWAR decode on the data words' lanes)
    gives h74_value_correct's nibbles and nonzero-syndrome mask on the same
    rows: nothing on clean rows, some on rows flipped at BER 1e-2."""
    rng = np.random.default_rng(100 + data_words)
    rows = _rows(kind, data_words, rng)
    nib, err = tpa.h74_decode_rows(torch.from_numpy(rows), data_words)
    bits = _parity_bits(rows[:, data_words:], data_words)
    d = js.unpack_int4(jnp.asarray(rows[:, :data_words]))
    dec, mask = js.h74_value_correct(d, *(jnp.asarray(bits[..., p]) for p in range(3)))
    np.testing.assert_array_equal(nib.numpy(), np.asarray(dec))
    np.testing.assert_array_equal(err.numpy(), np.asarray(mask) != 0)
    if kind == "clean":
        assert not err.any()
    if kind == "ber":
        assert err.any()
    count = tpa.count_errors("hamming74", torch.from_numpy(rows)[:, None, None],
                             torch.ones((ROWS, 1), dtype=torch.bool), data_words, 0)
    assert count[:, 0].sum() == int(np.asarray(mask).sum()) and not count[:, 1].any()
