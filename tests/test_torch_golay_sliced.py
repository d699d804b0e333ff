"""The port's bit-sliced Golay reference (qkv_ecc_tpu_torch.kernels.golay_sliced)
against the JAX module, bit for bit: every case of the JAX package's
tests/test_golay_sliced.py runs through both packages on the same numpy
inputs (and the JAX cases' own assertions on the port's results, against
the per-lane decoder)."""

import itertools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs.algebra import GOLAY_B_ROW_MASKS  # noqa: E402
from qkv_ecc_tpu.kernels import common as jc  # noqa: E402
from qkv_ecc_tpu.kernels import golay_sliced as jgs  # noqa: E402
from qkv_ecc_tpu_torch.kernels import golay_sliced as tgs  # noqa: E402

torch.set_num_threads(1)
BM = tuple(int(m) for m in GOLAY_B_ROW_MASKS)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def bits_of_rows(planes, G, n_planes):
    """[n_planes G, bs] plane-major -> [32 G, bs] per-row values."""
    gi, zi = tgs._gz_of_row(G)
    p = np.asarray(planes).reshape(n_planes, G, -1)
    bits = (p[:, gi, :] >> zi[None, :, None]) & 1
    return (bits << np.arange(n_planes)[:, None, None]).sum(axis=0)


def random_corrupted(rng, G, bs, max_errs=5):
    R = 32 * G
    data = rng.integers(0, 4096, (R, bs)).astype(np.int32)
    cw = np.asarray(jc.golay_encode_i32(jnp.asarray(data), BM))
    nerr = rng.integers(0, max_errs + 1, (R, bs))
    for n in range(1, max_errs + 1):
        pos = rng.integers(0, 24, (R, bs))
        cw = np.where(nerr >= n, cw ^ (1 << pos), cw)
    return cw


def test_layout_helpers_match_jax():
    for head_dim in (16, 32, 64, 100, 128):
        assert tgs.cw_per_head(head_dim) == jgs.cw_per_head(head_dim)
        assert tgs.sliced_values_per_head(head_dim) == jgs.sliced_values_per_head(head_dim)
        for kv in (1, 2, 3, 8):
            assert tgs.num_groups(kv, head_dim) == jgs.num_groups(kv, head_dim)
            assert tgs.sliced_row_words(kv, head_dim) == jgs.sliced_row_words(kv, head_dim)
    for G in (2, 3, 12):
        np.testing.assert_array_equal(tgs._row_of_gz(G), jgs._row_of_gz(G))
        for a, b in zip(tgs._gz_of_row(G), jgs._gz_of_row(G)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("G", [12, 3, 2])
def test_pack_roundtrip(G):
    rng = np.random.default_rng(G)
    cw = rng.integers(0, 1 << 24, (32 * G, 16)).astype(np.int32)
    w = tgs.golay_slice_pack(t(cw), G, axis=0)
    assert w.shape == (24 * G, 16)
    same(jgs.golay_slice_pack(jnp.asarray(cw), G, axis=0), w)
    rt = tgs.golay_slice_unpack(w, G, axis=0)
    np.testing.assert_array_equal(rt.numpy(), cw)
    same(jgs.golay_slice_unpack(jnp.asarray(w.numpy()), G, n_rows=40, axis=0),
         tgs.golay_slice_unpack(w, G, n_rows=40, axis=0))
    short = cw[:50]  # zero-padded to 32 G rows
    same(jgs.golay_slice_pack(jnp.asarray(short), G, axis=0), tgs.golay_slice_pack(t(short), G,
                                                                                   axis=0))


@pytest.mark.parametrize("G", [12, 3])
def test_sliced_imld_matches_jax(G):
    rng = np.random.default_rng(7)
    cw = random_corrupted(rng, G, 64)
    want_data, want_cnt = (np.asarray(a) for a in
                           jc.golay_decode_i32(jnp.asarray(cw), BM, zero_uncorrectable=True))
    w = np.asarray(jgs.golay_slice_pack(jnp.asarray(cw), G, axis=0))
    jdata, jcorr, (jed, jep) = jgs.golay_sliced_correct_planes(jnp.asarray(w), G,
                                                               full_errors=True)
    data, corr, (ed, ep) = tgs.golay_sliced_correct_planes(t(w), G, full_errors=True)
    for a, b in ((jdata, data), (jcorr, corr), (jed, ed), (jep, ep)):
        same(a, b)
    # JAX's assertions, on the port's planes
    np.testing.assert_array_equal(bits_of_rows(data.numpy(), G, 12), want_data)
    np.testing.assert_array_equal(bits_of_rows(corr.numpy()[None], G, 1) != 0, want_cnt < 4)
    ebits = bits_of_rows(np.concatenate([ed.numpy(), ep.numpy()]), G, 24)
    cnt = np.vectorize(lambda x: bin(int(x)).count("1"))(ebits)
    ok = want_cnt < 4
    np.testing.assert_array_equal(cnt[ok], want_cnt[ok])
    # the error counts, against JAX's and the per-lane decoder's accounting
    valid = np.broadcast_to(np.asarray(jgs.valid_row_masks(G, 32 * G - 5))[:, None],
                            (G, 64)).copy()
    jn = jgs.sliced_error_count(jed, jep, jcorr, jnp.asarray(valid), G)
    tn = tgs.sliced_error_count(ed, ep, corr, t(valid), G)
    assert [int(x) for x in jn] == [int(x) for x in tn]


def test_exhaustive_weight_le3_patterns():
    """Every error pattern of weight <= 3 on a fixed codeword decodes
    exactly, in both packages."""
    G = 2
    pats = [0] + [1 << i for i in range(24)]
    pats += [(1 << i) | (1 << j) for i, j in itertools.combinations(range(24), 2)]
    pats += [(1 << i) | (1 << j) | (1 << k) for i, j, k in itertools.combinations(range(24), 3)]
    rng = np.random.default_rng(3)
    data = rng.integers(0, 4096, len(pats)).astype(np.int32)
    cw = np.asarray(jc.golay_encode_i32(jnp.asarray(data), BM)) ^ np.asarray(pats, np.int32)
    R = 32 * G
    cw = np.concatenate([cw, np.zeros((-len(cw)) % R, np.int32)])
    cols = cw.reshape(-1, R).T
    w = tgs.golay_slice_pack(t(cols), G, axis=0)
    dec, correctable, errs = tgs.golay_sliced_correct_planes(w, G)
    assert errs is None
    jdec, jcorr, _ = jgs.golay_sliced_correct_planes(jnp.asarray(w.numpy()), G)
    same(jdec, dec)
    same(jcorr, correctable)
    got = bits_of_rows(dec.numpy(), G, 12).T.reshape(-1)[:len(pats)]
    np.testing.assert_array_equal(got, data)
    corr = bits_of_rows(correctable.numpy()[None], G, 1).T.reshape(-1)[:len(pats)]
    assert (corr != 0).all()


def test_nibble_words_identity_order():
    """Byte k of word u of nibble array t is nibble t of codeword row 4u +
    k; the plane-list form gives the same words; equal to JAX's."""
    rng = np.random.default_rng(11)
    G, bs = 12, 32
    data = rng.integers(0, 4096, (32 * G, bs)).astype(np.int32)
    cw = np.asarray(jc.golay_encode_i32(jnp.asarray(data), BM))
    w = tgs.golay_slice_pack(t(cw), G, axis=0)
    dec, _, _ = tgs.golay_sliced_correct_planes(w, G)
    words = tgs.sliced_nibble_words(dec, G)
    jwords = jgs.sliced_nibble_words(jnp.asarray(dec.numpy()), G)
    planes = [dec[j * G:(j + 1) * G] for j in range(12)]
    for tt in range(3):
        same(jwords[tt], words[tt])
        assert torch.equal(tgs.sliced_nibble_words(planes, G)[tt], words[tt])
        wt = words[tt].numpy()
        by = np.stack([(wt >> (8 * k)) & 0xFF for k in range(4)], axis=1).reshape(32 * G, bs)
        np.testing.assert_array_equal(by, (data >> (4 * tt)) & 0xF)


def test_plane_list_form_matches_jax():
    rng = np.random.default_rng(5)
    G = 3
    w = np.asarray(jgs.golay_slice_pack(jnp.asarray(random_corrupted(rng, G, 16)), G, axis=0))
    d = [w[j * G:(j + 1) * G] for j in range(12)]
    p = [w[(12 + j) * G:(13 + j) * G] for j in range(12)]
    jout, jc_, (jed, jep) = jgs.golay_sliced_correct_plane_list(
        [jnp.asarray(x) for x in d], [jnp.asarray(x) for x in p], full_errors=True)
    out, c, (ed, ep) = tgs.golay_sliced_correct_plane_list([t(x) for x in d], [t(x) for x in p],
                                                          full_errors=True)
    same(jc_, c)
    for a, b in zip(jout + jed + jep, out + ed + ep):
        same(a, b)


@pytest.mark.parametrize("G,n", [(2, 48), (2, 64), (3, 90), (12, 384)])
def test_valid_row_masks(G, n):
    m = tgs.valid_row_masks(G, n)
    assert m.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), jgs.valid_row_masks(G, n))
    gi, zi = tgs._gz_of_row(G)
    bits = (m.numpy()[gi] >> zi) & 1
    np.testing.assert_array_equal(bits, (np.arange(32 * G) < n).astype(np.int32))
