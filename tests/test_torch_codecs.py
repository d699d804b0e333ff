"""The port's codec layer (qkv_ecc_tpu_torch.codecs: algebra, reference,
fault_injection) against the JAX package's: the tables equal, the oracles
bit for bit on exhaustive inputs (every nibble, every byte, every Golay
data word, every error pattern of weight <= 3 on a sample of codewords and
weight-4 patterns beyond), the codec classes, and the fault injector's
rate and determinism (its bits are torch's own, as the JAX module's
contract allows)."""

import os
from itertools import combinations

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs import algebra as ja  # noqa: E402
from qkv_ecc_tpu.codecs import fault_injection as jf  # noqa: E402
from qkv_ecc_tpu.codecs import reference as jr  # noqa: E402
from qkv_ecc_tpu_torch import codecs as tcodecs  # noqa: E402
from qkv_ecc_tpu_torch.codecs import algebra as ta  # noqa: E402
from qkv_ecc_tpu_torch.codecs import fault_injection as tf  # noqa: E402
from qkv_ecc_tpu_torch.codecs import reference as tr  # noqa: E402

torch.set_num_threads(1)
TABLES = ("HAMMING74_G", "HAMMING74_H", "HAMMING84_G", "HAMMING84_H", "SYNDROME_LUT_HAMMING74",
          "SYNDROME_LUT_HAMMING84", "GOLAY_B_MATRIX", "GOLAY_B_ROW_MASKS", "GOLAY_H_ROW_MASKS",
          "GOLAY_SYNDROME_TABLE", "GOLAY_G", "GOLAY_H")


def same(want, got, err_msg=""):
    """JAX output and torch output: equal values of the same width."""
    want, got = np.asarray(want), got.numpy()
    assert want.dtype == got.dtype, (err_msg, want.dtype, got.dtype)
    np.testing.assert_array_equal(want, got, err_msg=err_msg)


def test_tables_match_jax():
    for name in TABLES:
        want, got = getattr(ja, name), getattr(ta, name)
        assert want.dtype == got.dtype, name
        np.testing.assert_array_equal(want, got, err_msg=name)
    np.testing.assert_array_equal(ja.build_golay_syndrome_table(), ta.build_golay_syndrome_table())
    assert (ta.GOLAY_SYNDROME_TABLE >= 0).sum() == 2325  # 1 + 24 + C(24,2) + C(24,3)
    assert ta.ErrorType.__dict__.items() >= {k: v for k, v in ja.ErrorType.__dict__.items()
                                             if k.isupper()}.items()
    assert ta.GOLAY_UNCORRECTABLE_COUNT == ja.GOLAY_UNCORRECTABLE_COUNT
    for codec in ("hamming74", "hamming84", "golay"):
        assert ta.get_codeword_bits(codec) == ja.get_codeword_bits(codec)
        assert ta.get_data_bits(codec) == ja.get_data_bits(codec)
    for codec in ("hamming74", "hamming84", "int4", "golay", "none", "fp16"):
        assert str(ta.get_physical_dtype(codec)).removeprefix("torch.") == np.dtype(
            ja.get_physical_dtype(codec)).name, codec
    for fn in ("get_codeword_bits", "get_data_bits", "get_physical_dtype"):
        with pytest.raises(ValueError):
            getattr(ta, fn)("int3")


def test_hamming_exhaustive():
    """Encoders on all 16 nibbles, decoders on all 256 bytes (hamming74
    reads the low 7 bits): data, flags, error types and counts."""
    nib = np.arange(16, dtype=np.uint8)
    for enc in ("hamming74_encode", "hamming84_encode"):
        same(getattr(jr, enc)(jnp.asarray(nib)), getattr(tr, enc)(torch.from_numpy(nib)), enc)
    byte = np.arange(256, dtype=np.uint8)
    jb, tb = jnp.asarray(byte), torch.from_numpy(byte)
    for dec in ("hamming74_decode", "hamming84_decode"):
        for i, (w, g) in enumerate(zip(getattr(jr, dec)(jb), getattr(tr, dec)(tb))):
            same(w, g, f"{dec} output {i}")
    # every single error of every codeword corrects
    cw = tr.hamming84_encode(torch.arange(16))
    flips = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8)
    data, et, corrected, _ = tr.hamming84_decode(cw[:, None] ^ flips[None, :])
    assert torch.equal(data, torch.arange(16, dtype=torch.uint8)[:, None].expand(16, 8))
    assert int(corrected) == 16 * 7 and (et[:, 7] == ta.ErrorType.PARITY_ONLY).all()


def test_golay_exhaustive():
    """golay_encode on all 4096 data words; golay_syndrome, golay_decode
    (table) and golay_decode_algebraic on 64 sampled codewords under every
    error pattern of weight <= 3 (2325 patterns) and 300 patterns of weight
    4: triplets, error counts and totals equal JAX's, and the decodes
    recover the data wherever the weight is <= 3."""
    data = np.arange(4096, dtype=np.int32)
    trip = np.stack([data & 0xF, (data >> 4) & 0xF, (data >> 8) & 0xF], -1).astype(np.uint8)
    same(jr.golay_encode(jnp.asarray(trip)), tr.golay_encode(torch.from_numpy(trip)))
    same(jr.golay_pack(jnp.asarray(trip)), tr.golay_pack(torch.from_numpy(trip)))
    same(jr.golay_unpack(jnp.asarray(data)), tr.golay_unpack(torch.from_numpy(data)))
    rng = np.random.default_rng(0)
    cw = np.asarray(jr.golay_encode(jnp.asarray(trip[rng.choice(4096, 64, replace=False)])))
    patterns = [0] + [sum(1 << b for b in c) for w in (1, 2, 3) for c in combinations(range(24), w)]
    assert len(patterns) == 2325
    four = [sum(1 << int(b) for b in rng.choice(24, 4, replace=False)) for _ in range(300)]
    received = (cw[:, None] ^ np.asarray(patterns + four, np.int32)[None, :]).astype(np.int32)
    jx, tx = jnp.asarray(received), torch.from_numpy(received)
    same(jr.golay_syndrome(jx), tr.golay_syndrome(tx), "syndrome")
    for dec in ("golay_decode", "golay_decode_algebraic"):
        got = getattr(tr, dec)(tx)
        for i, (w, g) in enumerate(zip(getattr(jr, dec)(jx), got)):
            same(w, g, f"{dec} output {i}")
        want = tr.golay_unpack(torch.from_numpy(cw & 0xFFF))[:, None]
        assert torch.equal(got[0][:, :2325], want.expand(64, 2325, 3)), dec
        assert int(got[3]) > 0  # weight-4 patterns include uncorrectable ones


def test_codec_classes_match_jax():
    rng = np.random.default_rng(1)
    vals = rng.integers(0, 16, (50,), dtype=np.uint8)
    flips = (1 << rng.integers(0, 8, (50,))).astype(np.uint8)
    for name in ("Hamming74", "Hamming84"):
        j, t = getattr(jr, name)(), getattr(tr, name)()
        assert (j.n_bits, j.data_bits) == (t.n_bits, t.data_bits)
        jc, tc = j.encode(vals), t.encode(torch.from_numpy(vals))
        same(jc, tc, name)
        bad = np.asarray(jc) ^ flips
        want, got = j.decode(bad), t.decode(torch.from_numpy(bad))
        same(want[0], got[0], name)
        assert want[-1] == got[-1], name
    want, got = jr.Hamming84().decode(bad, True), tr.Hamming84().decode(torch.from_numpy(bad), True)
    same(want[1], got[1])
    j, t = jr.Golay2412(), tr.Golay2412()
    trip = rng.integers(0, 16, (50, 3), dtype=np.uint8)
    same(j.encode(trip), t.encode(torch.from_numpy(trip)))
    bad = np.asarray(j.encode(trip)) ^ (1 << rng.integers(0, 24, (50,))).astype(np.int32)
    want, got = j.decode(bad), t.decode(torch.from_numpy(bad))
    same(want[0], got[0])
    assert want[1] == got[1]
    assert t.verify_properties(device="cpu") and j.verify_properties()


def test_fault_injection():
    """verify_ber_fidelity and verify_determinism hold, as in JAX; the
    injector keeps the data's type, reports its flips, draws from a given
    generator, and at BER 0 returns the data untouched."""
    ok, rate = tf.verify_ber_fidelity(device="cpu")
    assert ok and jf.verify_ber_fidelity()[0] and abs(rate - 0.01) < 0.15 * 0.01
    assert tf.verify_determinism(device="cpu") and jf.verify_determinism()
    data = torch.arange(1000, dtype=torch.int32) & 0xFFFFFF
    out, (flips, affected) = tf.inject_bit_errors(data, 0.05, 24, seed=3, return_stats=True)
    assert out.dtype == torch.int32 and flips == int(tcodecs.reference.popcount(out ^ data).sum())
    assert affected == int((out != data).sum()) and 0 < affected <= flips
    g = torch.Generator().manual_seed(3)
    assert torch.equal(tf.inject_bit_errors(data, 0.05, 24, generator=g), out)
    assert torch.equal(tf.flip_mask_for(torch.Generator().manual_seed(3), (1000,), 0.05, 24),
                       out ^ data)
    small = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    assert tf.inject_bit_errors(small, 0.3, 8, seed=1).dtype == torch.uint8
    assert tf.inject_bit_errors(small, 0.0, 8) is small
    assert tf.inject_bit_errors(small, 0.0, 8, return_stats=True)[1] == (0, 0)


def test_verifiers_need_a_card_unless_told():
    """F8: given no device the verifiers run on the card, as every entry
    point of the port does, and raise when there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means that card")
    for call in (tf.verify_ber_fidelity, tf.verify_determinism,
                 tr.Golay2412().verify_properties):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tf.verify_ber_fidelity(n=10_000, device="cpu")[0]
