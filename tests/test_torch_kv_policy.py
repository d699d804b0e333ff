"""The port's write chain (qkv_ecc_tpu_torch.models.kv_policy) against the
JAX package's: quantization, encoding, the scrub-folded write with explicit
masks, the hoisted fold and decoding, bit for bit at BER 0 and 1e-2."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs.fault_injection import flip_mask_for  # noqa: E402
from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu.models import kv_policy as jp  # noqa: E402
from qkv_ecc_tpu_torch.codecs.fault_injection import flip_mask  # noqa: E402
from qkv_ecc_tpu_torch.kernels import swar as ts  # noqa: E402
from qkv_ecc_tpu_torch.models import kv_policy as tp  # noqa: E402

torch.set_num_threads(1)
MODES = {"int4": "int4-write-inject", "golay": "int12-golay", "hamming74": "int4-hamming",
         "hamming84": "int4-hamming84"}
CODECS = list(MODES)


def same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy())


def numpy_mask(rng, shape, ber, n_bits):
    """Per-bit Bernoulli(ber) XOR mask made with numpy, fed to both sides."""
    flips = rng.random((n_bits,) + tuple(shape)) < ber
    return (flips.astype(np.int64) << np.arange(n_bits).reshape((n_bits,) + (1,) * len(shape))
            ).sum(0).astype(np.int32)


def inputs(head_dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 5, 3, head_dim)).astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero row: scale floor 1.0
    x[1, 2, 1, :4] = [3.5, -3.5, 0.5, 7.0]  # rounding ties at scale 1.0
    return rng, x


def mask_shape(codec, x):
    pv = ts.padded_values(codec, x.shape[-1])
    return x.shape[:-1] + (pv // 3 if codec == "golay" else pv,)


def test_policy_tables():
    assert tp.N_BITS == jp.N_BITS
    assert tp.MODE_CONFIG == jp.MODE_CONFIG
    for mode in jp.MODE_CONFIG:
        a = jp.policy_for_mode(mode, ber=1e-2, seed=3)
        b = tp.policy_for_mode(mode, ber=1e-2, seed=3)
        for f in ("codec", "ber", "inject_errors", "seed", "use_interpolation", "inject_at", "scrub"):
            assert getattr(a, f) == getattr(b, f), (mode, f)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_quantize(head_dim):
    _, x = inputs(head_dim)
    jq, js_ = jp._quantize(jnp.asarray(x))
    tq, ts_ = tp._quantize(torch.from_numpy(x))
    same(jq, tq)
    same(js_, ts_)


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("ber", [0.0, 1e-2])
def test_write_chain(codec, head_dim, ber):
    rng, x = inputs(head_dim, seed=head_dim)
    jpol = jp.policy_for_mode(MODES[codec], ber=ber)
    tpol = tp.policy_for_mode(MODES[codec], ber=ber)
    mask = numpy_mask(rng, mask_shape(codec, x), max(ber, 1e-2), tp.N_BITS[codec])
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)

    jenc, jsc, jfl = jp.encode_kv(jx, jpol, None, mask=jm)
    tenc, tsc, tfl = tp.encode_kv(tx, tpol, mask=tm)
    same(jenc, tenc)
    same(jsc, tsc)
    assert int(jfl) == int(tfl)
    same(jp.pack_kv(jenc, jpol, head_dim), tp.pack_kv(tenc, tpol, head_dim))

    jsc_cw, _ = jp.encode_kv_scrubbed(jx, jpol, None, mask=jm)
    tsc_cw, _ = tp.encode_kv_scrubbed(tx, tpol, mask=tm)
    same(jsc_cw, tsc_cw)
    # the fold equals scrubbing the injected codewords
    if ber > 0:
        same(js.scrub_codewords(codec, jenc), tsc_cw)

    jrows, jsc2 = jp.encode_pack_kv_scrubbed(jx, jpol, None, mask=jm)
    trows, tsc2 = tp.encode_pack_kv_scrubbed(tx, tpol, mask=tm)
    same(jrows, trows)
    same(jsc2, tsc2)
    same(jp.pack_kv(jsc_cw, jpol, head_dim), trows)
    folded = ts.scrub_fold_mask(codec, tm)
    trows_f, _ = tp.encode_pack_kv_scrubbed(tx, tpol, folded=folded.to(torch.uint8))
    assert torch.equal(trows_f, trows)


@pytest.mark.parametrize("codec", CODECS)
def test_hoisted_write_deltas(codec):
    """JAX folds each layer's threefry mask with swar.scrub_fold_mask; the
    port folds the same raw masks given explicitly."""
    rng = np.random.default_rng(5)
    pv = ts.padded_values(codec, 128)
    enc_shape = (4, 1, 8, pv // 3 if codec == "golay" else pv)
    raw = numpy_mask(rng, (3, 2) + enc_shape, 1e-2, tp.N_BITS[codec])
    pol = tp.policy_for_mode(MODES[codec], ber=1e-2)
    got = tp.hoisted_write_deltas(pol, 3, enc_shape, raw_masks=torch.from_numpy(raw))
    want = js.scrub_fold_mask(codec, jnp.asarray(raw)).astype(jnp.uint8)
    assert got.dtype == torch.uint8
    same(want, got)
    drawn = tp.hoisted_write_deltas(pol, 3, enc_shape, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and drawn.dtype == torch.uint8


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("ber", [1e-2, 8e-2])
def test_decode_kv(codec, ber):
    rng, x = inputs(128, seed=9)
    pol_j = jp.policy_for_mode(MODES[codec], ber=ber)
    pol_t = tp.policy_for_mode(MODES[codec], ber=ber)
    mask = numpy_mask(rng, mask_shape(codec, x), ber, tp.N_BITS[codec])
    jenc, jsc, _ = jp.encode_kv(jnp.asarray(x), pol_j, None, mask=jnp.asarray(mask))
    tenc, tsc, _ = tp.encode_kv(torch.from_numpy(x), pol_t, mask=torch.from_numpy(mask))
    jx, jcorr, jdet = jp.decode_kv(jenc, jsc, pol_j, head_dim=128)
    tx, tcorr, tdet = tp.decode_kv(tenc, tsc, pol_t, head_dim=128)
    same(jx, tx)
    assert (int(jcorr), int(jdet)) == (int(tcorr), int(tdet))


@pytest.mark.parametrize("ber", [1e-2, 0.3])
def test_read_injection_not_ported(ber):
    """Read injection runs: decode_kv of the int4 arm with ``read_mask`` -
    the mask JAX draws from ``read_key``, passed to the port - gives JAX's
    values and read_flips, bit for bit; a write-inject policy ignores the
    mask but still returns 4 values."""
    _, x = inputs(16, seed=13)
    pol_j = jp.policy_for_mode("int4", ber=ber)
    pol_t = tp.policy_for_mode("int4", ber=ber)
    jenc, jsc, _ = jp.encode_kv(jnp.asarray(x), pol_j, None)
    tenc, tsc, _ = tp.encode_kv(torch.from_numpy(x), pol_t)
    same(jenc, tenc)
    key = jax.random.fold_in(jax.random.key(3), 0x52454144)
    want = jp.decode_kv(jenc, jsc, pol_j, head_dim=16, read_key=key)
    mask = torch.from_numpy(np.asarray(flip_mask_for(key, jenc.shape, ber, 4)).astype(np.int32))
    got = tp.decode_kv(tenc, tsc, pol_t, head_dim=16, read_mask=mask)
    assert len(got) == 4
    same(want[0], got[0])
    for w, g in zip(want[1:], got[1:]):
        assert g.dtype == torch.int32 and int(w) == int(g)
    assert int(got[3]) > 0
    clean = tp.decode_kv(tenc, tsc, tp.policy_for_mode("int4-write-inject", ber=ber),
                         head_dim=16, read_mask=mask)
    assert len(clean) == 4 and int(clean[3]) == 0
    same(jp.decode_kv(jenc, jsc, pol_j, head_dim=16)[0], clean[0])


def test_policy_defaults_match_jax():
    """F3: the default codec is JAX's "fp16", and its write stores JAX's
    bfloat16 bits; with_seed; decode_kv's counts are int32."""
    assert tp.KVCachePolicy() == tp.KVCachePolicy(codec="fp16")
    assert tp.KVCachePolicy().codec == jp.KVCachePolicy().codec == "fp16"
    for f in ("ber", "inject_errors", "seed", "use_interpolation", "inject_at", "scrub"):
        assert getattr(tp.KVCachePolicy(), f) == getattr(jp.KVCachePolicy(), f), f
    _, x = inputs(8)
    enc, scale, _ = tp.encode_kv(torch.from_numpy(x), tp.KVCachePolicy())
    want = jp.encode_kv(jnp.asarray(x), jp.KVCachePolicy(), None)[0]
    assert enc.dtype == torch.bfloat16 and scale is None
    same(np.asarray(want).view(np.uint16), enc.view(torch.int16).view(torch.uint16))
    pol = tp.policy_for_mode("int12-golay", ber=1e-2, seed=3)
    assert pol.with_seed(9) == tp.policy_for_mode("int12-golay", ber=1e-2, seed=9)
    assert pol.with_seed(9).seed == jp.policy_for_mode("int12-golay", seed=3).with_seed(9).seed
    enc = torch.zeros((2, 4), dtype=torch.int32)
    for codec in CODECS:
        p = tp.policy_for_mode(MODES[codec])
        e = ts.encode_codewords(codec, enc, 8)
        _, corr, det = tp.decode_kv(e, torch.ones(2), p, head_dim=8)
        assert corr.dtype == det.dtype == torch.int32, codec


def test_flip_mask_rate_and_determinism():
    g = torch.Generator().manual_seed(11)
    m = flip_mask((200_000,), 1e-2, 24, g)
    assert m.dtype == torch.int32 and int(m.max()) < (1 << 24)
    rate = float(ts.C.popcount(m).sum()) / (200_000 * 24)
    assert abs(rate - 1e-2) < 0.03 * 1e-2
    again = flip_mask((200_000,), 1e-2, 24, torch.Generator().manual_seed(11))
    assert torch.equal(m, again)


@pytest.mark.parametrize("seq_axis", [1, 0])
def test_decode_kv_interpolation(seq_axis):
    """hamming84 with interpolation: the unscrubbed codewords of a 33-token
    sequence at BER 8e-2 (doubles at about 1 value in 8), decoded,
    interpolated along the sequence axis and dequantized, bit for bit."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 33, 3, 16)).astype(np.float32)
    pol_j = jp.policy_for_mode("int4-hamming84-interp", ber=8e-2)
    pol_t = tp.policy_for_mode("int4-hamming84-interp", ber=8e-2)
    mask = numpy_mask(rng, mask_shape("hamming84", x), 8e-2, 8)
    jenc, jsc, _ = jp.encode_kv(jnp.asarray(x), pol_j, None, mask=jnp.asarray(mask))
    tenc, tsc, _ = tp.encode_kv(torch.from_numpy(x), pol_t, mask=torch.from_numpy(mask))
    same(jenc, tenc)
    jx, jcorr, jdet = jp.decode_kv(jenc, jsc, pol_j, head_dim=16, seq_axis=seq_axis)
    tx, tcorr, tdet = tp.decode_kv(tenc, tsc, pol_t, head_dim=16, seq_axis=seq_axis)
    same(jx, tx)
    assert (int(jcorr), int(jdet)) == (int(tcorr), int(tdet))
    assert int(tdet) > 50  # doubles were there to interpolate
    plain = tp.decode_kv(tenc, tsc, tp.policy_for_mode("int4-hamming84", ber=8e-2),
                         head_dim=16)[0]
    assert not torch.equal(plain, tx)


@pytest.mark.parametrize("codec", ["int4", "hamming74", "hamming84"])
def test_hoisted_logical_masks(codec):
    """The unscrubbed write path's hoist: raw masks of every layer in one
    draw, uint8, which encode_kv XORs as the explicit mask it is."""
    pol = tp.policy_for_mode(MODES[codec], ber=5e-2)
    shape = (2, 1, 3, ts.padded_values(codec, 16))
    m = tp.hoisted_logical_masks(pol, 4, shape, generator=torch.Generator().manual_seed(1))
    assert m.dtype == torch.uint8 and m.shape == (4, 2) + shape
    assert int(m.max()) < (1 << tp.N_BITS[codec]) and int(m.max()) > 0
    again = tp.hoisted_logical_masks(pol, 4, shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(m, again)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 1, 3, 16)).astype(np.float32))
    enc, _, flips = tp.encode_kv(x, pol, mask=m[2, 1])
    clean, _, _ = tp.encode_kv(x, tp.policy_for_mode(MODES[codec]))
    assert torch.equal(enc ^ clean, m[2, 1].to(torch.int32))
    assert int(flips) == int(ts.C.popcount(m[2, 1].to(torch.int32)).sum())
    golay = tp.hoisted_logical_masks(tp.policy_for_mode("int12-golay", ber=5e-2), 1,
                                     (2, 1, 3, 8), generator=torch.Generator().manual_seed(2))
    assert golay.dtype == torch.int32 and int(golay.max()) >= 256 and int(golay.max()) < 1 << 24


def float_bits(a):
    """bfloat16 / e4m3 values (JAX or torch) as their unsigned bits."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16
                else a.view(torch.uint8).numpy())
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}")


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
@pytest.mark.parametrize("ber", [0.0, 1e-2])
def test_float_write_chain(mode, ber):
    """encode_kv, encode_kv_scrubbed, encode_pack_kv_scrubbed, pack_kv and
    decode_kv of the float codecs against JAX's, with one numpy-made mask
    (8 bits a byte) for fp8's bytes: stored bits, flip counts and decoded
    values equal; no scales; fp16 is never injected. Inputs include values
    past fp8's range (NaN there, F7)."""
    rng, x = inputs(16, seed=5)
    x[0, 1, 0, :4] = [500.0, -1e4, np.inf, -np.inf]
    jpol, tpol = jp.policy_for_mode(mode, ber=ber), tp.policy_for_mode(mode, ber=ber)
    mask = numpy_mask(rng, x.shape, 5e-2, 8).astype(np.uint8)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    jenc, jsc, jfl = jp.encode_kv(jx, jpol, None, mask=jm)
    tenc, tsc, tfl = tp.encode_kv(tx, tpol, mask=tm)
    np.testing.assert_array_equal(float_bits(jenc), float_bits(tenc))
    assert jsc is None and tsc is None and int(jfl) == int(tfl) and tfl.dtype == torch.int32
    assert (int(tfl) > 0) == (mode == "fp8" and ber > 0)
    assert tp.write_inject(tpol) == (mode == "fp8" and ber > 0)
    for fn in ("encode_kv_scrubbed", "encode_pack_kv_scrubbed"):
        jw, jws = getattr(jp, fn)(jx, jpol, None, mask=jm)
        tw, tws = getattr(tp, fn)(tx, tpol, mask=tm)
        np.testing.assert_array_equal(float_bits(jw), float_bits(tw), err_msg=fn)
        assert jws is None and tws is None
    assert tp.pack_kv(tenc, tpol, 16) is tenc
    jdec = jp.decode_kv(jenc, None, jpol, head_dim=16)
    tdec = tp.decode_kv(tenc, None, tpol, head_dim=16)
    np.testing.assert_array_equal(np.asarray(jdec[0]), tdec[0].numpy())
    assert all(int(c) == 0 and c.dtype == torch.int32 for c in tdec[1:])
