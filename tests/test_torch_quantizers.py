"""The port's INT4 quantizer backends and fused codec chains
(qkv_ecc_tpu_torch.codecs.quantizers, .fused) against the JAX package's on
the same numpy-made inputs.

Tolerances: none. Codes, scales and zero points are equal bit for bit (the
same float32 operations, rounded half to even in both), and so are the
dequantized values and the decoded counts.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs import fused as jf  # noqa: E402
from qkv_ecc_tpu.codecs import quantizers as jq  # noqa: E402
from qkv_ecc_tpu_torch import codecs as tcodecs  # noqa: E402
from qkv_ecc_tpu_torch.codecs import fused as tf  # noqa: E402
from qkv_ecc_tpu_torch.codecs import quantizers as tq  # noqa: E402

torch.set_num_threads(1)
BACKENDS = list(jq.QUANTIZER_BACKENDS)
MODES = ["key", "value", "generic"]
# two shapes throughout (JAX compiles each operation once per shape): a last
# dimension that pads to the default group of 32 and one that does not
PADS, FITS = (2, 6, 40), (2, 6, 64)


def data(shape, seed=0, scale=3.0):
    """float32 normals with a zero row and an outlier channel."""
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    rows = x.reshape(-1, shape[-1])
    if rows.shape[0] > 1:
        rows[1] = 0.0
    x[..., 2] *= 9.0
    return x


def equal(j, t):
    """A JAX array (or None) equal to a torch tensor, dtype and bits."""
    if j is None or t is None:
        return j is None and t is None
    j = np.asarray(j)
    return j.dtype == t.numpy().dtype and np.array_equal(j, t.numpy())


def same_quantized(jqt, tqt):
    assert equal(jqt.data, tqt.data)
    assert equal(jqt.scales, tqt.scales)
    assert equal(jqt.zero_points, tqt.zero_points)
    assert tuple(jqt.original_shape) == tuple(tqt.original_shape)
    assert jqt.mode.value == tqt.mode.value
    assert jqt.metadata == tqt.metadata


@pytest.mark.parametrize("shape", [PADS, FITS])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_jax(backend, mode, shape):
    """quantize and dequantize of every backend in every mode."""
    x = data(shape)
    jqz = jq.get_quantizer(backend, jq.QuantizationConfig(group_size=None))
    tqz = tq.get_quantizer(backend, tq.QuantizationConfig(group_size=None))
    assert tqz.name == jqz.name
    jqt = jqz.quantize(jnp.asarray(x), jq.QuantizationMode(mode))
    tqt = tqz.quantize(torch.from_numpy(x), tq.QuantizationMode(mode))
    same_quantized(jqt, tqt)
    assert equal(jqz.dequantize(jqt), tqz.dequantize(tqt))


@pytest.mark.parametrize("backend,config", [
    ("block_absmax", dict(block_size=16)), ("group_wise", dict(group_size=48)),
    ("kivi", dict(group_size=16, bits=2)), ("kivi", dict(bits=8)),
])
def test_backend_config_matches_jax(backend, config):
    """Non-default block and group sizes and bit widths."""
    x = data(PADS, seed=1)
    jqz = jq.get_quantizer(backend, jq.QuantizationConfig(**config))
    tqz = tq.get_quantizer(backend, tq.QuantizationConfig(**config))
    for mode in MODES:
        jqt = jqz.quantize(jnp.asarray(x), jq.QuantizationMode(mode))
        tqt = tqz.quantize(torch.from_numpy(x), tq.QuantizationMode(mode))
        same_quantized(jqt, tqt)
        assert equal(jqz.dequantize(jqt), tqz.dequantize(tqt))


@pytest.mark.parametrize("backend", ["kivi", "kivi_symmetric", "per_token", "block_absmax"])
def test_kv_cache_helpers_match_jax(backend):
    """quantize_kv_cache / dequantize_kv_cache (keys per channel, values per
    token) and the KIVI classes' quantize_kv / dequantize_kv."""
    k, v = data(FITS, seed=2), data(FITS, seed=3)
    jk, jv, jqz = jq.quantize_kv_cache(jnp.asarray(k), jnp.asarray(v), backend)
    tk, tv, tqz = tq.quantize_kv_cache(torch.from_numpy(k), torch.from_numpy(v), backend)
    same_quantized(jk, tk)
    same_quantized(jv, tv)
    for a, b in zip(jq.dequantize_kv_cache(jk, jv, jqz), tq.dequantize_kv_cache(tk, tv, tqz)):
        assert equal(a, b)
    if hasattr(jqz, "quantize_kv"):
        ja, jb = jqz.quantize_kv(jnp.asarray(k), jnp.asarray(v))
        ta, tb = tqz.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
        same_quantized(ja, ta)
        same_quantized(jb, tb)
        for a, b in zip(jqz.dequantize_kv(ja, jb), tqz.dequantize_kv(ta, tb)):
            assert equal(a, b)


def test_unknown_backend_message_matches_jax():
    msgs = []
    for module in (jq, tq):
        with pytest.raises(ValueError) as err:
            module.get_quantizer("nf4")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert list(tq.QUANTIZER_BACKENDS) == list(jq.QUANTIZER_BACKENDS)


@pytest.mark.parametrize("cls", ["INT4Quantizer", "INT4QuantizerSimple"])
@pytest.mark.parametrize("backend", ["block_absmax", "group_wise", "per_token"])
def test_int4_facade_matches_jax(cls, backend):
    """quantize_full / dequantize_full through the registry, and the ECC
    write path's quantize_kv / dequantize_kv (zero rows scale 1.0)."""
    x = data(FITS, seed=4)
    jqz, tqz = getattr(jq, cls)(32, backend), getattr(tq, cls)(32, backend)
    jd, js = jqz.quantize_full(jnp.asarray(x))
    td, ts = tqz.quantize_full(torch.from_numpy(x))
    assert equal(jd, td) and equal(js, ts)
    assert equal(jqz.dequantize_full(jd, js), tqz.dequantize_full(td, ts))
    jd, js = jqz.quantize_kv(jnp.asarray(x))
    td, ts = tqz.quantize_kv(torch.from_numpy(x))
    assert equal(jd, td) and equal(js, ts)
    assert float(ts.reshape(-1)[1]) == 1.0  # the zero row
    assert equal(jqz.dequantize_kv(jd, js), tqz.dequantize_kv(td, ts))


@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_compute_quantization_scales_matches_jax(axis):
    x = data(FITS, seed=5)
    assert equal(jq.compute_quantization_scales(jnp.asarray(x), axis=axis),
                 tq.compute_quantization_scales(torch.from_numpy(x), axis=axis))


def flips(shape, n_bits, weight, seed):
    """A mask with `weight` distinct flipped bits per element (0: none)."""
    rng = np.random.default_rng(seed)
    m = np.zeros(shape, np.uint8)
    if weight:
        bits = np.argsort(rng.random(shape + (n_bits,)), axis=-1)[..., :weight]
        m = np.bitwise_or.reduce((1 << bits).astype(np.uint8), axis=-1)
    return m


@pytest.mark.parametrize("weight", [0, 1, 2])
@pytest.mark.parametrize("code", ["hamming84", "hamming74"])
def test_fused_chains_match_jax(code, weight):
    """fused_quantize_encode_* (codewords, scales) and
    fused_decode_dequantize_* on the codewords with `weight` flipped bits
    each: values and counts equal (hamming84 zeroes its double errors in
    both, hamming74 miscorrects them in both)."""
    x = data(FITS, seed=6)
    jcw, jsc = getattr(jf, f"fused_quantize_encode_{code}")(jnp.asarray(x))
    tcw, tsc = getattr(tf, f"fused_quantize_encode_{code}")(torch.from_numpy(x))
    assert equal(jcw, tcw) and equal(jsc, tsc)
    m = flips(tuple(tcw.shape), 8 if code == "hamming84" else 7, weight, seed=weight)
    jx, jcounts = getattr(jf, f"fused_decode_dequantize_{code}")(
        jcw ^ jnp.asarray(m), jsc)
    tx, tcounts = getattr(tf, f"fused_decode_dequantize_{code}")(
        tcw ^ torch.from_numpy(m), tsc)
    assert equal(jx, tx)
    assert [int(c) for c in jcounts] == [int(c) for c in tcounts]
    if weight:  # singles corrected; hamming84's doubles detected
        assert int(tcounts[1 if weight == 2 and code == "hamming84" else 0]) > 0


def test_exports_match_jax():
    """The codecs package exports the JAX package's quantizer and fused
    names."""
    from qkv_ecc_tpu import codecs as jcodecs

    assert set(jcodecs.__all__) - {"flip_mask"} <= set(tcodecs.__all__)
