"""The port's ECC engine (qkv_ecc_tpu_torch.cache.engine) against the JAX
package's, at the JAX tests' size (2 layers, 4/2 heads, head_dim 32, block
16, 32 blocks), in all six codecs and hamming84 with interpolation.

Both engines get the same inputs and the same noise: the write masks JAX
draws from its keys (ECCEngine._injection_key) and the read flips and seed
of the read-inject arm (its "READ" key), fed to the port's
``write(masks=)`` and ``attend(read_masks=, read_inject_seed=)``.

Stored words, values and scales must be equal, and so must every statistic:
fp16 stores bfloat16 and fp8 e4m3 in both packages, bit for bit. Outputs:
  * prefill (S = 24, causal) and the float codecs' decode queries take the
    general path on both sides, float32 attention over the same decoded
    values: within 1e-5 (summation order);
  * a packed-int decode query (S = 1) reads through K4 on both sides, the
    Pallas kernel in interpret mode and the port's plain version, which
    round q and p * v_scale to bf16 alike: within 2^-8 of the largest
    dequantized |V| (one bf16 ulp of one weight, as
    tests/test_torch_paged_attention.py states).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.cache import engine as je  # noqa: E402
from qkv_ecc_tpu.cache import unprotected as ju  # noqa: E402
from qkv_ecc_tpu.codecs.fault_injection import flip_mask_for  # noqa: E402
from qkv_ecc_tpu_torch.cache import engine as te  # noqa: E402
from qkv_ecc_tpu_torch.cache import unprotected as tu  # noqa: E402
from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc  # noqa: E402

torch.set_num_threads(1)
S, H, HQ, D = 24, 2, 4, 32
READ = 0x52454144


def engines(codec, ber=0.0, interp=False, seed=42, unprotected=False):
    kw = dict(ber=ber, inject_errors=ber > 0, seed=seed, num_blocks=32, block_size=16)
    dims = (2, HQ, H, D)
    if unprotected:
        return (ju.UnprotectedBackend(ju.UnprotectedEngineConfig(**kw), *dims),
                tu.UnprotectedBackend(tu.UnprotectedEngineConfig(**kw), *dims, device="cpu"))
    kw.update(codec=codec, use_interpolation=interp)
    return (je.ECCEngine(je.ECCEngineConfig(**kw), *dims),
            te.ECCEngine(te.ECCEngineConfig(**kw), *dims, device="cpu"))


def jax_write_masks(jeng, teng, layer, n):
    """The (K, V) masks JAX's next write of n tokens draws, as numpy."""
    codec = jeng.config.codec
    kk, vk = jax.random.split(jeng._injection_key(layer))
    n_bits = je.CODEC_N_BITS[codec]
    shape = teng.mask_shape(n)
    masks = [np.asarray(flip_mask_for(k, shape, jeng.config.ber, n_bits)) for k in (kk, vk)]
    return [m.astype(np.uint8) if codec == "fp8" else m.astype(np.int32) for m in masks]


def write_both(jeng, teng, k, v, layer, start):
    masks = jax_write_masks(jeng, teng, layer, k.shape[0]) if teng._inject() else None
    jeng.write(jnp.asarray(k), jnp.asarray(v), layer, start_pos=start)
    teng.write(torch.from_numpy(k), torch.from_numpy(v), layer, start_pos=start,
               masks=None if masks is None else [torch.from_numpy(m) for m in masks])


def bits(a):
    """The stored bits of a JAX or torch array, as numpy: bfloat16 and
    float8_e4m3fn as unsigned ints of their width."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return (a.view(torch.uint8) if a.dtype == torch.float8_e4m3fn else a).numpy()
    a = np.asarray(a)
    return a.view(f"u{a.itemsize}") if a.dtype.name in ("bfloat16", "float8_e4m3fn") else a


def same_cache(jeng, teng):
    for n, arr in teng.cache.items():
        np.testing.assert_array_equal(bits(jeng.cache[n]), bits(arr), err_msg=n)


GENERAL = dict(rtol=1e-5, atol=1e-5)  # float32 attention over equal values


def close(teng, decode):
    """assert_allclose's bounds for a query (module docstring)."""
    if not decode or teng.config.codec in ("fp16", "fp8"):
        return GENERAL
    return dict(rtol=0, atol=2.0 ** -8 * 8.0 * float(teng.cache["v_scales"].abs().max()))


CASES = [(c, ber) for c in ("fp16", "fp8", "int4", "hamming74", "hamming84", "golay")
         for ber in (0.0, 1e-2)] + [("hamming84-interp", 0.0), ("hamming84-interp", 5e-2)]


@pytest.mark.parametrize("codec,ber", CASES)
def test_engine_matches_jax(codec, ber):
    """A 24-token prefill written to both layers and attended causally,
    then three decode tokens written to both layers and one decode query per
    layer: stored bits equal after every write, outputs within the module
    docstring's bounds, every statistic equal."""
    interp = codec.endswith("-interp")
    jeng, teng = engines(codec.removesuffix("-interp"), ber, interp)
    rng = np.random.default_rng(CASES.index((codec, ber)))
    T = S + 3
    k_all = rng.normal(size=(T, H, D)).astype(np.float32)
    v_all = rng.normal(size=(T, H, D)).astype(np.float32)
    for layer in range(2):
        write_both(jeng, teng, k_all[:S], v_all[:S], layer, 0)
    same_cache(jeng, teng)
    q = rng.normal(size=(HQ, S, D)).astype(np.float32)
    want = np.asarray(jeng.attend(jnp.asarray(q), 0))
    got = teng.attend(torch.from_numpy(q), 0)
    assert got.shape == (HQ, S, D)
    np.testing.assert_allclose(got.numpy(), want, **close(teng, False))
    for t in range(S, T):
        for layer in range(2):
            write_both(jeng, teng, k_all[t:t + 1], v_all[t:t + 1], layer, t)
    same_cache(jeng, teng)
    for layer in range(2):
        q1 = rng.normal(size=(1, HQ, 1, D)).astype(np.float32)
        want = np.asarray(jeng.attend(jnp.asarray(q1), layer))
        got = teng.attend(torch.from_numpy(q1), layer)
        assert got.shape == (1, HQ, 1, D)
        np.testing.assert_allclose(got.numpy(), want, **close(teng, True))
    assert teng.stats == jeng.stats
    if ber and codec != "fp16":
        assert teng.stats["bits_flipped"] > 0
        if codec not in ("int4", "fp8"):
            assert teng.stats["errors_corrected"] > 0


SPECIAL = [500.0, -500.0, 1e4, -1e4, np.inf, -np.inf, np.nan, 464.0, -464.0, 465.0, 448.0,
           2.0 ** -10, 0.0, -0.0]


@pytest.mark.parametrize("codec", ["fp16", "fp8"])
def test_float_write_rounds_as_jax(codec):
    """F6 and F7: one write of the float codecs stores JAX's bits. fp16 is
    bfloat16 (the port stored float16 before), also for NaN; fp8 past
    +-464 and at +-inf is NaN, 0x7f / 0xff (torch's own conversion
    saturates to 0x7e / 0xfe). The values: SPECIAL, then normals at scales
    1e-3 to 1e3."""
    jeng, teng = engines(codec)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(S, H, D)) * 10.0 ** rng.integers(-3, 4, (S, H, 1))
    x = x.astype(np.float32)
    x.reshape(-1)[:len(SPECIAL)] = SPECIAL
    write_both(jeng, teng, x, -x, 0, 0)
    same_cache(jeng, teng)
    page = int(teng.manager.block_table()[0, 0])
    stored = bits(teng.cache["k_cache"])[0, page, 0, :11, 0]  # token 0, head 0: SPECIAL
    want = ([0x7F, 0xFF] * 3 + [0x7F, 0x7E, 0xFE, 0x7F, 0x7E] if codec == "fp8" else
            [0x43FA, 0xC3FA, 0x461C, 0xC61C, 0x7F80, 0xFF80, 0x7FC0, 0x43E8, 0xC3E8, 0x43E8,
             0x43E0])
    assert stored.tolist() == want


def test_unprotected_matches_jax():
    """The read-inject arm with JAX's read flips (a causal prefill read, the
    general path) and read seeds (two decode reads through K4): outputs
    within the module docstring's bounds, every statistic equal, the cache
    clean; get_unprotected_stats as JAX's."""
    jeng, teng = engines("int4", 1e-2, unprotected=True)
    assert teng.config.codec == "int4" and teng.config.inject_at == "read"
    rng = np.random.default_rng(7)
    k = rng.normal(size=(S, H, D)).astype(np.float32)
    v = rng.normal(size=(S, H, D)).astype(np.float32)
    write_both(jeng, teng, k, v, 0, 0)
    same_cache(jeng, teng)

    def read_key(layer):
        key = jax.random.fold_in(jax.random.key(jeng.config.seed ^ READ), jeng._read_count + 1)
        return jax.random.fold_in(key, layer)

    q = rng.normal(size=(HQ, S, D)).astype(np.float32)
    kk, vk = jax.random.split(read_key(0))
    masks = [torch.from_numpy(np.asarray(flip_mask_for(x, (S, H, D), 1e-2, 4)).astype(np.int32))
             for x in (kk, vk)]
    want = np.asarray(jeng.attend(jnp.asarray(q), 0))
    got = teng.attend(torch.from_numpy(q), 0, read_masks=masks)
    np.testing.assert_allclose(got.numpy(), want, **GENERAL)
    for _ in range(2):
        q1 = rng.normal(size=(HQ, 1, D)).astype(np.float32)
        seed = int(np.asarray(jax.random.bits(read_key(0), (), "uint32")).astype(np.int32))
        want = np.asarray(jeng.attend(jnp.asarray(q1), 0))
        got = teng.attend(torch.from_numpy(q1), 0, read_inject_seed=seed)
        np.testing.assert_allclose(got.numpy(), want, **close(teng, True))
    assert teng.stats == jeng.stats and teng.stats["bits_flipped"] > 0
    assert tu.get_unprotected_stats(teng) == ju.get_unprotected_stats(jeng)
    same_cache(jeng, teng)  # reads never touch the cache


def test_engine_own_draws():
    """Without fed noise the port draws from its generator: deterministic per
    seed (and again after reset_stats), another seed gives other flips; the
    write and read flip rates sit near the BER; K4 serves the decode reads
    (on the CPU through its plain version: no launch)."""
    rng = np.random.default_rng(8)
    k = torch.from_numpy(rng.normal(size=(S, H, D)).astype(np.float32))
    q1 = torch.from_numpy(rng.normal(size=(HQ, 1, D)).astype(np.float32))

    def run(seed, unprotected=False):
        _, eng = engines("golay", 2e-2, seed=seed, unprotected=unprotected)
        eng.write(k, k, 0)
        outs = [eng.attend(q1, 0) for _ in range(3)]
        return eng, outs, dict(eng.stats)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a[0].cache["k_parity"], b[0].cache["k_parity"]) and a[2] == b[2]
    assert not torch.equal(a[0].cache["k_parity"], c[0].cache["k_parity"])
    assert 0.5 < a[2]["actual_ber"] / 2e-2 < 1.5
    a[0].reset()  # the generator starts again (the freed blocks queue last)
    assert a[0].stats["bits_flipped"] == 0 and not a[0].cache["k_cache"].any()
    a[0].write(k, k, 0)
    assert torch.equal(a[0].attend(q1, 0), b[1][0]) and a[0].stats == b[2]
    r1, r2 = run(3, True), run(3, True)
    assert all(torch.equal(x, y) for x, y in zip(r1[1], r2[1])) and r1[2] == r2[2]
    assert not torch.equal(r1[1][0], r1[1][1])  # fresh flips at every read
    assert 0.5 < r1[2]["actual_ber"] / 2e-2 < 1.5
    assert paged_attention_ecc.launches == 0


def test_engine_checks_and_edges():
    """The JAX configuration's ValueErrors; an empty context reads zeros;
    the decode query's K4 read matches the general path (the interpolating
    engine, no doubles at BER 0) within 2e-2, as tests/test_engine.py:110."""
    for bad in (dict(codec="int3"), dict(inject_at="never"), dict(codec="hamming84",
                                                                   inject_at="read")):
        with pytest.raises(ValueError):
            je.ECCEngineConfig(**bad)
        with pytest.raises(ValueError):
            te.ECCEngineConfig(**bad)
    _, teng = engines("hamming84")
    assert not teng.attend(torch.ones((HQ, 1, D)), 0).any()
    rng = np.random.default_rng(9)
    k = torch.from_numpy(rng.normal(size=(S, H, D)).astype(np.float32))
    teng.write(k, k, 1)
    _, gen = engines("hamming84", interp=True)
    gen.write(k, k, 1)
    q1 = torch.from_numpy(rng.normal(size=(HQ, 1, D)).astype(np.float32))
    assert float((teng.attend(q1, 1) - gen.attend(q1, 1)).abs().max()) < 2e-2
