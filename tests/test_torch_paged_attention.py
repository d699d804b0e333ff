"""The port's fused write+attend (qkv_ecc_tpu_torch.kernels.paged_attention,
its plain PyTorch version on the CPU) against the JAX kernel
paged_attention_ecc_write_attend(scrub=True) in Pallas interpret mode, and
the port's reference attention against the JAX reference.

Stored words and scales must be equal. Outputs: both sides round q and
p * v_scale to bf16 and take the softmax online page by page, so they differ
only by float32 summation order and exp, except where such a difference
moves one p * v_scale across a bf16 rounding boundary: that changes one
weight by one bf16 ulp (2^-8 relative) and the output by at most 2^-8 of the
largest dequantized |V|, which is the tolerance.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.cache.layout import ECCCacheConfig  # noqa: E402
from qkv_ecc_tpu.cache.layout import allocate_ecc_kv_cache  # noqa: E402
from qkv_ecc_tpu.kernels import paged_attention as jpa  # noqa: E402
from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu.models import kv_policy as jp  # noqa: E402
from qkv_ecc_tpu.models.runtime import _write_tokens  # noqa: E402
from qkv_ecc_tpu_torch.cache import layout as tl  # noqa: E402
from qkv_ecc_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)
MODES = {"int4": "int4-write-inject", "golay": "int12-golay", "hamming74": "int4-hamming",
         "hamming84": "int4-hamming84"}
NAMES = ("k_cache", "v_cache", "k_scales", "v_scales")


def build_case(codec, head_dim, ctx_before, *, batch=4, hkv=2, group=2, bs=16,
               pages=4, layers=2, seed=0):
    """A cache whose every slot (also those past each context) holds a
    token written through the JAX write chain, a new token per sequence
    and a query - all as numpy."""
    rng = np.random.default_rng(seed)
    cfg = ECCCacheConfig(num_blocks=batch * pages, block_size=bs, num_layers=layers,
                         num_kv_heads=hkv, head_dim=head_dim, codec=codec)
    pol = jp.policy_for_mode(MODES[codec])
    state = allocate_ecc_kv_cache(cfg)
    bt = jnp.arange(batch * pages, dtype=jnp.int32).reshape(batch, pages)
    T = pages * bs
    pos = jnp.broadcast_to(jnp.arange(T), (batch, T))
    for layer in range(layers):
        k = rng.normal(size=(batch, T, hkv, head_dim)).astype(np.float32)
        v = rng.normal(size=(batch, T, hkv, head_dim)).astype(np.float32)
        kc, ks = jp.encode_pack_kv_scrubbed(jnp.asarray(k), pol, None)
        vc, vs = jp.encode_pack_kv_scrubbed(jnp.asarray(v), pol, None)
        state = _write_tokens(state, layer, bt, pos, kc, vc, ks, vs)
    dw = cfg.data_words
    kn, ksn = jp.encode_pack_kv_scrubbed(
        jnp.asarray(rng.normal(size=(batch, hkv, head_dim)).astype(np.float32)), pol, None)
    vn, vsn = jp.encode_pack_kv_scrubbed(
        jnp.asarray(rng.normal(size=(batch, hkv, head_dim)).astype(np.float32)), pol, None)
    case = dict(state, kn=kn[..., :dw], vn=vn[..., :dw], kp=kn[..., dw:], vp=vn[..., dw:],
                ksn=ksn, vsn=vsn, bt=bt, ctx=np.asarray(ctx_before, np.int32) + 1,
                q=rng.normal(size=(batch, hkv * group, head_dim)).astype(np.float32))
    return {n: np.array(a) for n, a in case.items()}


def run_jax(case, codec, layer, window):
    outs = jpa.paged_attention_ecc_write_attend(
        jnp.asarray(case["q"]), jnp.asarray(case["kn"]), jnp.asarray(case["vn"]),
        jnp.asarray(case["ksn"]), jnp.asarray(case["vsn"]),
        *(jnp.asarray(case[n]) for n in NAMES), jnp.asarray(case["bt"]),
        jnp.asarray(case["ctx"]), layer, scrub=True, codec=codec,
        block_size=case["k_cache"].shape[-1], sliding_window=window)
    return [np.asarray(o) for o in outs]


def run_torch(case, codec, layer, window):
    tt = {n: torch.from_numpy(case[n].copy()) for n in NAMES}
    out = tpa.paged_attention_ecc_write_attend(
        *(torch.from_numpy(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn")),
        *(tt[n] for n in NAMES), torch.from_numpy(case["bt"]),
        torch.from_numpy(case["ctx"]), layer, codec=codec, sliding_window=window)
    return [out.numpy()] + [tt[n].numpy() for n in NAMES]


def tolerance(case):
    return 2.0 ** -8 * 8.0 * float(np.abs(case["v_scales"]).max())


# ctx after the write: 1; 16 (new token ends page 0); 17 (it starts page 1); 41
CTX_BEFORE = [0, 15, 16, 40]


@pytest.mark.parametrize("codec", list(MODES))
@pytest.mark.parametrize("window", [None, 8])
def test_write_attend_matches_jax(codec, window):
    case = build_case(codec, 32, CTX_BEFORE, seed=1 if window else 0)
    want = run_jax(case, codec, 1, window)
    got = run_torch(case, codec, 1, window)
    for name, a, b in zip(NAMES, want[1:], got[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the write landed: layer 1 changed, layer 0 did not
    assert not np.array_equal(got[1][1], case["k_cache"][1])
    np.testing.assert_array_equal(got[1][0], case["k_cache"][0])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tolerance(case))


def test_write_attend_golay_head_dim_128_gqa4():
    case = build_case("golay", 128, [3, 31, 32, 60], hkv=2, group=4, bs=32, pages=2, seed=2)
    want = run_jax(case, "golay", 0, None)
    got = run_torch(case, "golay", 0, None)
    for name, a, b in zip(NAMES, want[1:], got[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tolerance(case))


def test_gather_and_reference_match_jax():
    case = build_case("golay", 32, CTX_BEFORE, seed=3)
    jt = {n: jnp.asarray(case[n]) for n in case}
    tt = {n: torch.from_numpy(case[n]) for n in case}
    np.testing.assert_array_equal(
        np.asarray(jpa.gather_pages(jt["k_cache"], jt["bt"], 1, 3, jt["k_parity"])),
        tpa.gather_pages(tt["k_cache"], tt["bt"], 1, 3, tt["k_parity"]).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpa.gather_scales(jt["v_scales"], jt["bt"], 1, 4)),
        tpa.gather_scales(tt["v_scales"], tt["bt"], 1, 4).numpy())
    args = ("q", "k_cache", "v_cache", "k_scales", "v_scales", "bt", "ctx")
    want = jpa.paged_attention_ecc_reference(
        *(jt[a] for a in args), 1, jt["k_parity"], jt["v_parity"], codec="golay",
        block_size=16)
    got = tpa.paged_attention_ecc_reference(
        *(tt[a] for a in args), 1, tt["k_parity"], tt["v_parity"], codec="golay")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_plain_is_close_to_reference():
    """The extract path on a scrubbed cache computes the decoded attention:
    within bf16 rounding of q and the weights of the float32 reference."""
    case = build_case("golay", 32, CTX_BEFORE, seed=4)
    got = run_torch(case, "golay", 1, None)
    tt = {n: torch.from_numpy(case[n]) for n in case}
    tt.update({n: torch.from_numpy(a) for n, a in zip(NAMES, got[1:])})
    tok = case["ctx"] - 1  # the new token's parity column, as the runtime scatters it
    for b in range(len(tok)):
        page, slot = case["bt"][b, tok[b] // 16], tok[b] % 16
        tt["k_parity"][1, page, :, :, slot] = tt["kp"][b]
        tt["v_parity"][1, page, :, :, slot] = tt["vp"][b]
    ref = tpa.paged_attention_ecc_reference(
        *(tt[a] for a in ("q", "k_cache", "v_cache", "k_scales", "v_scales", "bt", "ctx")),
        1, tt["k_parity"], tt["v_parity"], codec="golay")
    np.testing.assert_allclose(got[0], ref.numpy(), rtol=0, atol=2.0 ** -6 * np.abs(ref.numpy()).max())


def test_wrapper_checks():
    case = build_case("int4", 32, CTX_BEFORE)
    args = [torch.from_numpy(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn", *NAMES, "bt", "ctx")]
    # still to come: golay's correcting read (K2) and int4 read-time injection (K2r)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tpa.paged_attention_ecc_write_attend(*args, 0, codec="golay", scrub=False)
    with pytest.raises(NotImplementedError, match="K2r"):
        tpa.paged_attention_ecc_write_attend(*args, 0, codec="int4", read_inject_ber=1e-2)
    narrow = [a[:, :, :, :2] for a in args[5:7]]  # caches of 2 data words at head_dim 32
    with pytest.raises(ValueError, match="data words"):
        tpa.paged_attention_ecc_write_attend(*args[:5], *narrow, *args[7:], 0, codec="int4")
    assert tpa.paged_attention_ecc_write_attend.launches == 0  # the CPU never launches
    assert tpa.write_decode_attend.launches == 0


def test_port_cache_layout_matches():
    for codec in ("int4", "golay"):
        for hd in (16, 128):
            a = ECCCacheConfig(num_blocks=6, block_size=16, num_layers=2, num_kv_heads=2,
                               head_dim=hd, codec=codec)
            b = tl.ECCCacheConfig(num_blocks=6, block_size=16, num_layers=2, num_kv_heads=2,
                                  head_dim=hd, codec=codec)
            assert (a.cache_shape(), a.parity_shape(), a.scales_shape()) == (
                b.cache_shape(), b.parity_shape(), b.scales_shape())
            ja, ta = allocate_ecc_kv_cache(a), tl.allocate_ecc_kv_cache(b, device="cpu")
            assert set(ja) == set(ta)
            for n in ja:
                assert tuple(ja[n].shape) == tuple(ta[n].shape)
                assert str(ja[n].dtype) == str(ta[n].dtype).replace("torch.", "")


def test_write_attend_hamming74_pads():
    """hamming74 at head_dim 16 pads to 32 values (4 data words, where int4
    has 2): the read drops the 16 padding nibbles, which the injection may
    have flipped."""
    rng = np.random.default_rng(8)
    case = build_case("hamming74", 16, [0, 15, 16, 40], seed=8)
    assert case["k_cache"].shape[3] == 4
    # flip padding nibbles everywhere: the read must not see them
    for n in ("k_cache", "v_cache"):
        case[n] ^= rng.integers(0, 16, case[n].shape).astype(np.int32) << 4 & 0x70707070
    want = run_jax(case, "hamming74", 1, None)
    got = run_torch(case, "hamming74", 1, None)
    for name, a, b in zip(NAMES, want[1:], got[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tolerance(case))


# =============================================================================
# The hamming84 correcting read, with and without interpolation (decode_attend)
# =============================================================================

H84_BS, H84_CHUNK_PAGES = 16, 2
SEAM = H84_BS * H84_CHUNK_PAGES  # a chunk is 32 tokens: seams after 31, 63, 95
H84_CTX = [112, 100, 71]  # after the write; each spans at least three chunks
H84_NAMES = ("k_cache", "v_cache", "k_parity", "v_parity", "k_scales", "v_scales")


def forced_doubles(ctx):
    """Tokens with a forced double error: 0, each seam token and the token
    after it, ctx-2 and ctx-1."""
    toks = {0, ctx - 2, ctx - 1}
    for s in range(SEAM, ctx, SEAM):
        toks |= {s - 1, s}
    return sorted(t for t in toks if t < ctx)


def build_h84_case(head_dim=16, hkv=2, group=2, pages=7, layers=2, seed=0):
    """An unscrubbed hamming84 cache written through the JAX write chain:
    random codes, random single and double errors at about 3% of values,
    and a double in values 0-3 of every forced token (forced_doubles), K
    and V; the new token at ctx-1 is the new column, double included."""
    rng = np.random.default_rng(seed)
    batch, bs = len(H84_CTX), H84_BS
    cfg = ECCCacheConfig(num_blocks=batch * pages, block_size=bs, num_layers=layers,
                         num_kv_heads=hkv, head_dim=head_dim, codec="hamming84")
    pol = jp.policy_for_mode("int4-hamming84-interp")
    state = allocate_ecc_kv_cache(cfg)
    bt = jnp.arange(batch * pages, dtype=jnp.int32).reshape(batch, pages)
    T = pages * bs
    pos = jnp.broadcast_to(jnp.arange(T), (batch, T))

    def noisy(shape, forced_at):
        """Codewords of random values, with errors; forced_at[b] lists the
        positions of axis 1 that get a double in values 0-3."""
        x = rng.normal(size=shape).astype(np.float32)
        cw, sc, _ = jp.encode_kv(jnp.asarray(x), pol, None)
        cw = np.array(cw)
        two = (1 << rng.integers(0, 4, cw.shape)) | (16 << rng.integers(0, 4, cw.shape))
        one = 1 << rng.integers(0, 8, cw.shape)
        r = rng.random(cw.shape)
        cw ^= np.where(r < 0.015, two, np.where(r < 0.03, one, 0)).astype(np.int32)
        for b, toks in enumerate(forced_at):
            for t in toks:
                cw[b, t, :, :4] ^= np.int32(0b00010001)  # data bit 0 and parity bit 4
        return cw, np.asarray(sc)

    forced = [forced_doubles(c) for c in H84_CTX]
    for layer in range(layers):
        kc, ks = noisy((batch, T, hkv, head_dim), forced)
        vc, vs = noisy((batch, T, hkv, head_dim), forced)
        pack = lambda c: js.pack_codewords("hamming84", jnp.asarray(c), head_dim)  # noqa: E731
        state = _write_tokens(state, layer, bt, pos, pack(kc), pack(vc),
                              jnp.asarray(ks), jnp.asarray(vs))
    new_forced = [[0]] * batch
    kn, ksn = noisy((batch, 1, hkv, head_dim), new_forced)
    vn, vsn = noisy((batch, 1, hkv, head_dim), new_forced)
    case = dict(state, kn=np.asarray(pack(kn[:, 0])), vn=np.asarray(pack(vn[:, 0])), ksn=ksn[:, 0], vsn=vsn[:, 0], bt=bt,
                ctx=np.asarray(H84_CTX, np.int32),
                q=rng.normal(size=(batch, hkv * group, head_dim)).astype(np.float32))
    return {n: np.array(a) for n, a in case.items()}


def run_jax_h84(case, layer, interp):
    outs = jpa.paged_attention_ecc_write_attend(
        *(jnp.asarray(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn", "k_cache", "v_cache",
                                          "k_scales", "v_scales", "bt", "ctx")),
        layer, jnp.asarray(case["k_parity"]), jnp.asarray(case["v_parity"]), scrub=False,
        codec="hamming84", block_size=H84_BS, pages_per_chunk=H84_CHUNK_PAGES,
        use_interpolation=interp)
    out, kc, vc, kp, vp, ks, vs = (np.asarray(o) for o in outs)
    return out, dict(k_cache=kc, v_cache=vc, k_parity=kp, v_parity=vp, k_scales=ks, v_scales=vs)


def run_torch_h84(case, layer, interp, pages_per_chunk=H84_CHUNK_PAGES):
    tt = {n: torch.from_numpy(case[n].copy()) for n in H84_NAMES}
    out = tpa.paged_attention_ecc_write_attend(
        *(torch.from_numpy(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn")),
        tt["k_cache"], tt["v_cache"], tt["k_scales"], tt["v_scales"],
        torch.from_numpy(case["bt"]), torch.from_numpy(case["ctx"]), layer,
        tt["k_parity"], tt["v_parity"], codec="hamming84", scrub=False,
        use_interpolation=interp, pages_per_chunk=pages_per_chunk)
    return out.numpy(), {n: a.numpy() for n, a in tt.items()}


@pytest.mark.parametrize("interp", [True, False])
def test_write_decode_attend_matches_jax(interp):
    """write_decode_attend_plain against the JAX kernel in interpret mode,
    bs 16, pages_per_chunk 2, contexts of 71-112 tokens (three to four
    chunks), doubles forced at token 0, at every seam token and the token
    after it, at ctx-2 and at ctx-1 (the new column). Caches, parity and
    scales after the write are equal; outputs agree within 2^-8 of the
    largest dequantized |V| (the module docstring's bound)."""
    case = build_h84_case(seed=1 if interp else 2)
    want_out, want = run_jax_h84(case, 1, interp)
    got_out, got = run_torch_h84(case, 1, interp)
    for n in H84_NAMES:
        np.testing.assert_array_equal(want[n], got[n], err_msg=n)
    for n in ("k_cache", "k_parity"):  # the write landed in layer 1 only
        assert not np.array_equal(got[n][1], case[n][1])
        np.testing.assert_array_equal(got[n][0], case[n][0])
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=tolerance(case))


def test_interpolation_sees_the_seams():
    """The chunked interpolation differs from the unchunked oracle
    (interpolate_double_errors over the whole sequence) exactly at forced
    doubles on seam tokens, and the attention output moves with it: the
    test above holds the port to the seams, not to the oracle."""
    from qkv_ecc_tpu.codecs.interpolation import interpolate_double_errors

    case = build_h84_case(seed=1)
    bt, ctx = torch.from_numpy(case["bt"]), torch.from_numpy(case["ctx"])
    out_c, state = run_torch_h84(case, 1, True)
    rows = tpa.gather_pages(torch.from_numpy(state["k_cache"]), bt, 1, bt.shape[1],
                            torch.from_numpy(state["k_parity"]))
    nib, dbl = tpa.h84_decode_rows(rows, case["k_cache"].shape[3])
    chunked = tpa.interpolate_chunked(nib, dbl, ctx, SEAM)
    b0, c0 = 0, H84_CTX[0]
    et = np.where(dbl[b0, :c0].numpy(), 2, 0)
    oracle = np.asarray(interpolate_double_errors(
        jnp.asarray(nib[b0, :c0].numpy().astype(np.uint8)), jnp.asarray(et), seq_dim=0))
    diff = np.nonzero((chunked[b0, :c0].numpy() != oracle).any(axis=(1, 2)))[0]
    assert len(diff) > 0
    assert set(diff.tolist()) <= {s - 1 for s in range(SEAM, c0, SEAM)}
    # one chunk over the whole table is the oracle inside the context
    whole = tpa.interpolate_chunked(nib, dbl, ctx, 10 ** 6)
    np.testing.assert_array_equal(whole[b0, :c0].numpy(), oracle)
    out_whole, _ = run_torch_h84(case, 1, True, pages_per_chunk=bt.shape[1])
    assert not np.array_equal(out_c[b0], out_whole[b0])


def test_h84_reference_matches_jax():
    case = build_h84_case(seed=3)
    jt = {n: jnp.asarray(case[n]) for n in case}
    tt = {n: torch.from_numpy(case[n]) for n in case}
    args = ("q", "k_cache", "v_cache", "k_scales", "v_scales", "bt", "ctx")
    want = jpa.paged_attention_ecc_reference(
        *(jt[a] for a in args), 0, jt["k_parity"], jt["v_parity"], codec="hamming84",
        block_size=H84_BS)
    got = tpa.paged_attention_ecc_reference(
        *(tt[a] for a in args), 0, tt["k_parity"], tt["v_parity"], codec="hamming84")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
