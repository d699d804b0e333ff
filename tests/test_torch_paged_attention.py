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

import functools
import inspect
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
        torch.from_numpy(case["ctx"]), layer, scrub=True, codec=codec,
        block_size=case["k_cache"].shape[-1], sliding_window=window)
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
    """The JAX wrapper's refusals (``_check_scrub_flags``, ``_read_threshold``,
    the parity and width checks), all ValueError, and the port's data-word
    check; the CPU never launches a kernel."""
    case = build_case("int4", 32, CTX_BEFORE)
    args = [torch.from_numpy(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn", *NAMES, "bt", "ctx")]
    call = functools.partial(tpa.paged_attention_ecc_write_attend, *args, 0, block_size=16)
    with pytest.raises(ValueError, match="collect_stats"):
        call(codec="int4", scrub=True, collect_stats=True)
    with pytest.raises(ValueError, match="read-time injection"):
        call(codec="int4", scrub=True, read_inject_ber=1e-2)
    with pytest.raises(ValueError, match="interpolation"):
        call(codec="hamming84", scrub=True, use_interpolation=True)
    with pytest.raises(ValueError, match="only defined for the unprotected int4"):
        call(codec="golay", read_inject_ber=1e-2)
    with pytest.raises(ValueError, match="k_parity/v_parity"):
        call(codec="golay")  # the correcting read needs the parity arrays
    with pytest.raises(ValueError, match="block_size"):
        tpa.paged_attention_ecc_write_attend(*args, 0, codec="int4", scrub=True)
    narrow = [a[:, :, :, :2] for a in args[5:7]]  # caches of 2 data words at head_dim 32
    with pytest.raises(ValueError, match="data words"):
        tpa.paged_attention_ecc_write_attend(*args[:5], *narrow, *args[7:], 0, codec="int4",
                                             scrub=True, block_size=16)
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


def run_jax_read(case, codec, layer, **kw):
    """The JAX kernel's unscrubbed read in interpret mode: (output, or
    (output, stats), and the arrays after the write)."""
    kw.setdefault("pages_per_chunk", H84_CHUNK_PAGES)
    parity = "k_parity" in case
    outs = jpa.paged_attention_ecc_write_attend(
        *(jnp.asarray(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn", "k_cache", "v_cache",
                                          "k_scales", "v_scales", "bt", "ctx")),
        layer, *((jnp.asarray(case["k_parity"]), jnp.asarray(case["v_parity"])) if parity else ()),
        scrub=False, codec=codec, block_size=case["k_cache"].shape[-1], **kw)
    outs = [np.asarray(o) for o in outs]
    names = H84_NAMES if parity else NAMES
    state = dict(zip(("k_cache", "v_cache") + (("k_parity", "v_parity") if parity else ())
                     + ("k_scales", "v_scales"), outs[1:1 + len(names)]))
    out = (outs[0], outs[-1]) if kw.get("collect_stats") else outs[0]
    return out, state


def run_torch_read(case, codec, layer, **kw):
    """The port's unscrubbed read on copies of the case's arrays."""
    kw.setdefault("pages_per_chunk", H84_CHUNK_PAGES)
    parity = "k_parity" in case
    tt = {n: torch.from_numpy(case[n].copy()) for n in (H84_NAMES if parity else NAMES)}
    out = tpa.paged_attention_ecc_write_attend(
        *(torch.from_numpy(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn")),
        tt["k_cache"], tt["v_cache"], tt["k_scales"], tt["v_scales"],
        torch.from_numpy(case["bt"]), torch.from_numpy(case["ctx"]), layer,
        *((tt["k_parity"], tt["v_parity"]) if parity else ()), codec=codec, scrub=False,
        block_size=case["k_cache"].shape[-1], **kw)
    out = tuple(o.numpy() for o in out) if kw.get("collect_stats") else out.numpy()
    return out, {n: a.numpy() for n, a in tt.items()}


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("interp", [True, False])
def test_write_decode_attend_matches_jax(interp, stats):
    """write_decode_attend_plain against the JAX kernel in interpret mode,
    bs 16, pages_per_chunk 2, contexts of 71-112 tokens (three to four
    chunks), doubles forced at token 0, at every seam token and the token
    after it, at ctx-2 and at ctx-1 (the new column). Caches, parity and
    scales after the write are equal, and so are the singles and doubles
    counted with ``collect_stats`` (exactly); outputs agree within 2^-8 of
    the largest dequantized |V| (the module docstring's bound)."""
    case = build_h84_case(seed=1 if interp else 2)
    kw = dict(use_interpolation=interp, collect_stats=stats)
    want_out, want = run_jax_read(case, "hamming84", 1, **kw)
    got_out, got = run_torch_read(case, "hamming84", 1, **kw)
    if stats:
        (want_out, want_stats), (got_out, got_stats) = want_out, got_out
        np.testing.assert_array_equal(want_stats, got_stats)
        assert (got_stats > 0).all()  # singles and doubles in every sequence
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
    out_c, state = run_torch_read(case, "hamming84", 1, use_interpolation=True)
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
    out_whole, _ = run_torch_read(case, "hamming84", 1, use_interpolation=True,
                                  pages_per_chunk=bt.shape[1])
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


# =============================================================================
# The hamming74, golay and int4 correcting reads with statistics (K2), int4
# read-time injection (K2r), and the repairs of F1 and F2
# =============================================================================

ECC_CTX = [112, 71, 33, 1]  # after the write: 1 to 4 chunks of 32 tokens


def _errors(rng, codec, cw):
    """XOR masks over logical codewords: golay gets 1-3 bit errors (2.5% of
    codewords each) and 4-bit errors (2.5%, uncorrectable), every bit chosen
    at random among the 24; hamming74 a single error in 10% of values, in
    any of the 7 bits (so in every parity plane); int4 none."""
    if codec == "golay":
        weight = np.searchsorted([0.9, 0.925, 0.95, 0.975], rng.random(cw.shape), side="right")
        ranks = rng.random(cw.shape + (24,)).argsort(-1).argsort(-1)
        return ((ranks < weight[..., None]) << np.arange(24)).sum(-1).astype(np.int32)
    if codec == "hamming74":
        return np.where(rng.random(cw.shape) < 0.1, 1 << rng.integers(0, 7, cw.shape),
                        0).astype(np.int32)
    return np.zeros_like(cw)


def build_ecc_case(codec, *, head_dim=16, hkv=2, group=2, pages=8, layers=2, seed=0,
                   ctx=ECC_CTX):
    """An unscrubbed cache of ``codec`` written through the JAX write chain
    with the errors of ``_errors`` in every slot, new full rows (data ++
    parity, errors included), a query - all as numpy. bs 16."""
    rng = np.random.default_rng(seed)
    batch, bs = len(ctx), H84_BS
    cfg = ECCCacheConfig(num_blocks=batch * pages, block_size=bs, num_layers=layers,
                         num_kv_heads=hkv, head_dim=head_dim, codec=codec)
    pol = jp.policy_for_mode(MODES[codec])
    state = allocate_ecc_kv_cache(cfg)
    bt = jnp.arange(batch * pages, dtype=jnp.int32).reshape(batch, pages)
    T = pages * bs
    pos = jnp.broadcast_to(jnp.arange(T), (batch, T))

    def rows(shape):
        cw, sc, _ = jp.encode_kv(jnp.asarray(rng.normal(size=shape).astype(np.float32)), pol, None)
        cw = np.asarray(cw) ^ _errors(rng, codec, np.asarray(cw))
        return js.pack_codewords(codec, jnp.asarray(cw), head_dim), np.asarray(sc)

    for layer in range(layers):
        kc, ks = rows((batch, T, hkv, head_dim))
        vc, vs = rows((batch, T, hkv, head_dim))
        state = _write_tokens(state, layer, bt, pos, kc, vc, jnp.asarray(ks), jnp.asarray(vs))
    kn, ksn = rows((batch, hkv, head_dim))
    vn, vsn = rows((batch, hkv, head_dim))
    case = dict(state, kn=kn, vn=vn, ksn=ksn, vsn=vsn, bt=bt, ctx=np.asarray(ctx, np.int32),
                q=rng.normal(size=(batch, hkv * group, head_dim)).astype(np.float32))
    return {n: np.array(a) for n, a in case.items()}


def assert_reads_agree(case, want, got):
    """Arrays after the write equal; stats (when returned) equal exactly;
    outputs within ``tolerance`` (the module docstring's bound)."""
    (want_out, want_state), (got_out, got_state) = want, got
    for n in want_state:
        np.testing.assert_array_equal(want_state[n], got_state[n], err_msg=n)
    if isinstance(want_out, tuple):
        (want_out, want_stats), (got_out, got_stats) = want_out, got_out
        np.testing.assert_array_equal(want_stats, got_stats)
    np.testing.assert_allclose(got_out, want_out, rtol=0, atol=tolerance(case))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("codec", ["hamming74", "golay", "int4"])
def test_correcting_read_matches_jax(codec, stats):
    """The scrub=False read of hamming74 (single errors in data and in every
    parity plane), golay (1-3-bit errors and uncorrectable 4-bit ones) and
    int4 against the JAX kernel in interpret mode, bs 16, pages_per_chunk 2,
    contexts of 1-112 tokens: arrays after the write equal, the per-sequence
    (corrected, detected) counts equal exactly, outputs within tolerance()
    (2^-8 of the largest dequantized |V|: one bf16 ulp of one weight)."""
    case = build_ecc_case(codec, seed={"hamming74": 3, "golay": 4, "int4": 5}[codec])
    want = run_jax_read(case, codec, 1, collect_stats=stats)
    got = run_torch_read(case, codec, 1, collect_stats=stats)
    assert_reads_agree(case, want, got)
    if stats:
        counts = got[0][1]
        if codec == "int4":
            assert not counts.any()
        else:
            assert (counts[:3, 0] > 0).all()  # corrections in every multi-chunk sequence
            if codec == "golay":
                assert counts[:, 1].sum() > 0  # uncorrectable codewords were read


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("ber", [1e-2, 0.3])
def test_read_injection_matches_jax(ber, stats):
    """Mode int4's read: the raw words are XORed with the murmur hash flips
    of (layer, batch, chunk, page, head, K/V) at every call, the cache keeps
    its clean words. Against JAX in interpret mode: arrays after the write
    equal (changed only in the new column), flipped read bits equal exactly,
    outputs within tolerance(); another seed gives other outputs."""
    case = build_ecc_case("int4", seed=6)
    kw = dict(read_inject_ber=ber, read_inject_seed=-12345, collect_stats=stats)
    want = run_jax_read(case, "int4", 1, **kw)
    got = run_torch_read(case, "int4", 1, **kw)
    assert_reads_agree(case, want, got)
    clean = run_torch_read(case, "int4", 1, collect_stats=stats)
    for n in NAMES:  # the flips never reach the cache
        np.testing.assert_array_equal(got[1][n], clean[1][n], err_msg=n)
    changed = np.nonzero((got[1]["k_cache"] != case["k_cache"]).any(axis=(2, 3)))
    assert set(changed[0].tolist()) == {1}  # layer 1 only, one page per sequence
    other = run_torch_read(case, "int4", 1, **dict(kw, read_inject_seed=777))
    out, out_other = (got[0][0], other[0][0]) if stats else (got[0], other[0])
    assert not np.array_equal(out, out_other)
    if stats:
        flips = got[0][1][:, 0]
        bits = 2 * np.asarray(ECC_CTX) * 2 * case["k_cache"].shape[3] * 32
        assert (flips > 0).all() and got[0][1][:, 1].sum() == 0
        assert abs(flips.sum() / bits.sum() - ber) < 0.25 * ber


def test_read_flip_mask_is_the_kernels_tile():
    """One tile of read_flip_mask is swar.hash_flip_mask at the TPU
    kernel's uid: (layer 3, batch 4, 5 pages in chunks of 2, page 4 = chunk
    2 page 0, head 1, V)."""
    m = tpa.read_flip_mask(99, 1 << 30, 3, 4, 5, 2, 2, 2, 16)
    uid = ((((3 * 4 + 2) * 3 + 2) * 2 + 0) * 2 + 1) * 2 + 1
    tile = np.asarray(js.hash_flip_mask(jnp.int32(99), jnp.int32(uid * 2 * 16), (2, 16), 1 << 30))
    np.testing.assert_array_equal(m[1, 2, 64:80, 1].numpy(), tile.T)


@pytest.mark.parametrize("scrub", [True, False])
def test_negative_page_writes_page_zero(scrub):
    """F1: a row whose new token's page is -1 (ctx 1) writes its column to
    physical page 0, as the TPU kernel clamps it. Page 0 belongs to no other
    row, so every output compares too (within tolerance())."""
    case = build_ecc_case("golay", seed=7, pages=4, ctx=[40, 1, 17])
    nb = case["k_cache"].shape[1]
    for n in H84_NAMES:  # one more page: the trash page 0
        case[n] = np.concatenate([case[n][:, :1], case[n]], axis=1)
    case["bt"] = case["bt"] + 1
    case["bt"][1] = -1
    assert case["k_cache"].shape[1] == nb + 1
    if scrub:
        dw = case["k_cache"].shape[3]
        case["kn"], case["vn"] = case["kn"][..., :dw].copy(), case["vn"][..., :dw].copy()
        parity = {n: case.pop(n) for n in ("k_parity", "v_parity")}
        kw = dict(scrub=True, codec="golay", block_size=H84_BS)
        jargs = [jnp.asarray(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn", *NAMES, "bt", "ctx")]
        outs = jpa.paged_attention_ecc_write_attend(*jargs, 1, **kw)
        want = (np.asarray(outs[0]), dict(zip(NAMES, (np.asarray(o) for o in outs[1:5]))))
        tt = {n: torch.from_numpy(case[n].copy()) for n in NAMES}
        out = tpa.paged_attention_ecc_write_attend(
            *(torch.from_numpy(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn")),
            *(tt[n] for n in NAMES), torch.from_numpy(case["bt"]),
            torch.from_numpy(case["ctx"]), 1, **kw)
        got = (out.numpy(), {n: a.numpy() for n, a in tt.items()})
        case.update(parity)
    else:
        want = run_jax_read(case, "golay", 1)
        got = run_torch_read(case, "golay", 1)
    assert_reads_agree(case, want, got)
    assert not np.array_equal(got[1]["k_cache"][1, 0], case["k_cache"][1, 0])
    np.testing.assert_array_equal(got[1]["k_cache"][1, 0, :, :, 0], case["kn"][1][..., :case["k_cache"].shape[3]])


def test_signature_defaults_match_jax():
    """F2: every parameter of the JAX wrapper, with its default."""
    want = {k: v.default for k, v in
            inspect.signature(jpa.paged_attention_ecc_write_attend).parameters.items()}
    got = {k: v.default for k, v in
           inspect.signature(tpa.paged_attention_ecc_write_attend).parameters.items()}
    assert got == want


@pytest.mark.parametrize("codec", ["golay", "hamming74"])
def test_precision_highest_matches_jax(codec):
    """precision="highest": fp32 query and fp32 softmax weights on both
    sides (golay's scrubbed extract read, hamming74's correcting read), so
    the outputs differ only by fp32 summation order and exp: within 1e-5 of
    the largest dequantized |V|. The "fast" outputs differ from them by
    more than that (the bf16 roundings)."""
    if codec == "golay":
        case = build_case("golay", 16, [0, 15, 16, 40], seed=9)
        want = jpa.paged_attention_ecc_write_attend(
            *(jnp.asarray(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn", *NAMES, "bt", "ctx")),
            1, scrub=True, codec="golay", block_size=16, precision="highest")[0]
        run = functools.partial(
            tpa.paged_attention_ecc_write_attend,
            *(torch.from_numpy(case[n].copy()) for n in ("q", "kn", "vn", "ksn", "vsn", *NAMES, "bt", "ctx")),
            1, scrub=True, codec="golay", block_size=16)
        got, fast = run(precision="highest").numpy(), run().numpy()
    else:
        case = build_ecc_case(codec, seed=10)
        want = run_jax_read(case, codec, 1, precision="highest")[0]
        got = run_torch_read(case, codec, 1, precision="highest")[0]
        fast = run_torch_read(case, codec, 1)[0]
    atol = 1e-5 * 8.0 * float(np.abs(case["v_scales"]).max())
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)
    assert np.abs(fast - np.asarray(want)).max() > atol


def test_num_pages_matches_jax():
    """num_pages 5 of a table 8 pages wide: only those pages are attended
    and written (contexts up to 80 tokens = 5 pages), as JAX's max_pages;
    hamming74's correcting read with stats, chunks of 2 pages."""
    case = build_ecc_case("hamming74", seed=11, ctx=[80, 71, 33, 1])
    kw = dict(num_pages=5, collect_stats=True)
    assert_reads_agree(case, run_jax_read(case, "hamming74", 0, **kw),
                       run_torch_read(case, "hamming74", 0, **kw))


# =============================================================================
# F4: the pages a read visits (num_pages rounded up to whole chunks, each
# page past num_pages read as page num_pages - 1), and K4, the read without a
# write (paged_attention_ecc)
# =============================================================================

F4_CTX = [90, 80, 50, 1]  # row 0 reads past num_pages * bs = 80 tokens


@pytest.mark.parametrize("ppc", [2, 5])
@pytest.mark.parametrize("codec", ["int4", "hamming74"])
@pytest.mark.parametrize("read", ["write_attend", "paged_attention_ecc"])
def test_visited_pages_match_jax(read, codec, ppc):
    """F4 on its smallest input: a table 8 pages wide, num_pages 5, block
    16, a row at ctx 90 (past 5 x 16 = 80). With pages_per_chunk 2 the
    kernel visits 6 pages and reads page 4 again as tokens 80-95, attending
    and counting tokens 80-89; with 5 it visits 5 and never reads tokens
    80-89. The new column of that row (token 89, page 5) is not written, so
    its read comes from the cache. Outputs within tolerance(), stats and
    arrays exactly, against JAX in interpret mode."""
    case = build_ecc_case(codec, seed=12, ctx=F4_CTX)
    kw = dict(num_pages=5, pages_per_chunk=ppc, collect_stats=True)
    if read == "write_attend":
        want = run_jax_read(case, codec, 1, **kw)
        got = run_torch_read(case, codec, 1, **kw)
    else:
        want, got = run_jax_k4(case, codec, 1, **kw), run_torch_k4(case, codec, 1, **kw)
    assert_reads_agree(case, want, got)
    if codec == "hamming74":
        assert (got[0][1][:3, 0] > 0).all()


def run_jax_k4(case, codec, layer, **kw):
    """JAX's paged_attention_ecc in interpret mode: (its returns, the
    arrays, which a read leaves as they were)."""
    kw.setdefault("pages_per_chunk", H84_CHUNK_PAGES)
    parity = "k_parity" in case
    out = jpa.paged_attention_ecc(
        *(jnp.asarray(case[n]) for n in ("q", "k_cache", "v_cache", "k_scales", "v_scales",
                                          "bt", "ctx")),
        layer, *((jnp.asarray(case["k_parity"]), jnp.asarray(case["v_parity"])) if parity
                 else ()), codec=codec, block_size=case["k_cache"].shape[-1], **kw)
    return jax.tree.map(np.asarray, out), {n: case[n] for n in
                                          (H84_NAMES if parity else NAMES)}


def run_torch_k4(case, codec, layer, **kw):
    """The port's paged_attention_ecc (its plain version on the CPU) on
    copies of the case's arrays: (its returns as numpy, the arrays after)."""
    kw.setdefault("pages_per_chunk", H84_CHUNK_PAGES)
    parity = "k_parity" in case
    tt = {n: torch.from_numpy(case[n].copy()) for n in (H84_NAMES if parity else NAMES)}
    out = tpa.paged_attention_ecc(
        torch.from_numpy(case["q"]), tt["k_cache"], tt["v_cache"], tt["k_scales"],
        tt["v_scales"], torch.from_numpy(case["bt"]), torch.from_numpy(case["ctx"]), layer,
        *((tt["k_parity"], tt["v_parity"]) if parity else ()), codec=codec,
        block_size=case["k_cache"].shape[-1], **kw)
    return jax.tree.map(lambda t: t.numpy(), out), {n: a.numpy() for n, a in tt.items()}


# (cache kind, codec, options) of every K4 branch: int4 clean and with
# read injection, the scrub-extract read (golay's scrubbed cache), hamming84
# with and without interpolation, hamming74, golay
K4_BRANCHES = {
    "int4": ("ecc", "int4", {}),
    "int4-read-inject": ("ecc", "int4", dict(read_inject_ber=1e-2, read_inject_seed=-12345)),
    "extract": ("scrubbed", "golay", dict(scrub=True)),
    "hamming84-interp": ("h84", "hamming84", dict(use_interpolation=True)),
    "hamming84": ("h84", "hamming84", {}),
    "hamming74": ("ecc", "hamming74", {}),
    "golay": ("ecc", "golay", {}),
}


K4_CTX = [112, 71, 33, 1, 0]


def k4_case(branch, seed):
    """The branch's cache, read by five rows: three of 1-4 chunks, one of
    ctx 1 whose page is -1 (it reads page 0, another row's page) and an
    empty one (ctx 0)."""
    kind, codec, _ = K4_BRANCHES[branch]
    if kind == "h84":  # three rows of H84_CTX; two more on row 0's pages
        case = build_h84_case(seed=seed)
        for n in ("bt", "q"):
            case[n] = np.concatenate([case[n], case[n][:1].repeat(2, 0)])
        case["ctx"] = np.asarray(H84_CTX + [1, 0], np.int32)
    elif kind == "scrubbed":  # build_case's contexts count the new token
        case = build_case(codec, 32, [c - 1 for c in K4_CTX], batch=5, pages=8, seed=seed)
    else:
        case = build_ecc_case(codec, seed=seed, ctx=K4_CTX)
    case["bt"][3] = -1
    return case


@pytest.mark.parametrize("branch,stats", [(b, s) for b in K4_BRANCHES for s in (False, True)
                                           if not (s and b == "extract")])
def test_attend_matches_jax(branch, stats):
    """K4's plain version against JAX's paged_attention_ecc in interpret
    mode, every branch with and without collect_stats (the extract read
    refuses stats: test_attend_signature_and_checks), bs 16,
    pages_per_chunk 2, five rows including a -1 page and an empty one:
    outputs within tolerance() (the module docstring's bound), stats
    exactly, the arrays untouched; the empty row reads 0."""
    _, codec, kw = K4_BRANCHES[branch]
    case = k4_case(branch, seed=20 + list(K4_BRANCHES).index(branch))
    want = run_jax_k4(case, codec, 1, collect_stats=stats, **kw)
    got = run_torch_k4(case, codec, 1, collect_stats=stats, **kw)
    assert_reads_agree(case, want, got)
    for n, a in got[1].items():
        np.testing.assert_array_equal(a, case[n], err_msg=n)
    out = got[0][0] if stats else got[0]
    assert not out[4].any()
    if stats and (codec != "int4" or "inject" in branch):
        assert (got[0][1][:3, 0] > 0).all()


@pytest.mark.parametrize("branch", list(K4_BRANCHES))
def test_attend_softmax_state_matches_jax(branch):
    """return_softmax_state with a sliding window of 8 (the query at ctx-1
    attends tokens ctx-8 .. ctx-1): acc within tolerance() (weights are at
    most 1, so one bf16 ulp of one weight moves acc as much as the output),
    m and l within 1e-5 relative (float32 sums and exp), stats exactly; the
    empty row gives acc 0, m -1e30 and l 0; acc / l is the plain output."""
    _, codec, kw = K4_BRANCHES[branch]
    stats = branch != "extract"
    case = k4_case(branch, seed=40 + list(K4_BRANCHES).index(branch))
    kw = dict(kw, sliding_window=8, collect_stats=stats)
    jout = run_jax_k4(case, codec, 0, return_softmax_state=True, **kw)[0]
    tout = run_torch_k4(case, codec, 0, return_softmax_state=True, **kw)[0]
    (jst, jstats), (tst, tstats) = (jout, tout) if stats else ((jout, None), (tout, None))
    (jacc, jm, jl), (tacc, tm, tl) = jst, tst
    assert tacc.dtype == tm.dtype == tl.dtype == np.float32
    assert tacc.shape == case["q"].shape and tm.shape == tl.shape == case["q"].shape[:2]
    np.testing.assert_allclose(tacc, jacc, rtol=0, atol=tolerance(case))
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=0)
    if stats:
        np.testing.assert_array_equal(tstats, jstats)
    assert not tacc[4].any() and (tm[4] == -1e30).all() and not tl[4].any()
    out = run_torch_k4(case, codec, 0, **kw)[0]
    out = out[0] if stats else out
    safe = np.where(tl > 0, tl, 1)[..., None]
    np.testing.assert_allclose(out, np.where(tl[..., None] > 0, tacc / safe, 0), rtol=1e-6,
                               atol=1e-7)


def test_attend_signature_and_checks():
    """K4's signature and defaults are JAX's; its refusals are JAX's
    ValueErrors (scrub with interpolation, stats or read injection; read
    injection outside int4; a parity codec's correcting read without parity
    arrays) and the port's (block size; a float codec's read of a packed
    cache, whose rows are not head_dim values - the float reads themselves
    are tests/test_torch_float_attention.py's); the CPU never launches a
    kernel."""
    want = {k: v.default for k, v in inspect.signature(jpa.paged_attention_ecc).parameters.items()}
    got = {k: v.default for k, v in inspect.signature(tpa.paged_attention_ecc).parameters.items()}
    assert got == want
    case = build_ecc_case("golay", seed=13, ctx=[40, 3])
    args = [torch.from_numpy(case[n]) for n in ("q", "k_cache", "v_cache", "k_scales",
                                                "v_scales", "bt", "ctx")]
    parity = [torch.from_numpy(case[n]) for n in ("k_parity", "v_parity")]
    call = functools.partial(tpa.paged_attention_ecc, *args, 0, *parity, block_size=16)
    with pytest.raises(ValueError, match="interpolation"):
        call(codec="hamming84", scrub=True, use_interpolation=True)
    with pytest.raises(ValueError, match="collect_stats"):
        call(codec="golay", scrub=True, collect_stats=True)
    with pytest.raises(ValueError, match="read-time injection"):
        call(codec="golay", scrub=True, read_inject_ber=1e-2)
    with pytest.raises(ValueError, match="only defined for the unprotected int4"):
        call(codec="golay", read_inject_ber=1e-2)
    with pytest.raises(ValueError, match="k_parity/v_parity"):
        tpa.paged_attention_ecc(*args, 0, codec="golay", block_size=16)
    with pytest.raises(ValueError, match="block_size"):
        tpa.paged_attention_ecc(*args, 0, *parity, codec="golay")
    for codec in ("fp16", "fp8"):
        with pytest.raises(ValueError, match="data words"):
            tpa.paged_attention_ecc(*args, 0, codec=codec, block_size=16)
    # scrub reads golay's data words alone: the parity arrays are not needed
    out = tpa.paged_attention_ecc(*args, 0, codec="golay", scrub=True, block_size=16)
    assert out.shape == case["q"].shape
    assert tpa.paged_attention_ecc.launches == 0
    assert all(v == 0 for v in tpa.paged_attention_ecc.launches_by.values())
