"""The float codecs' paged attention (K2f) in the port - the plain PyTorch
versions that the wrappers run on the CPU - against the JAX kernel's float
branch in Pallas interpret mode: paged_attention_ecc_write_attend and
paged_attention_ecc (K4) with codec "fp16" (bfloat16 pages) and "fp8"
(e4m3 pages), and paged_attention_ecc_reference.

Inputs (numpy, from a seed): 4 sequences, 2 KV heads, group 2, head_dim 16,
block 16, an 8-page table read in chunks of 2 pages (32 tokens), contexts
after the write of 1, 17, 41 and 70 tokens; every slot of the cache holds a
value, so dead slots and the pages past a context hold values too. The
table starts at physical page 1: page 0, where an entry of -1 reads, is no
row's. (In interpret mode the JAX kernel reads the cache as it was before
the call, while a write lands in the aliased output, so a row that read a
page another row writes would see the old page there and the new one on
the TPU and in the port.)

Stored bits (caches after the write; the scales arrays, which a float
write leaves as they are) must be equal. Outputs: both sides round q and p
to bf16 and take the softmax online page by page, so they differ by float32
summation order and exp, except where that moves one weight across a bf16
rounding boundary: one bf16 ulp (2^-8 relative) of one weight, hence a
tolerance of 2^-8 of the largest |V| (as tests/test_torch_paged_attention.py).
NaN must stand where JAX's stands (the NaN cases below), and nowhere else.
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.kernels import paged_attention as jpa  # noqa: E402
from qkv_ecc_tpu_torch.kernels import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)
B, HKV, GROUP, D, BS, PAGES, PPC, LAYERS = 4, 2, 2, 16, 16, 8, 2, 2
NB = B * PAGES + 1  # physical pages: the table's and page 0
CTX = [1, 17, 41, 70]  # after the write: chunk (32 tokens) and page seams on both sides
NAMES = ("k_cache", "v_cache", "k_scales", "v_scales")
JDTYPE = {"fp16": jnp.bfloat16, "fp8": jnp.float8_e4m3fn}
TDTYPE = {"fp16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
NAN_BITS = {"fp16": 0x7FC0, "fp8": 0x7F}


def stored(codec, x):
    """float32 numpy -> the codec's stored values (ml_dtypes numpy), as JAX
    rounds them."""
    return np.array(jnp.asarray(x).astype(JDTYPE[codec]))


def bits(a):
    return a.view(f"u{a.itemsize}") if a.dtype.name in ("bfloat16", "float8_e4m3fn") else a


def to_torch(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)
    return t.numpy()


def build_case(codec, seed, ctx=CTX):
    """A float cache with a value in every slot (normals, a tenth of them
    times 30 so that fp8 rounds at several exponents), new columns, random
    scales arrays (which must come out untouched), a query."""
    rng = np.random.default_rng(seed)

    def vals(*shape):
        x = rng.normal(size=shape)
        return stored(codec, np.where(rng.random(shape) < 0.1, 30 * x, x).astype(np.float32))

    T = PAGES * BS
    case = {
        "k_cache": vals(LAYERS, NB, HKV, D, BS), "v_cache": vals(LAYERS, NB, HKV, D, BS),
        "k_scales": rng.random((LAYERS, NB, HKV, BS)).astype(np.float32),
        "v_scales": rng.random((LAYERS, NB, HKV, BS)).astype(np.float32),
        "kn": vals(B, HKV, D), "vn": vals(B, HKV, D),
        "ksn": np.ones((B, HKV), np.float32), "vsn": np.ones((B, HKV), np.float32),
        "bt": np.arange(1, NB, dtype=np.int32).reshape(B, PAGES),
        "ctx": np.asarray(ctx, np.int32),
        "q": rng.normal(size=(B, HKV * GROUP, D)).astype(np.float32),
    }
    assert T >= max(ctx)
    return case


def poison(case, codec, name, b, tok, d=3, layer=1, head=0):
    """Store NaN at value d of token tok of sequence b (head 0)."""
    page = case["bt"][b, tok // BS]
    bits(case[name])[layer, page, head, d, tok % BS] = NAN_BITS[codec]


def run_jax(case, codec, layer=1, read=False, **kw):
    """The JAX kernel in interpret mode: (output, the arrays after the write
    or None for a read)."""
    if read:
        out = jpa.paged_attention_ecc(
            jnp.asarray(case["q"]), *(jnp.asarray(case[n]) for n in NAMES),
            jnp.asarray(case["bt"]), jnp.asarray(case["ctx"]), layer, codec=codec,
            block_size=BS, pages_per_chunk=PPC, **kw)
        return jax.tree.map(np.asarray, out), None
    outs = jpa.paged_attention_ecc_write_attend(
        *(jnp.asarray(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn")),
        *(jnp.asarray(case[n]) for n in NAMES), jnp.asarray(case["bt"]),
        jnp.asarray(case["ctx"]), layer, codec=codec, block_size=BS, pages_per_chunk=PPC,
        **kw)
    outs = [np.asarray(o) for o in outs]
    out = (outs[0], outs[-1]) if kw.get("collect_stats") else outs[0]
    return out, dict(zip(NAMES, outs[1:5]))


def run_torch(case, codec, layer=1, read=False, **kw):
    """The port's plain versions on copies of the case's arrays."""
    arrays = {n: to_torch(case[n].copy()) for n in NAMES}
    common = dict(codec=codec, block_size=BS, pages_per_chunk=PPC, **kw)
    if read:
        out = tpa.paged_attention_ecc(
            to_torch(case["q"]), *(arrays[n] for n in NAMES), to_torch(case["bt"]),
            to_torch(case["ctx"]), layer, **common)
    else:
        out = tpa.paged_attention_ecc_write_attend(
            *(to_torch(case[n]) for n in ("q", "kn", "vn", "ksn", "vsn")),
            *(arrays[n] for n in NAMES), to_torch(case["bt"]), to_torch(case["ctx"]), layer,
            **common)
    out = jax.tree.map(to_numpy, out)
    return out, {n: to_numpy(a) for n, a in arrays.items()}


def tolerance(case):
    return 2.0 ** -8 * float(np.nanmax(np.abs(case["v_cache"].astype(np.float32))))


def assert_close(got, want, atol, err_msg="", rtol=0):
    """NaN where JAX has NaN and nowhere else; the rest within atol (and
    rtol)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=err_msg + " (NaN)")
    nan = np.isnan(want)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=rtol, atol=atol, err_msg=err_msg)


def same_arrays(want, got):
    for n in NAMES:
        np.testing.assert_array_equal(bits(want[n]), bits(got[n]), err_msg=n)


@pytest.mark.parametrize("codec", ["fp16", "fp8"])
@pytest.mark.parametrize("precision", ["fast", "highest"])
def test_write_attend_matches_jax(codec, precision):
    """K2f's write+attend: the new column lands at ctx-1 of layer 1 only,
    the scales arrays stay as they were, outputs agree (bf16 and float32
    queries)."""
    case = build_case(codec, seed=1 if precision == "fast" else 2)
    for qdtype in (np.float32, jnp.bfloat16):
        c = dict(case, q=case["q"].astype(qdtype))
        want_out, want = run_jax(c, codec, precision=precision)
        got_out, got = run_torch(c, codec, precision=precision)
        same_arrays(want, got)
        for n in ("k_scales", "v_scales"):
            np.testing.assert_array_equal(got[n], case[n])
        assert not np.array_equal(bits(got["k_cache"][1]), bits(case["k_cache"][1]))
        np.testing.assert_array_equal(bits(got["k_cache"][0]), bits(case["k_cache"][0]))
        assert got_out.dtype == want_out.dtype
        assert_close(got_out, want_out, tolerance(case), f"q {np.dtype(qdtype).name}")
        assert np.isfinite(got_out.astype(np.float32)).all()


@pytest.mark.parametrize("codec", ["fp16", "fp8"])
def test_nan_reaches_the_output_as_in_jax(codec):
    """NaN bytes (fp8 0x7f, bf16 0x7fc0) in: a live K slot (sequence 0: its
    rows' weights turn NaN, the output reads 0), a live V slot (1), a dead V
    slot of the last page (2: slot 45 with ctx 41) and a V slot of a page
    past the context inside the last chunk (3: page 4 holds tokens 64-79,
    ctx 70, chunk 2 holds pages 4-5: token 85 of page 5), and a V slot of a
    chunk the kernel never processes (2: token 100, chunk 3): NaN where JAX
    gives NaN, the rest within tolerance, for the write+attend and the read
    with the softmax state."""
    case = build_case(codec, seed=3)
    poison(case, codec, "k_cache", 0, 0)  # the new token of row 0 is its column: also poison it
    bits(case["kn"])[0, 0, 3] = NAN_BITS[codec]
    poison(case, codec, "v_cache", 1, 5)
    poison(case, codec, "v_cache", 2, 45)
    poison(case, codec, "v_cache", 3, 85)
    poison(case, codec, "v_cache", 2, 100, d=7)
    want_out, want = run_jax(case, codec)
    got_out, got = run_torch(case, codec)
    same_arrays(want, got)
    assert_close(got_out, want_out, tolerance(case))
    nan = np.isnan(got_out.astype(np.float32))
    assert not nan[0].any() and not got_out[0, :GROUP].any()  # K NaN: weights NaN, output 0
    assert nan[1, :GROUP, 3].all() and nan[2, :GROUP, 3].all() and nan[3, :GROUP, 3].all()
    assert not nan[:, :, 7].any()  # the unprocessed chunk stays out
    assert not nan[:, GROUP:].any()  # head 1 is clean
    w, g = run_jax(case, codec, read=True, return_softmax_state=True)[0], run_torch(
        case, codec, read=True, return_softmax_state=True)[0]
    assert_close(g[0], w[0], tolerance(case), "acc")
    for a, b, name in zip(g[1:], w[1:], ("m", "l")):
        assert_close(a, b, 1e-6, name, rtol=1e-5)
    assert np.isnan(g[1][0, :GROUP]).all() and np.isnan(g[0][0, :GROUP]).all()


@pytest.mark.parametrize("codec", ["fp16", "fp8"])
@pytest.mark.parametrize("window", [None, 20])
def test_read_matches_jax(codec, window):
    """K4's float read: the output, and the softmax state (acc within the
    output's tolerance, m and l within 1e-5 relative) with an empty row
    (0, -1e30, 0), a row on a page of -1 (page 0), with and without a
    sliding window; statistics of a float read are zeros."""
    case = build_case(codec, seed=4, ctx=[0, 17, 41, 70])
    case["bt"][1, 1] = -1  # tokens 16-31 of row 1 read page 0
    kw = dict(sliding_window=window)
    (want, wstats), _ = run_jax(case, codec, read=True, collect_stats=True, **kw)
    (got, gstats), _ = run_torch(case, codec, read=True, collect_stats=True, **kw)
    assert_close(got, want, tolerance(case))
    assert gstats.tolist() == wstats.tolist() == [[0, 0]] * B
    w = run_jax(case, codec, read=True, return_softmax_state=True, **kw)[0]
    g = run_torch(case, codec, read=True, return_softmax_state=True, **kw)[0]
    assert_close(g[0], w[0], tolerance(case))
    for a, b in zip(g[1:], w[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert not g[0][0].any() and (g[1][0] == -1e30).all() and not g[2][0].any()


@pytest.mark.parametrize("codec", ["fp16", "fp8"])
@pytest.mark.parametrize("read", [False, True])
def test_visited_pages_match_jax(codec, read):
    """F4 in the float read: num_pages 5 of the 8-page table at 2-page
    chunks, so the kernel visits 6 pages and reads page 4 again as page 5;
    row 3's context (70) runs past page 5; a -1 page in row 2."""
    case = build_case(codec, seed=5)
    case["bt"][2, 0] = -1
    want = run_jax(case, codec, read=read, num_pages=5)
    got = run_torch(case, codec, read=read, num_pages=5)
    assert_close(got[0], want[0], tolerance(case))
    if not read:
        same_arrays(want[1], got[1])


def test_reference_and_checks():
    """paged_attention_ecc_reference of both float codecs against JAX's
    (float32, within 1e-5); the wrappers refuse what JAX refuses - scrub
    and read injection on a float codec - and a cache whose rows are not
    head_dim values, or of another type; the CPU never launches."""
    for codec in ("fp16", "fp8"):
        case = build_case(codec, seed=6)
        args = ("q", "k_cache", "v_cache", "k_scales", "v_scales", "bt", "ctx")
        want = jpa.paged_attention_ecc_reference(*(jnp.asarray(case[a]) for a in args), 1,
                                                 codec=codec, block_size=BS)
        got = tpa.paged_attention_ecc_reference(*(to_torch(case[a]) for a in args), 1, codec=codec,
                                                block_size=BS)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        t = {n: to_torch(case[n]) for n in case}
        call = functools.partial(tpa.paged_attention_ecc_write_attend,
                                 *(t[n] for n in ("q", "kn", "vn", "ksn", "vsn", *NAMES, "bt",
                                                  "ctx")), 0, codec=codec, block_size=BS)
        with pytest.raises(ValueError, match="packed-int"):
            call(scrub=True)
        with pytest.raises(ValueError, match="only defined for the unprotected int4"):
            call(read_inject_ber=1e-2)
        narrow = [t[n][..., :8, :] for n in ("k_cache", "v_cache")]
        with pytest.raises(ValueError, match="data words"):
            tpa.paged_attention_ecc(t["q"], *narrow, t["k_scales"], t["v_scales"], t["bt"],
                                    t["ctx"], 0, codec=codec, block_size=BS)
        other = [x.to(torch.float32) for x in (t["k_cache"], t["v_cache"])]
        with pytest.raises(ValueError, match="cache is"):
            tpa.paged_attention_ecc(t["q"], *other, t["k_scales"], t["v_scales"], t["bt"],
                                    t["ctx"], 0, codec=codec, block_size=BS)
    assert tpa.paged_attention_ecc_write_attend.launches == 0
    assert tpa.paged_attention_ecc.launches == 0


@pytest.mark.parametrize("splits", [2, 3, 5])
def test_merge_softmax_states_matches_jax(splits):
    """merge_softmax_states against JAX's merge_softmax_shards run under
    jax.vmap with the splits as its axis name: random states from a seed,
    one split empty (m -1e30, l 0) whose acc holds a NaN (a dead slot's
    NaN V: 0 * NaN stays NaN), a NaN in a non-empty split's acc, and a row
    whose every split is empty (reads 0). NaN at the same elements, the
    rest within 1e-6; m is the splits' largest."""
    from qkv_ecc_tpu.parallel.context_parallel import merge_softmax_shards

    rng = np.random.default_rng(20 + splits)
    acc = rng.normal(size=(splits, 3, 4, D)).astype(np.float32)
    m = rng.normal(scale=4.0, size=(splits, 3, 4)).astype(np.float32)
    l = (rng.random((splits, 3, 4)) + 0.5).astype(np.float32)
    m[1], l[1], acc[1] = -1e30, 0.0, 0.0
    acc[1, 0, 1, 2] = np.nan
    acc[0, 2, 0, 7] = np.nan
    m[:, 1, 3], l[:, 1, 3], acc[:, 1, 3] = -1e30, 0.0, 0.0
    want = jax.vmap(lambda a, mm, ll: merge_softmax_shards(a, mm, ll, "splits"),
                    axis_name="splits")(acc, m, l)[0]
    got_acc, got_m, got_l = tpa.merge_softmax_states(*(torch.from_numpy(x) for x in (acc, m, l)))
    got = tpa._normalise(got_acc, got_l, torch.float32).numpy()
    assert_close(got, np.asarray(want), 1e-6, rtol=1e-6)
    assert np.isnan(got[0, 1, 2]) and np.isnan(got[2, 0, 7]) and not got[1, 3].any()
    np.testing.assert_array_equal(got_m.numpy(), m.max(axis=0))


def _split_read(case, codec, parts, num_pages, write, layer=1):
    """The plain model of K2f's split: (after the port's plain write, for a
    write+attend) the visited pages cut into `parts` contiguous ranges, each
    read as a softmax state with its weights rounded against its own running
    maximum, merged by merge_softmax_states and normalised. Returns the
    output (float32 numpy) and the arrays after the write."""
    t = {n: to_torch(case[n].copy()) for n in case}
    if write:
        tpa._write_column((t["kn"], t["vn"]), (t["k_cache"], t["v_cache"]), (), (), t["bt"],
                          t["ctx"], layer, num_pages)
    visited = tpa.visited_pages(num_pages, PPC)
    states = [tpa._read(t["q"], *(t[n] for n in NAMES), t["bt"], t["ctx"], layer, codec=codec,
                        sm_scale=D ** -0.5, num_pages=num_pages, pages_per_chunk=PPC,
                        page_range=r)[0]
              for r in np.array_split(np.arange(visited), parts)]
    acc, _, l = tpa.merge_softmax_states(*(torch.stack(x) for x in zip(*states)))
    return tpa._normalise(acc, l, torch.float32).numpy(), {n: to_numpy(t[n]) for n in NAMES}


@pytest.mark.parametrize("codec", ["fp16", "fp8"])
@pytest.mark.parametrize("variant", ["clean", "NaN pages", "-1 page, num_pages 5"])
@pytest.mark.parametrize("read", [False, True])
def test_split_read_matches_jax(codec, variant, read):
    """The rounding of K2f's split context fits the stated tolerance: the
    visited pages cut into 2, 3 and 4 ranges (_split_read) stay within
    tolerance(case) of JAX's paged_attention_ecc_write_attend (arrays after
    the write equal) and paged_attention_ecc, NaN where JAX has NaN: on a
    clean cache; with NaN in a live K slot, a live V slot, a dead V slot of
    the last page and a page past the context in the last chunk; and with a
    -1 page (row 2 reads page 0) and F4's num_pages 5 (6 pages visited)."""
    case = build_case(codec, seed=9)
    num_pages = PAGES
    if variant == "NaN pages":
        poison(case, codec, "k_cache", 0, 0)
        bits(case["kn"])[0, 0, 3] = NAN_BITS[codec]
        poison(case, codec, "v_cache", 1, 5)
        poison(case, codec, "v_cache", 2, 45)
        poison(case, codec, "v_cache", 3, 85)
    elif variant != "clean":
        case["bt"][2, 0] = -1
        num_pages = 5
    want, want_arrays = run_jax(case, codec, read=read, num_pages=num_pages)
    for parts in (2, 3, 4):
        got, arrays = _split_read(case, codec, parts, num_pages, write=not read)
        assert_close(got, want, tolerance(case), f"{parts} ranges")
        if not read:
            same_arrays(want_arrays, arrays)
    if variant == "NaN pages":
        assert np.isnan(got[1:, :GROUP, 3]).all() and not got[0, :GROUP].any()
