"""The port's model layer (qkv_ecc_tpu_torch.models: config, layers, gpt2,
llama, registry, and kv_policy's forward path) against the JAX package on
the same inputs: numpy-made ids from a seed, JAX's weights through
params_from_jax, and for the faulty runs the very masks JAX draws from its
keys (per layer i, K and V: fold_in(fold_in(key(seed), i), 0 or 1), the
int4 arm's read flips folded once more with "READ"), fed to the port as
write_masks / read_masks. Sampled generation is held to its own contract
(deterministic per seed, greedy as the temperature goes to 0, frequencies
of the softmax).

Tolerances, with their reasons:
  * logits within rtol 1e-5, atol 1e-5 and losses within rtol 1e-6: the
    two frameworks' float32 matmuls sum in other orders, an ulp or two per
    product (measured up to 3.6e-7 in the logits and 9.5e-7 in the
    losses on these inputs); the K/V codes are the same, so no value lands
    on another quantization code here (one would move the logits by far
    more and fail);
  * ECC statistics, roundtrip values, codewords and scales exactly equal;
  * cross entropy within rtol 1e-6 (a log-softmax in float32), counts
    equal;
  * flip rates within 5 sigma of the BER (binomial);
  * the sampled frequencies by a chi-square test at the 1e-3 level (the
    draws are seeded, so the test is deterministic).
"""

import dataclasses
import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy import stats as sps  # noqa: E402

from qkv_ecc_tpu.codecs.fault_injection import flip_mask_for  # noqa: E402
from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu.models import config as jconfig  # noqa: E402
from qkv_ecc_tpu.models import kv_policy as jkv  # noqa: E402
from qkv_ecc_tpu.models import layers as jl  # noqa: E402
from qkv_ecc_tpu.models import registry as jreg  # noqa: E402
from qkv_ecc_tpu_torch.models import config as tconfig  # noqa: E402
from qkv_ecc_tpu_torch.models import kv_policy as tkv  # noqa: E402
from qkv_ecc_tpu_torch.models import layers as tl  # noqa: E402
from qkv_ecc_tpu_torch.models import llama as tllama  # noqa: E402
from qkv_ecc_tpu_torch.models import registry as treg  # noqa: E402
from qkv_ecc_tpu_torch.models import runtime as tr  # noqa: E402

torch.set_num_threads(1)
READ = 0x52454144  # JAX's "READ" stream
MODES = ["fp16", "fp8", "int4", "int4-write-inject", "int4-hamming", "int4-hamming84",
         "int4-hamming84-interp", "int12-golay"]
B, S = 2, 24


@functools.lru_cache(maxsize=None)
def weights(name):
    jc, tc = jconfig.get_model_config(name), tconfig.get_model_config(name)
    jp = jreg.init_params(jc, 0)
    return jc, tc, jp, treg.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu")


def enc_shape(codec, shape, head_dim):
    """The logical codeword shape JAX's encode_kv draws its mask over."""
    if codec == "fp8":
        return shape + (head_dim,)
    if codec == "golay":
        return shape + (js.padded_values("golay", head_dim) // 3,)
    return shape + (js.padded_values(codec, head_dim),)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _draw_masks(keys, shape, ber, n_bits):
    return jax.vmap(lambda k: flip_mask_for(k, shape, ber, n_bits))(keys)


def _jax_layer_masks(seed, num_layers, shape, ber, n_bits, read):
    """[L, 2, *shape] masks from JAX's process_kv keys (one compiled draw
    per shape and bit count)."""
    keys = []
    for i in range(num_layers):
        base = jax.random.fold_in(jax.random.key(seed), i)
        for t in (0, 1):
            k = jax.random.fold_in(base, t)
            keys.append(jax.random.fold_in(k, READ) if read else k)
    m = _draw_masks(jnp.stack(keys), shape, ber, n_bits)
    return np.asarray(m).reshape((num_layers, 2) + shape).astype(np.int32)


def jax_masks(jpol, cfg, shape):
    """(write_masks, read_masks) as torch tensors or None: the flips JAX's
    forward draws for jpol over K/V of [*shape, Hkv, D]."""
    if not (jpol.inject_errors and jpol.ber > 0) or jpol.codec == "fp16":
        return None, None
    es = enc_shape(jpol.codec, shape + (cfg.num_kv_heads,), cfg.head_dim)
    if jpol.inject_at == "read":
        return None, torch.from_numpy(
            _jax_layer_masks(jpol.seed, cfg.num_layers, es, jpol.ber, 4, True))
    return torch.from_numpy(_jax_layer_masks(jpol.seed, cfg.num_layers, es, jpol.ber,
                                             jkv.N_BITS[jpol.codec], False)), None


def ints(d):
    return {k: int(v) for k, v in d.items()}


def same(a, b):
    """Equal tensors, NaN (fp8's 0x7f and 0xff bytes) equal to NaN."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def test_configs_copied():
    """The nine configurations, field for field and in JAX's order (the
    port's own latent-attention, expert and YaRN fields at their defaults),
    then the port's own, and get_model_config's unknown-name error (its
    list naming the port's configurations)."""
    assert list(tconfig.MODEL_CONFIGS)[:9] == list(jconfig.MODEL_CONFIGS)
    assert len(jconfig.MODEL_CONFIGS) == 9
    assert list(tconfig.MODEL_CONFIGS)[9:] == ["deepseek-v2-lite", "tiny-deepseek-v2"]
    defaults = {f.name: f.default for f in dataclasses.fields(tconfig.ModelConfig)}
    for name, jc in jconfig.MODEL_CONFIGS.items():
        tc = dataclasses.asdict(tconfig.get_model_config(name))
        jd = dataclasses.asdict(jc)
        assert {k: tc[k] for k in jd} == jd, name
        assert {k: v for k, v in tc.items() if k not in jd} == {
            k: defaults[k] for k in tc if k not in jd}, name
    msgs = []
    for module in (jconfig, tconfig):
        with pytest.raises(ValueError, match="Unknown model 'gpt5'") as err:
            module.get_model_config("gpt5")
        msgs.append(str(err.value))
    assert msgs[0] == f"Unknown model 'gpt5'. Known: {sorted(jconfig.MODEL_CONFIGS)}"
    assert msgs[1] == f"Unknown model 'gpt5'. Known: {sorted(tconfig.MODEL_CONFIGS)}"


@pytest.mark.parametrize("name", list(jconfig.MODEL_CONFIGS))
def test_config_dict_and_repr_are_jax(name):
    """A configuration of the nine gives JAX's dict (the JSON beside a saved
    checkpoint) and JAX's repr (which sweep fingerprints hash), in its
    order."""
    tc, jc = tconfig.get_model_config(name), jconfig.get_model_config(name)
    assert list(tc.as_dict().items()) == list(dataclasses.asdict(jc).items())
    assert repr(tc) == repr(jc)


@pytest.mark.parametrize("name", ["deepseek-v2-lite", "tiny-deepseek-v2"])
def test_latent_config_dict_and_repr_keep_their_fields(name):
    """A latent-attention configuration keeps the port's own fields that
    differ from their defaults in its dict and repr, and only those."""
    tc = tconfig.get_model_config(name)
    full = dataclasses.asdict(tc)
    jax_fields = [f.name for f in dataclasses.fields(jconfig.ModelConfig)]
    own = {f.name: full[f.name] for f in dataclasses.fields(tconfig.ModelConfig)
           if f.name not in jax_fields and full[f.name] != f.default}
    assert {"kv_lora_rank", "qk_rope_head_dim", "n_routed_experts"} <= set(own)
    assert tc.as_dict() == {**{k: full[k] for k in jax_fields}, **own}
    assert repr(tc) == "ModelConfig(" + ", ".join(
        f"{k}={v!r}" for k, v in tc.as_dict().items()) + ")"
    assert all(f"{k}={v!r}" in repr(tc) for k, v in own.items())


@pytest.mark.parametrize("model", ["tiny-gpt2", "tiny-llama"])
@pytest.mark.parametrize("ber", [0.0, 1e-2])
@pytest.mark.parametrize("mode", MODES)
def test_forward_and_loss_match_jax(model, mode, ber):
    """registry.loss_and_stats (and forward, the same call) against JAX's,
    with labels that ignore a position: mean loss, count, logits and the
    stats dict (errors_corrected, errors_detected, bits_flipped,
    total_values)."""
    jc, tc, jp, tp = weights(model)
    ids = np.random.default_rng(0).integers(0, jc.vocab_size, (B, S))
    labels = ids.copy()
    labels[0, 5] = -100
    jpol, tpol = jkv.policy_for_mode(mode, ber=ber), tkv.policy_for_mode(mode, ber=ber)
    jmean, jcount, jlogits, jstats = jreg.loss_and_stats(jp, jnp.asarray(ids),
                                                         jnp.asarray(labels), jc, jpol)
    wm, rm = jax_masks(jpol, jc, (B, S))
    tmean, tcount, tlogits, tstats = treg.loss_and_stats(
        tp, torch.from_numpy(ids), torch.from_numpy(labels), tc, tpol, write_masks=wm,
        read_masks=rm)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tmean), float(jmean), rtol=1e-6)
    assert int(tcount) == int(jcount) == B * (S - 1) - 1
    assert ints(tstats) == ints(jstats)
    if ber > 0 and mode != "fp16":
        assert int(tstats["bits_flipped"]) > 0
    flogits, fstats = treg.forward(tp, ids, tc, tpol, write_masks=wm, read_masks=rm)
    assert torch.equal(flogits, tlogits) and ints(fstats) == ints(tstats)
    assert treg.forward_jit is treg.forward


def test_cross_entropy_matches_jax():
    """cross_entropy with ignore_index positions (a whole row ignored
    among them) against JAX's: the sum and the count; a batch with every
    target ignored gives (0, 0), and loss_and_stats' mean stays 0."""
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 9))
    labels[0, [2, 5]] = -100
    labels[2, :] = -100
    jt, jn = jreg.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    tt, tn = treg.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-6)
    assert tn.dtype == torch.int32 and int(tn) == int(jn) == 8 + 6
    none = np.full((2, 9), -100)
    tt, tn = treg.cross_entropy(torch.from_numpy(logits[:2]), torch.from_numpy(none))
    assert float(tt) == 0.0 and int(tn) == 0
    _, tc, _, tp = weights("tiny-gpt2")
    mean, count, _, _ = treg.loss_and_stats(tp, torch.zeros((2, 9), dtype=torch.long),
                                            torch.from_numpy(none), tc, tkv.KVCachePolicy())
    assert float(mean) == 0.0 and int(count) == 0


@pytest.mark.parametrize("mode", MODES)
def test_kv_roundtrip_matches_jax(mode):
    """kv_roundtrip of one K tensor [2, 24, 4, 16] (values past fp8's range
    among them) at BER 5e-2 with JAX's masks: the values read back equal
    bit for bit, the stats equal. Then encode_kv_pair_scrubbed on the same
    masks: codewords and scales equal."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(2, S, 4, 16)) * 10.0 ** rng.integers(-2, 3, (2, S, 4, 1))).astype(
        np.float32)
    jpol, tpol = jkv.policy_for_mode(mode, ber=5e-2), tkv.policy_for_mode(mode, ber=5e-2)
    key = jax.random.key(3)
    jout, jstats = jkv.kv_roundtrip(jnp.asarray(x), jpol, key, seq_axis=1)
    es = enc_shape(jpol.codec, x.shape[:-1], 16)
    mask = read = None
    if jpol.inject_at == "read":
        read = torch.from_numpy(np.asarray(flip_mask_for(jax.random.fold_in(key, READ), es,
                                                         5e-2, 4)).astype(np.int32))
    elif jpol.codec != "fp16":
        mask = torch.from_numpy(np.asarray(flip_mask_for(key, es, 5e-2,
                                                         jkv.N_BITS[jpol.codec])).astype(np.int32))
    tout, tstats = tkv.kv_roundtrip(torch.from_numpy(x), tpol, seq_axis=1, mask=mask,
                                    read_mask=read)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert ints(tstats) == ints(jstats) and int(tstats["total_values"]) == x.size
    if mode == "fp16":
        return
    # the write chain with the scrub folded in, a pair at once
    if mask is None:
        mask = torch.from_numpy(np.asarray(flip_mask_for(key, es, 5e-2, 4)).astype(np.int32))
    vx = x[::-1].copy()
    (jk, jks), (jv, jvs) = jkv.encode_kv_pair_scrubbed(
        jnp.asarray(x), jnp.asarray(vx), jpol, key, key, k_mask=jnp.asarray(mask.numpy()),
        v_mask=jnp.asarray(mask.numpy()))
    (tk, tks), (tv, tvs) = tkv.encode_kv_pair_scrubbed(torch.from_numpy(x), torch.from_numpy(vx),
                                                       tpol, k_mask=mask, v_mask=mask)
    for j, t in ((jk, tk), (jv, tv), (jks, tks), (jvs, tvs)):
        if j is None:
            assert t is None
            continue
        j = np.asarray(j)
        if t.dtype == torch.float8_e4m3fn:
            j, t = j.view(np.uint8), t.view(torch.uint8)
        np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("mode", ["int4", "int4-write-inject", "int4-hamming", "int4-hamming84",
                                  "int12-golay", "fp8"])
def test_process_kv_seeded_and_rates(mode):
    """process_kv without masks draws from (policy.seed, layer, K/V): the
    same seed and layer give the same K, V and stats, another seed or layer
    other flips; bits_flipped is within 5 sigma of BER x the bits written
    (read, for the int4 arm) over K and V; the stats add up K's and V's
    (kv_roundtrip with the same draws)."""
    pol = tkv.policy_for_mode(mode, ber=1e-2, seed=5)
    g = torch.Generator().manual_seed(0)
    k, v = (torch.randn((2, 64, 4, 64), generator=g) for _ in range(2))
    a = tkv.process_kv(k, v, pol, 3)
    b = tkv.process_kv(k, v, pol, 3)
    assert same(a[0], b[0]) and same(a[1], b[1]) and ints(a[2]) == ints(b[2])
    for other in (tkv.process_kv(k, v, pol.with_seed(6), 3), tkv.process_kv(k, v, pol, 4)):
        assert ints(other[2]) != ints(a[2]) or not same(other[0], a[0])
    codec = pol.codec
    n_bits = 4 if pol.inject_at == "read" else tkv.N_BITS[codec]
    n = 2 * np.prod(enc_shape(codec, k.shape[:-1], 64)) * n_bits
    flips = int(a[2]["bits_flipped"])
    assert abs(flips - 1e-2 * n) <= 5 * np.sqrt(n * 1e-2 * (1 - 1e-2)), (flips, n)
    assert int(a[2]["total_values"]) == 2 * k.numel()
    gk = torch.Generator().manual_seed(tkv.stream_seed(5, 3, 0))
    out, st = tkv.kv_roundtrip(k, pol, gk)
    assert same(out, a[0]) and int(st["bits_flipped"]) < flips
    zero = tkv.process_kv(k, v, tkv.policy_for_mode(mode), 3)[2]
    assert int(zero["bits_flipped"]) == 0 and int(zero["errors_corrected"]) == 0


def test_layer_norm_and_empty_stats():
    """layer_norm against JAX's (float32, rtol 1e-5 / atol 1e-6 for the
    order of the sums); empty_stats and merge_stats as JAX's."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    g, b = rng.normal(size=(2, 48)).astype(np.float32)
    np.testing.assert_allclose(
        tl.layer_norm(*(torch.from_numpy(a) for a in (x, g, b)), 1e-5).numpy(),
        np.asarray(jl.layer_norm(*(jnp.asarray(a) for a in (x, g, b)), 1e-5)), rtol=1e-5,
        atol=1e-6)
    assert ints(tkv.empty_stats()) == ints(jkv.empty_stats())
    one = {k: torch.tensor(i + 1, dtype=torch.int32) for i, k in enumerate(tkv.empty_stats())}
    assert ints(tkv.merge_stats(tkv.merge_stats(None, one), one)) == {
        k: 2 * v for k, v in ints(one).items()}


@pytest.mark.parametrize("model", ["tiny-gpt2", "tiny-llama", "trained-tiny"])
def test_init_params_layout(model):
    """init_params gives JAX's tree: the same keys, shapes and dtypes, and
    (gpt2) JAX's stds: 0.02, 0.01 for wpe, 0.02 / sqrt(2 L) for c_proj and
    mlp_proj (within 5%), norms 1 and biases 0. params_from_jax converts
    either tree (llama.params_from_jax delegates to it) and refuses a
    wrong depth."""
    jc, tc = jconfig.get_model_config(model), tconfig.get_model_config(model)
    jp = jax.tree.map(np.asarray, jreg.init_params(jc, 0))
    tp = treg.init_params(tc, seed=0, device="cpu")
    jl_, jdef = jax.tree_util.tree_flatten(jp)
    tl_, tdef = jax.tree_util.tree_flatten(jax.tree.map(lambda t: t.numpy(), tp))
    assert jdef == tdef
    assert [(a.shape, a.dtype) for a in jl_] == [(a.shape, a.dtype) for a in tl_]
    if tc.arch == "gpt2":
        want = {"wte": 0.02, "wpe": 0.01}
        for name, std in want.items():
            assert abs(float(tp[name].std()) / std - 1) < 0.05, name
        out = 0.02 / np.sqrt(2 * tc.num_layers)
        lp = tp["layers"][0]
        for name, std in (("c_attn", 0.02), ("c_fc", 0.02), ("c_proj", out), ("mlp_proj", out)):
            assert abs(float(lp[name]["w"].std()) / std - 1) < 0.05, name
            assert not lp[name]["b"].any()
        assert bool((lp["ln_1"]["g"] == 1).all()) and not lp["ln_2"]["b"].any()
    conv = treg.params_from_jax(jp, tc, device="cpu")
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(
        jl_, jax.tree_util.tree_leaves(conv)))
    if tc.arch == "llama":
        same = tllama.params_from_jax(jp, tc, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(same),
                                                     jax.tree_util.tree_leaves(conv)))
    with pytest.raises(ValueError, match="layers given"):
        treg.params_from_jax(jp, dataclasses.replace(tc, num_layers=tc.num_layers + 1),
                             device="cpu")


def test_sampled_generate():
    """generate(temperature > 0, seed) on tiny-gpt2 (int4-hamming84, BER
    1e-2): the same tokens twice for one seed and other tokens for another;
    at temperature 1e-6 the greedy tokens; and the first sampled token of
    4000 rows of one prompt at temperature 1.5, against the softmax of the
    prompt's logits / 1.5 by a chi-square test (bins with an expected
    count below 5 pooled) at the 1e-3 level. The server's per-row sampler
    is the same function (runtime.sample_tokens)."""
    _, tc, _, tp = weights("tiny-gpt2")
    pol = tkv.policy_for_mode("int4-hamming84", ber=1e-2, seed=3)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, tc.vocab_size, (2, 12)))

    def gen(temperature, seed, rows=ids, new=6):
        return tr.generate(tp, rows, tc, pol, new, 16, temperature, seed, device="cpu")

    a, b, c = gen(0.8, 1), gen(0.8, 1), gen(0.8, 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :12], ids)
    assert torch.equal(gen(1e-6, 1), gen(0.0, 1))
    n, temp = 4000, 1.5
    pol0 = tkv.policy_for_mode("int4-hamming84")
    rows = ids[:1].expand(n, -1).contiguous()
    state, bt, _ = tr.init_generation_state(tc, pol0, 1, 13, 16, device="cpu")
    logits, _ = tr.prefill(tp, ids[:1], state, bt, tc, pol0)
    p = torch.softmax(logits[0].double() / temp, dim=-1).numpy()
    drawn = tr.generate(tp, rows, tc, pol0, 1, 16, temp, 7, device="cpu")[:, -1].numpy()
    counts = np.bincount(drawn, minlength=tc.vocab_size)
    expected = n * p
    big = expected >= 5
    obs, exp = counts[big], expected[big]
    if not big.all():
        obs, exp = np.append(obs, counts[~big].sum()), np.append(exp, expected[~big].sum())
    pvalue = sps.chisquare(obs, exp).pvalue
    assert pvalue > 1e-3, pvalue
    assert big.sum() > 50  # the test has bins to work with
