"""The port's Monte-Carlo quality path (qkv_ecc_tpu_torch.evaluation:
constants, data, models, metrics, sweep, latex_tables, verification, the
CLI; qkv_ecc_tpu_torch.training's checkpoint and tokenizer loading)
against the JAX package on the same inputs.

Where a comparison runs both models at BER > 0 it feeds the port the very
masks JAX draws (tests/test_torch_models.py's ``jax_masks``), so both see
the same flips. No JAX function that could reach the network runs here (its
WikiText loader, its HF tokenizer and checkpoint branches): the port's
offline results are held to what those JAX functions return offline.

Tolerances, with their reasons:
  * integers, strings, tables, reports, JSON files and the aggregation of
    equal trials (inf and NaN included): equal;
  * parameters loaded from the checkpoint: equal; the forward on them
    within the M16 tolerance (rtol 1e-5, atol 1e-5, float32 matmuls summed
    in other orders), its atol taken relative to the largest |logit| (about
    10 on trained-tiny, whose logits are some ten times those of the random
    tiny models M16 tests; measured: 2.0e-5 on 2 of 12288 logits near 0),
    on 24-token rows of text, where no K/V value lands on another code;
  * KL on equal logits: rtol 1e-6 (float32 log-softmax);
  * the sweep against JAX's at max_length 64 with JAX's masks: perplexity
    within 2e-3 and KL within 2e-2 relative, top-5 within one target in a
    hundred, every other field (the counts among them) equal. A forward
    rounds K/V to bfloat16, e4m3 or INT4 codes, so an ulp of difference in
    a projection can move a value to the neighbouring code; measured on
    these inputs: 5.6e-4 in perplexity and 4.7e-3 in KL (both at BER 0,
    1.786532 against 1.785529 and 0.0155886 against 0.0156619), the top-5
    shares equal;
  * the CLI at the TPU run's config, BER 0, against that run's
    perplexities: 5e-3 relative. JAX on this CPU differs from the TPU run
    by up to 2.06e-3 relative (int4's 2.194447 against 2.189945; the TPU's
    float32 matmuls round through bfloat16 passes), and the port from JAX
    on the CPU by at most 9e-5.
"""

import dataclasses
import json
import math
import os
import shutil

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# belt and braces: nothing below may reach the network
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("HF_DATASETS_OFFLINE", "1")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.evaluation import constants as jconst  # noqa: E402
from qkv_ecc_tpu.evaluation import data as jdata  # noqa: E402
from qkv_ecc_tpu.evaluation import latex_tables as jlt  # noqa: E402
from qkv_ecc_tpu.evaluation import metrics as jmetrics  # noqa: E402
from qkv_ecc_tpu.evaluation import models as jmodels  # noqa: E402
from qkv_ecc_tpu.evaluation import sweep as jsweep  # noqa: E402
from qkv_ecc_tpu.evaluation import verification as jver  # noqa: E402
from qkv_ecc_tpu.evaluation.experiments import monte_carlo as jmc  # noqa: E402
from qkv_ecc_tpu.models import config as jconfig  # noqa: E402
from qkv_ecc_tpu.models import kv_policy as jkv  # noqa: E402
from qkv_ecc_tpu.models import registry as jreg  # noqa: E402
from qkv_ecc_tpu.training import corpus as jcorpus  # noqa: E402
from qkv_ecc_tpu.training import trainer as jtrainer  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import constants as tconst  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import data as tdata  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import latex_tables as tlt  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import metrics as tmetrics  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import models as tmodels  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import sweep as tsweep  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import verification as tver  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import monte_carlo as tmc  # noqa: E402
from qkv_ecc_tpu_torch.models import config as tconfig  # noqa: E402
from qkv_ecc_tpu_torch.models import kv_policy as tkv  # noqa: E402
from qkv_ecc_tpu_torch.models import registry as treg  # noqa: E402
from qkv_ecc_tpu_torch.training import WordTokenizer, load_params  # noqa: E402
from tests.test_torch_models import jax_masks  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "trained_tiny", "checkpoint.npz")
TPU_RUN = os.path.join(ROOT, "results", "trained_tiny_tpu")
SWEEP_TOL = {"perplexity": 2e-3, "kl_divergence": 2e-2}
TOP5_TOL = 1e-2
TPU_BER0_TOL = 5e-3


def eval_texts():
    with open(CKPT + ".eval_texts.json") as fh:
        return json.load(fh)


def same(a, b):
    """Equal, NaN equal to NaN, through nested dicts and lists."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b and type(a) is type(b)


# -- constants and data -------------------------------------------------------


def test_constants_copied():
    """The cache modes, labels, BER levels, defaults and model table are
    JAX's, in JAX's order; the model table without its TPU chip entries."""
    for name in ("CACHE_MODES", "CACHE_MODE_ORDER", "CACHE_MODE_LABELS", "BER_LEVELS",
                 "BER_LEVELS_EXTENDED", "DEFAULT_CONFIG", "DEFAULT_MODEL"):
        assert same(getattr(tconst, name), getattr(jconst, name)), name
        assert list(getattr(tconst, name)) == list(getattr(jconst, name)), name
    assert list(tconst.MODELS) == list(jconst.MODELS)
    for name, meta in jconst.MODELS.items():
        assert tconst.MODELS[name] == {k: v for k, v in meta.items() if k != "chip"}, name
    assert tconst.MODE_CONFIG is tkv.MODE_CONFIG


@pytest.mark.parametrize("mode", list(jkv.MODE_CONFIG) + ["int8"])
def test_mode_config_matches_jax(mode):
    if mode not in jkv.MODE_CONFIG:
        msgs = []
        for module in (jconst, tconst):
            with pytest.raises(ValueError) as err:
                module.get_mode_config(mode)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        return
    assert tconst.get_mode_config(mode) == jconst.get_mode_config(mode)


def test_mode_lists_match_jax():
    for flag in (False, True):
        assert tconst.get_cache_modes(flag) == jconst.get_cache_modes(flag)
        assert tconst.get_ber_levels(flag) == jconst.get_ber_levels(flag)
    assert tconst.get_seeds() == jconst.get_seeds()


@pytest.mark.parametrize("n,per,seed", [(20, 12, 0), (5, 3, 7)])
def test_synthetic_corpus_matches_jax(n, per, seed):
    """The synthetic texts, text for text; load_wikitext2_test is what JAX's
    returns offline, synthetic_corpus(max_samples)."""
    assert tdata._FALLBACK_SENTENCES == jdata._FALLBACK_SENTENCES
    assert tdata.synthetic_corpus(n, per, seed) == jdata.synthetic_corpus(n, per, seed)
    assert tdata.load_wikitext2_test(n) == jdata.synthetic_corpus(n)


def word_tokenizers(tmp_path):
    """JAX's WordTokenizer trained on the eval texts and saved, then loaded
    by both packages."""
    path = str(tmp_path / "vocab.json")
    jcorpus.WordTokenizer.train("\n".join(eval_texts()[:4]), vocab_size=300).save(path)
    return jcorpus.WordTokenizer.load(path), WordTokenizer.load(path)


@pytest.mark.parametrize("tok", ["byte", "word"])
def test_tokenize_and_pad_match_jax(tok, tmp_path):
    """tokenize (both tokenizer flavours, with and without max_length),
    pad_to_bucket and the tokenizers' decode and __call__."""
    if tok == "byte":
        jt, tt = jdata.ByteTokenizer(), tdata.ByteTokenizer()
        assert type(tdata.get_tokenizer("gpt2", "gpt2")) is tdata.ByteTokenizer
    else:
        jt, tt = word_tokenizers(tmp_path)
        assert tt.vocab_size == jt.vocab_size
    texts = eval_texts()[4:6] + ["naïve café ✓ 1\n2", "x", ""]
    for text in texts:
        for max_length in (None, 7, 64):
            ji, ti = jdata.tokenize(jt, text, max_length), tdata.tokenize(tt, text, max_length)
            assert ji.dtype == ti.dtype and np.array_equal(ji, ti)
            for bucket in (32, 16):
                for a, b in zip(jdata.pad_to_bucket(ji, bucket), tdata.pad_to_bucket(ti, bucket)):
                    assert np.array_equal(a, b)
            assert tt.decode(ti[0]) == jt.decode(ji[0])
            assert tt(text, truncation=True, max_length=max_length) == jt(
                text, truncation=True, max_length=max_length)


# -- checkpoint and model loading ---------------------------------------------


def leaves(tree, path=()):
    """{"/"-joined path: tensor} of a port parameter tree."""
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items() for k, v in leaves(sub, path + (name,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree) for k, v in leaves(sub, path + (str(i),)).items()}
    return {"/".join(path): tree}


@pytest.fixture(scope="module")
def trained_tiny():
    """(JAX config, port config, JAX params, port params) of trained-tiny."""
    jc, tc = jconfig.get_model_config("trained-tiny"), tconfig.get_model_config("trained-tiny")
    return jc, tc, jtrainer.load_params(CKPT, jc), load_params(CKPT, tc, device="cpu")


def test_load_params_matches_jax(trained_tiny):
    """Every leaf equal to JAX's load_params (same tree, dtype and bits), and
    the forward on them within the M16 tolerance."""
    jc, tc, jp, tp = trained_tiny
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = leaves(tp)
    assert len(jleaves) == len(tleaves) == 4 + 12 * tc.num_layers
    for kp, arr in jleaves:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        assert tleaves[key].dtype == torch.float32, key
        assert np.array_equal(tleaves[key].numpy(), np.asarray(arr)), key
    # two rows of text the model knows (the first 24 bytes of two eval
    # texts); random bytes drive it far out of its range, where an ulp moves
    # a K/V value to another code
    ids = np.stack([tdata.tokenize(tdata.ByteTokenizer(), t, 24)[0] for t in eval_texts()[:2]])
    for mode in ("int4-hamming84", "int12-golay"):
        jl, _, jlog, _ = jreg.loss_and_stats(jp, jnp.asarray(ids), jnp.asarray(ids), jc,
                                             jkv.policy_for_mode(mode))
        tl, _, tlog, _ = treg.loss_and_stats(tp, ids, ids, tc, tkv.policy_for_mode(mode))
        scale = float(np.abs(np.asarray(jlog)).max())  # about 10 here
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_load_params_checks_shapes(tmp_path, trained_tiny):
    """A checkpoint whose array has another shape than its leaf is refused
    by both (JAX asserts, the port raises ValueError naming the key)."""
    with np.load(CKPT) as loaded:
        arrays = dict(loaded)
    arrays["layers/2/c_fc/b"] = arrays["layers/2/c_fc/b"][:-1]
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **arrays)
    with pytest.raises(AssertionError):
        jtrainer.load_params(bad, trained_tiny[0])
    with pytest.raises(ValueError, match="layers/2/c_fc/b"):
        load_params(bad, trained_tiny[1], device="cpu")


def test_load_model_matches_jax(monkeypatch, tmp_path, trained_tiny):
    """load_model: trained-tiny from its checkpoint; a missing checkpoint
    (QKV_TINY_CHECKPOINT) gives random weights or, required, raises in both;
    a random-init config without allow_random_init raises in both; the
    port's HF branch raises without allow_random_init (JAX's does so
    offline) and takes random weights with it. get_model_info and
    estimate_param_count equal."""
    tp = trained_tiny[3]
    params, cfg, tok = tmodels.load_model("trained-tiny", device="cpu")
    assert cfg == trained_tiny[1] and type(tok) is tdata.ByteTokenizer
    want = leaves(tp)
    assert all(torch.equal(t, want[k]) for k, t in leaves(params).items())
    monkeypatch.setenv("QKV_TINY_CHECKPOINT", str(tmp_path / "missing.npz"))
    params, _, _ = tmodels.load_model("trained-tiny", device="cpu")
    assert params["wte"].shape == tp["wte"].shape and not torch.equal(params["wte"], tp["wte"])
    for module, kw in ((jmodels, {}), (tmodels, {"device": "cpu"})):
        with pytest.raises(RuntimeError, match="checkpoint not found"):
            module.load_model("trained-tiny", allow_random_init=False, **kw)
        with pytest.raises(RuntimeError, match="No checkpoint available for tiny-gpt2"):
            module.load_model("tiny-gpt2", allow_random_init=False, **kw)
        with pytest.raises(ValueError, match="Unknown model"):
            module.load_model("gpt5", **kw)
    with pytest.raises(RuntimeError, match="Could not load HF checkpoint 'gpt2'"):
        tmodels.load_model("gpt2", allow_random_init=False, device="cpu")
    params, cfg, tok = tmodels.load_model("gpt2", device="cpu")
    assert cfg.name == "gpt2" and params["wte"].shape == (50257, 768)
    assert type(tok) is tdata.ByteTokenizer
    for name, meta in jconst.MODELS.items():
        assert tmodels.get_model_info(name) == {k: v for k, v in meta.items() if k != "chip"}
        cfg = tconfig.get_model_config(meta["config"])
        assert tmodels.estimate_param_count(cfg) == jmodels.estimate_param_count(
            jconfig.get_model_config(meta["config"]))


# -- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("seq_len,max_length,stride", [
    (2000, 256, 128), (300, 64, 128), (100, 64, 32), (64, 64, 64), (1, 8, 4), (0, 8, 4)])
def test_text_windows_match_jax(seq_len, max_length, stride):
    ids = np.arange(seq_len, dtype=np.int32)[None, :]
    jw = list(jmetrics._text_windows(ids, max_length, stride))
    tw = list(tmetrics._text_windows(ids, max_length, stride))
    assert len(jw) == len(tw)
    for (a, b, c), (x, y, z) in zip(jw, tw):
        assert np.array_equal(a, x) and np.array_equal(b, y) and c == z


@pytest.mark.parametrize("temperature", [1.0, 2.0])
def test_kl_divergence_matches_jax(temperature):
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(40, 256)).astype(np.float32) * 3 for _ in range(2))
    np.testing.assert_allclose(tmetrics.compute_kl_divergence(a, b, temperature),
                               jmetrics.compute_kl_divergence(a, b, temperature), rtol=1e-6)
    assert tmetrics.compute_kl_divergence(a, a) == 0.0


def test_catastrophic_rate_matches_jax():
    for ppls in ([], [1.0, 2.0], [1.0, 1e4, float("inf"), 3.0], [float("inf")] * 3):
        for th in (1000.0, 2.5):
            assert tmetrics.compute_catastrophic_rate(ppls, th) == \
                jmetrics.compute_catastrophic_rate(ppls, th)


def fake_logits(ids, vocab=256):
    """Logits made from each row of ids alone: normals seeded by the row's
    sum, all NaN for a third of the rows' seeds, a tie at the fifth place
    in some positions."""
    out = []
    for row in np.asarray(ids):
        rng = np.random.default_rng(int(row.sum()) % 1000)
        x = rng.normal(size=(len(row), vocab)).astype(np.float32)
        if int(row.sum()) % 3 == 0:
            x[3::11] = np.nan
        order = np.argsort(-x[5::13], axis=-1)
        tie = x[5::13]
        np.put_along_axis(tie, order[..., 5:6], np.take_along_axis(tie, order[..., 4:5], -1), -1)
        x[5::13] = tie
        x[:, row[0] % vocab] += 4.0
        out.append(x)
    return np.stack(out)


def test_metrics_on_the_same_logits_match_jax(monkeypatch):
    """compute_top5_accuracy, generate_clean_logits, compute_mean_kl_divergence,
    compute_perplexity and compute_per_sample_perplexity with both packages'
    forwards replaced by the same function of each row of ids (JAX's
    loss_and_stats by the cross entropy of those logits). Its logits hold
    all-NaN rows, whose losses both skip, and ties at the fifth place, on
    which top5_indices takes the indices jax.lax.top_k takes (torch.topk
    would not): the hits equal, the losses within rtol 1e-6."""
    def jfwd(params, ids, cfg, policy):
        return jnp.asarray(fake_logits(ids)), {}

    def jloss(params, ids, labels, cfg, policy):
        total, count = jreg.cross_entropy(jnp.asarray(fake_logits(ids)), jnp.asarray(labels))
        return total / jnp.maximum(count, 1), count, None, {}

    def tfwd(params, ids, cfg, policy, write_masks=None, read_masks=None):
        assert write_masks is None and read_masks is None  # BER 0
        return torch.from_numpy(fake_logits(ids)), {}

    monkeypatch.setattr(jmetrics, "forward_jit", jfwd)
    monkeypatch.setattr(jmetrics, "loss_and_stats", jloss)
    monkeypatch.setattr(tmetrics, "forward_jit", tfwd)
    tok, pol = tdata.ByteTokenizer(), tkv.policy_for_mode("int4")
    cfg, params = tconfig.get_model_config("trained-tiny"), {"wte": torch.zeros(1)}
    texts = [t[:n] for t, n in zip(eval_texts()[:6], (300, 150, 64, 1, 700, 90))] + ["  "]
    for max_length in (64, 256):
        j5 = jmetrics.compute_top5_accuracy(None, None, None, tok, texts, max_length)
        t5 = tmetrics.compute_top5_accuracy(params, cfg, pol, tok, texts, max_length)
        assert t5 == j5 and 0 < t5 < 1
        jclean = jmetrics.generate_clean_logits(None, None, tok, texts, max_length)
        tclean = tmetrics.generate_clean_logits(params, cfg, tok, texts, max_length)
        assert [c is None for c in jclean] == [c is None for c in tclean]
        for a, b in zip(jclean, tclean):
            assert a is None or np.array_equal(a, b.numpy(), equal_nan=True)
        shifted = [None if c is None else np.roll(c, 1, axis=-1) for c in jclean]
        jkl = jmetrics.compute_mean_kl_divergence(None, None, None, tok, texts, shifted,
                                                  max_length)
        tkl = tmetrics.compute_mean_kl_divergence(
            params, cfg, pol, tok, texts, [None if c is None else torch.from_numpy(c)
                                           for c in shifted], max_length)
        assert jkl > 0
        np.testing.assert_allclose(tkl, jkl, rtol=1e-6)
        for stride in (32, 128):
            np.testing.assert_allclose(
                tmetrics.compute_perplexity(params, cfg, pol, tok, texts, max_length, stride),
                jmetrics.compute_perplexity(None, None, None, tok, texts, max_length, stride),
                rtol=1e-6)
            tp = tmetrics.compute_per_sample_perplexity(params, cfg, pol, tok, texts, max_length,
                                                        stride)
            jp = jmetrics.compute_per_sample_perplexity(None, None, None, tok, texts, max_length,
                                                        stride)
            assert [math.isinf(x) for x in tp] == [math.isinf(x) for x in jp]
            assert any(math.isinf(x) for x in jp[:-1])  # a text whose windows are all NaN
            np.testing.assert_allclose([x for x in tp if math.isfinite(x)],
                                       [x for x in jp if math.isfinite(x)], rtol=1e-6)
    rows = torch.from_numpy(fake_logits(np.arange(64)[None]))[0]
    want = np.asarray(jax.lax.top_k(jnp.asarray(rows.numpy()), 5)[1])
    assert np.array_equal(tmetrics.top5_indices(rows).numpy(), want)


@pytest.mark.parametrize("mode", ["int4", "int4-hamming84", "int12-golay", "fp8"])
def test_forward_rows_is_the_per_row_forward(mode):
    """forward_masks draws what process_kv draws (a forward given them
    equals one drawing its own, bit for bit), and forward_rows runs rows of
    one length as one batch that gives each row those flips: each row's
    logits as its own forward's (within rtol 1e-5, atol 1e-5: a batch's
    matmuls sum in other orders), the counts B times a row's."""
    cfg = tconfig.get_model_config("tiny-gpt2")
    params = treg.init_params(cfg, 0, device="cpu")
    pol = tkv.policy_for_mode(mode, ber=1e-2, seed=7)
    rows = [np.random.default_rng(i).integers(0, cfg.vocab_size, (1, 32)) for i in range(3)]
    wm, rm = tkv.forward_masks(pol, cfg.num_layers, (1, 32, cfg.num_kv_heads, cfg.head_dim),
                               "cpu")
    singles = []
    for r in rows:
        own, own_stats = treg.forward(params, r, cfg, pol)
        given, given_stats = treg.forward(params, r, cfg, pol, write_masks=wm, read_masks=rm)
        assert torch.equal(own.isnan(), given.isnan())
        assert torch.equal(own.nan_to_num(), given.nan_to_num())
        assert {k: int(v) for k, v in own_stats.items()} == \
            {k: int(v) for k, v in given_stats.items()}
        singles.append((own[0], {k: int(v) for k, v in own_stats.items()}))
    assert singles[0][1]["bits_flipped"] > 0
    (idx, logits, losses, stats), = tmetrics.forward_rows(params, cfg, pol, rows, rows)
    assert idx == [0, 1, 2] and len(losses) == 3
    for j, (own, own_stats) in enumerate(singles):
        np.testing.assert_allclose(logits[j].numpy(), own.numpy(), rtol=1e-5, atol=1e-5)
    assert {k: int(v) for k, v in stats.items()} == {k: 3 * v for k, v in singles[0][1].items()}


# -- aggregation and tables ---------------------------------------------------


def trial_sets():
    inf = float("inf")
    base = dict(cache_mode="int4-hamming84", ber=1e-2, errors_corrected=10, errors_detected=2,
                total_values=100, kl_divergence=0.1, top5_accuracy=0.9, injection_count=12,
                bits_flipped=30, correction_rate=10 / 12, detection_rate=2 / 12)
    vary = [dict(seed=42, perplexity=2.5), dict(seed=101, perplexity=2.75, errors_corrected=13,
                                               kl_divergence=0.2, catastrophic_rate=0.05),
            dict(seed=997, perplexity=2.25, top5_accuracy=0.85, encode_time_ms=1.5)]
    return {
        "finite": [dict(base, **v) for v in vary],
        "one_inf": [dict(base, **v) for v in vary[:2]] + [dict(base, seed=997, perplexity=inf)],
        "all_inf": [dict(base, seed=s, perplexity=inf, catastrophic_rate=1.0)
                    for s in (42, 101, 997)],
        "single": [dict(base, **vary[0])],
    }


@pytest.mark.parametrize("name", ["finite", "one_inf", "all_inf", "single"])
def test_aggregated_result_matches_jax(name):
    """AggregatedResult.from_trials on the same trials: every field equal,
    an infinite perplexity's inf mean and NaN std and CI included."""
    trials = trial_sets()[name]
    jagg = jsweep.AggregatedResult.from_trials([jsweep.TrialResult(**t) for t in trials])
    tagg = tsweep.AggregatedResult.from_trials([tsweep.TrialResult(**t) for t in trials])
    assert same(dataclasses.asdict(tagg), dataclasses.asdict(jagg))
    if name != "finite" and name != "single":
        assert math.isinf(tagg.ppl_mean) and math.isnan(tagg.ppl_std)
    t = tsweep.TrialResult(**trials[0])
    assert t.computed_correction_rate == jsweep.TrialResult(**trials[0]).computed_correction_rate
    with pytest.raises(ValueError, match="empty"):
        tsweep.AggregatedResult.from_trials([])


def test_t_critical_matches_jax():
    for df in range(1, 130):
        assert tsweep._t_critical_95(df) == jsweep._t_critical_95(df)


def tpu_results(module):
    """The TPU run's trials and aggregates rebuilt as `module`'s
    SweepResults, each BER keyed by the value the run aggregated it under
    (0 an int, as BER_LEVELS holds it)."""
    with open(os.path.join(TPU_RUN, "monte_carlo_results.json")) as fh:
        raw = json.load(fh)
    res = module.SweepResults(config=module.SweepConfig())
    res.trials = [module.TrialResult(**t) for t in raw["trials"]]
    for mode, by_ber in raw["aggregated"].items():
        for agg in by_ber.values():
            res.aggregated.setdefault(mode, {})[agg["ber"]] = module.AggregatedResult(**agg)
    return raw, res


def test_tables_match_jax():
    """The seven LaTeX formatters and the ASCII table on the TPU run's
    results, rebuilt in each package: equal strings (its infinite and NaN
    cells included), and the TPU run's own results_table.txt."""
    _, jres = tpu_results(jsweep)
    _, tres = tpu_results(tsweep)
    calls = [
        lambda m, r: m.format_perplexity_table(r),
        lambda m, r: m.format_perplexity_table(r, ber_levels=[0, 1e-2], caption="PPL."),
        lambda m, r: m.format_storage_overhead_table(),
        lambda m, r: m.format_throughput_table(),
        lambda m, r: m.format_throughput_table([dict(codec="golay", encode_mvals=812.4,
                                                     decode_mvals=455.0, bw_eff=12.25)]),
        lambda m, r: m.format_correction_rate_table(r),
        lambda m, r: m.format_correction_rate_table(r, ber=1e-3),
        lambda m, r: m.format_error_stats_table(r),
        lambda m, r: m.format_metric_table(r, "kl_divergence_std", "KL std.", fmt="{:.6f}"),
        lambda m, r: m.format_all_latex_tables(r),
    ]
    for call in calls:
        assert call(tlt, tres) == call(jlt, jres)
    table = tmc.format_results_table(tres)
    assert table == jmc.format_results_table(jres)
    with open(os.path.join(TPU_RUN, "results_table.txt")) as fh:
        assert table == fh.read()


def test_save_results_matches_jax(tmp_path):
    """save_results on the TPU run's results: the same files, byte for byte
    (the JSON's Infinity and NaN and its BER keys: "0" for the int 0)."""
    raw, jres = tpu_results(jsweep)
    _, tres = tpu_results(tsweep)
    outs = {}
    for name, module, res in (("jax", jmc, jres), ("torch", tmc, tres)):
        cfg = module.MonteCarloConfig(model="trained-tiny", output_dir=str(tmp_path / name),
                                      **{k: raw["config"][k] for k in (
                                          "cache_modes", "ber_levels", "seeds", "max_samples",
                                          "max_length", "stride")})
        outs[name] = module.save_results(res, cfg)
    assert outs["torch"] == outs["jax"]
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 8
    for f in files:
        with open(tmp_path / "jax" / f, "rb") as a, open(tmp_path / "torch" / f, "rb") as b:
            assert a.read() == b.read(), f
    with open(tmp_path / "torch" / "monte_carlo_results.json") as fh:
        assert same(json.load(fh), raw)


def test_verification_report_matches_jax():
    """run_all_verifications: the same checks, counts and report text."""
    jrep, trep = jver.run_all_verifications(), tver.run_all_verifications()
    assert trep.checks == jrep.checks and trep.all_passed
    assert {k: dataclasses.asdict(v) for k, v in trep.amplification.items()} == \
        {k: dataclasses.asdict(v) for k, v in jrep.amplification.items()}
    assert trep.format() == jrep.format()
    assert tver.gf2_rank(np.eye(5, dtype=np.uint8)[[0, 1, 1, 3]]) == 3


# -- the sweep ----------------------------------------------------------------


def jax_forward_masks(cfg, cache):
    """kv_policy.forward_masks for the sweep's forward_rows, giving JAX's
    masks for the policy and one row of the shape instead."""
    def draw(policy, num_layers, shape, device):
        key = (policy, tuple(shape))
        if key not in cache:
            cache[key] = jax_masks(jkv.KVCachePolicy(**dataclasses.asdict(policy)), cfg,
                                   tuple(shape[:2]))
        return cache[key]
    return draw


def test_sweep_matches_jax(monkeypatch, trained_tiny):
    """run_sweep on trained-tiny (3 texts of 320 characters, max_length 64,
    stride 32; KL, top-5 and catastrophic on) in int4 (read flips) and
    int4-hamming84 (write flips) at BER 0 and 1e-2, the port given JAX's
    masks: every trial field within the module's tolerances, the counts
    equal. No top-5 tie occurs on these inputs (checked below)."""
    jc, tc, jp, tp = trained_tiny
    texts = [t[:320] for t in eval_texts()[:3]]
    tok = tdata.ByteTokenizer()
    monkeypatch.setattr(tmetrics, "forward_masks", jax_forward_masks(jc, {}))
    kw = dict(cache_modes=["int4", "int4-hamming84"], ber_levels=[0, 1e-2], seeds=[42],
              max_length=64, stride=32)
    jclean = jmetrics.generate_clean_logits(jp, jc, tok, texts, max_length=64)
    tclean = tmetrics.generate_clean_logits(tp, tc, tok, texts, max_length=64)
    jres = jsweep.run_sweep(jp, jc, tok, texts, jsweep.SweepConfig(clean_logits=jclean, **kw))
    tres = tsweep.run_sweep(tp, tc, tok, texts, tsweep.SweepConfig(clean_logits=tclean, **kw))
    assert len(tres.trials) == len(jres.trials) == 4
    for jt, tt in zip(jres.trials, tres.trials):
        j, t = dataclasses.asdict(jt), dataclasses.asdict(tt)
        assert j.keys() == t.keys()
        for k in j:
            if k in ("perplexity", "kl_divergence"):
                np.testing.assert_allclose(t[k], j[k], rtol=SWEEP_TOL[k], err_msg=k)
            elif k == "top5_accuracy":
                assert abs(t[k] - j[k]) <= TOP5_TOL, k
            else:
                assert t[k] == j[k], (jt.cache_mode, jt.ber, k)
        if jt.ber:
            assert t["bits_flipped"] > 0
    for mode, by_ber in jres.aggregated.items():
        assert tres.aggregated[mode].keys() == by_ber.keys()
    # no tie at the fifth place occurred in these top-5 passes, so the hits
    # cannot depend on how a tie is broken (ties: the same-logits test)
    for mode in kw["cache_modes"]:
        for ber in kw["ber_levels"]:
            pol = tkv.policy_for_mode(mode, ber=ber, seed=42)
            for _, _, logits in tmetrics._text_logits(tp, tc, pol, tok, texts, 64, 2):
                top = torch.sort(logits[:-1], dim=-1, descending=True).values
                assert not (top[:, 4] == top[:, 5]).any(), (mode, ber)


def test_trial_timing_fields():
    """enable_timing fills the codec's encode/decode times and the upload
    share for a packed codec (CPU: host clock) and nothing for the float
    ones; the fields are TrialResult's."""
    cfg = tconfig.get_model_config("tiny-gpt2")
    sc = tsweep.SweepConfig(enable_timing=True, max_length=32)
    out = tsweep._measure_trial_timing(cfg, tkv.policy_for_mode("int4-hamming84", 1e-2), sc,
                                       torch.device("cpu"))
    assert set(out) == {"encode_time_ms", "decode_time_ms", "throughput_mvalues_sec",
                        "transfer_overhead_pct", "is_cpu_bound"}
    assert out["encode_time_ms"] > 0 and out["decode_time_ms"] > 0
    assert set(out) <= {f.name for f in dataclasses.fields(tsweep.TrialResult)}
    assert tsweep._measure_trial_timing(cfg, tkv.policy_for_mode("fp8", 1e-2), sc, "cpu") == {}


def test_checkpoint_resume(monkeypatch, tmp_path):
    """A sweep resumes from its JSONL checkpoint: finished trials are read
    back equal and not rerun; a record of another config (fingerprint) or
    without one is not reused; the fingerprint is JAX's, so a JAX record of
    the same experiment is read too. run_sweep_single_seed keys its trials
    by mode and BER."""
    cfg = tconfig.get_model_config("tiny-gpt2")
    params = treg.init_params(cfg, 0, device="cpu")
    texts = tdata.synthetic_corpus(2, 2)
    tok = tdata.ByteTokenizer()
    path = str(tmp_path / "sweep_checkpoint.jsonl")

    def config(**kw):
        return tsweep.SweepConfig(cache_modes=["int4-hamming84"], ber_levels=[0, 1e-2],
                                  seeds=[42], max_length=32, compute_kl_divergence=False,
                                  compute_top5=False, checkpoint_path=path, **kw)

    first = tsweep.run_sweep(params, cfg, tok, texts, config())
    with open(path) as fh:
        assert len(fh.readlines()) == 2
    fp = config().fingerprint(model_cfg=cfg, texts=texts)
    assert fp == jsweep.SweepConfig(max_length=32).fingerprint(
        model_cfg=jconfig.get_model_config("tiny-gpt2"), texts=texts)
    calls = []
    real = tsweep.run_single_trial

    def spy(*a, **k):
        calls.append(a[4:7])
        return real(*a, **k)

    monkeypatch.setattr(tsweep, "run_single_trial", spy)
    again = tsweep.run_sweep(params, cfg, tok, texts, config())
    assert calls == []
    assert [dataclasses.asdict(t) for t in again.trials] == \
        [dataclasses.asdict(t) for t in first.trials]
    assert same(dataclasses.asdict(again.aggregated["int4-hamming84"][1e-2]),
                dataclasses.asdict(first.aggregated["int4-hamming84"][1e-2]))
    tsweep.run_sweep(params, cfg, tok, texts, config(catastrophic_threshold=10.0))
    assert len(calls) == 2  # another fingerprint: recomputed
    assert len(tsweep.load_sweep_checkpoint(path)) == 2  # no fingerprint required: any
    # a legacy record without a fingerprint is skipped when one is required,
    # and a JAX record of the same experiment is taken
    legacy = tsweep.TrialResult(cache_mode="fp16", ber=0, seed=7, perplexity=3.0)
    tsweep._append_checkpoint(path, legacy)
    jsweep._append_checkpoint(path, jsweep.TrialResult(cache_mode="fp8", ber=0, seed=7,
                                                        perplexity=4.0), fp)
    done = tsweep.load_sweep_checkpoint(path, fp)
    assert ("fp16", 0, 7) not in done and done[("fp8", 0, 7)].perplexity == 4.0
    single = tsweep.run_sweep_single_seed(params, cfg, tok, texts, config(), seed=42)
    assert set(single["int4-hamming84"]) == {0, 1e-2} and len(calls) == 2


# -- the CLI ------------------------------------------------------------------


def test_cli_at_the_tpu_config_ber0(tmp_path):
    """The port's CLI on the CPU at the TPU run's config (trained-tiny, the 7
    modes, 20 texts, max_length 256, stride 128, seed 42), BER 0 alone,
    with KL, top-5 and the catastrophic pass off: every mode's perplexity
    within TPU_BER0_TOL of the TPU run's BER-0 trial, the int4 codes' equal
    to int4's, nothing counted; the file set and JSON keys the TPU run's
    ("0.0" for argparse's float BER)."""
    out = tmp_path / "mc"
    res = tmc.main(["--model", "trained-tiny", "--require-checkpoint", "--device", "cpu",
                    "--ber-levels", "0", "--seeds", "42", "--no-kl", "--no-top5",
                    "--no-catastrophic", "--output-dir", str(out)])
    with open(os.path.join(TPU_RUN, "monte_carlo_results.json")) as fh:
        tpu = json.load(fh)
    want = {t["cache_mode"]: t["perplexity"] for t in tpu["trials"]
            if t["ber"] == 0 and t["seed"] == 42}
    got = {t.cache_mode: t.perplexity for t in res.trials}
    assert list(got) == list(want)
    for mode, ppl in got.items():
        assert abs(ppl - want[mode]) <= TPU_BER0_TOL * want[mode], (mode, ppl, want[mode])
    assert len({got[m] for m in got if m not in ("fp16", "fp8")}) == 1
    assert all(t.errors_corrected == t.errors_detected == t.bits_flipped == 0
               for t in res.trials)
    files = sorted(os.path.relpath(os.path.join(d, f), out) for d, _, fs in os.walk(out)
                   for f in fs)
    tpu_files = sorted(os.path.relpath(os.path.join(d, f), TPU_RUN)
                       for d, _, fs in os.walk(TPU_RUN) for f in fs)
    assert files == tpu_files
    with open(out / "monte_carlo_results.json") as fh:
        mine = json.load(fh)
    assert mine.keys() == tpu.keys() and mine["config"].keys() == tpu["config"].keys()
    assert mine["trials"][0].keys() == tpu["trials"][0].keys()
    assert list(mine["aggregated"]["fp16"]) == ["0.0"]
    assert mine["aggregated"]["fp16"]["0.0"].keys() == tpu["aggregated"]["fp16"]["0"].keys()


def test_entry_points_need_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means that card")
    for call in (lambda: tmodels.load_model("tiny-gpt2"),
                 lambda: load_params(CKPT, tconfig.get_model_config("trained-tiny")),
                 lambda: tmc.main(["--model", "tiny-gpt2", "--output-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    shutil.rmtree(tmp_path, ignore_errors=True)
