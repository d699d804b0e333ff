"""The port's experiment CLIs (qkv_ecc_tpu_torch.evaluation.experiments:
latency, quantization_ecc_comparison, generation, architecture,
fault_tolerance_benchmark; evaluation.runners.tpu_eval) against the JAX
package, on the CPU at small sizes: the counterparts of
tests/test_experiments.py, each result held to JAX's where it is
deterministic. Where both run a model, the port runs JAX's weights
(params_from_jax). No JAX function that could reach the network runs
here: JAX's load_model is called on the tiny and trained models only.

Tolerances, with their reasons:
  * analyses, keys, tables, reports, token ids, counts: equal;
  * quantization x ECC MSEs with JAX's flips fed to both: 1e-5 relative
    (a float32 mean of the same values in another order);
  * perplexities of the same weights at BER 0: 1e-5 relative (the forward's
    float32 matmuls, XLA against torch, an ulp or two each; no K/V value
    lands on another code on these inputs).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.evaluation import data as jdata  # noqa: E402
from qkv_ecc_tpu.evaluation import models as jmodels  # noqa: E402
from qkv_ecc_tpu.evaluation.experiments import architecture as jarch  # noqa: E402
from qkv_ecc_tpu.evaluation.experiments import fault_tolerance_benchmark as jft  # noqa: E402
from qkv_ecc_tpu.evaluation.experiments import generation as jgen  # noqa: E402
from qkv_ecc_tpu.evaluation.experiments import latency as jlat  # noqa: E402
from qkv_ecc_tpu.evaluation.experiments import quantization_ecc_comparison as jqe  # noqa: E402
from qkv_ecc_tpu.evaluation.runners import tpu_eval as jtpu  # noqa: E402
from qkv_ecc_tpu.models import config as jconfig  # noqa: E402
from qkv_ecc_tpu.models import kv_policy as jkv  # noqa: E402
from qkv_ecc_tpu.models import runtime as jrt  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import data as tdata  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import architecture as tarch  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import fault_tolerance_benchmark as tft  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import generation as tgen  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import latency as tlat  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import quantization_ecc_comparison as tqe  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.experiments import train_tiny as ttrain  # noqa: E402
from qkv_ecc_tpu_torch.evaluation.runners import tpu_eval as ttpu  # noqa: E402
from qkv_ecc_tpu_torch.models import config as tconfig  # noqa: E402
from qkv_ecc_tpu_torch.models import kv_policy as tkv  # noqa: E402
from qkv_ecc_tpu_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(1)


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def tiny_gpt2():
    """tiny-gpt2 as JAX's load_model gives it, and the same weights in the
    port."""
    jp, jc, _ = jmodels.load_model("tiny-gpt2")
    tc = tconfig.get_model_config("tiny-gpt2")
    return jp, jc, treg.params_from_jax(jax.tree.map(np.asarray, jp), tc, device="cpu"), tc


# -- generation ---------------------------------------------------------------


@pytest.mark.parametrize("ids", [[5, 7, 7, 7, 7, 7, 7, 7, 7], list(range(20)), [1, 2, 1, 2, 1, 2],
                                 [3, 4, 5, 3, 4, 5, 3, 4, 5, 9], [1], []])
def test_analyze_generation_matches_jax(ids):
    assert tgen.analyze_generation(ids) == jgen.analyze_generation(ids)


def test_generation_demo_matches_jax(monkeypatch, tiny_gpt2):
    """The demo's tokens, texts, analyses and agreement with the clean
    golay run at BER 0 equal JAX's on tiny-gpt2 (the port given JAX's
    weights), and the report is JAX's."""
    jp, jc, tp, tc = tiny_gpt2
    monkeypatch.setattr(tgen, "load_model", lambda name, device=None: (tp, tc,
                                                                       tdata.ByteTokenizer()))
    modes = ["fp16", "int12-golay"]
    want = jgen.run_generation_demo("tiny-gpt2", cache_modes=modes, ber=0.0, max_new_tokens=4,
                                    progress=quiet)
    got = tgen.run_generation_demo("tiny-gpt2", cache_modes=modes, ber=0.0, max_new_tokens=4,
                                   progress=quiet, device="cpu")
    assert got == want
    assert tgen.format_report(got) == jgen.format_report(want)


# -- architecture ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny-gpt2", "tiny-llama", "trained-tiny"])
def test_analyze_architecture_matches_jax(name):
    assert tarch.analyze_architecture(name) == jarch.analyze_architecture(name)


def test_analyze_architecture_knows_every_model():
    for name in ("gpt2", "mistral-7b", "llama-3.1-8b", "bench-0.9b", "trained-100m"):
        assert tarch.analyze_architecture(name)["model"] == name
    with pytest.raises(ValueError, match="Unknown model"):
        tarch.analyze_architecture("gpt5")


def test_architecture_comparison_runs_and_reports(tmp_path, monkeypatch):
    comp = tarch.run_architecture_comparison(
        models=["tiny-gpt2", "tiny-llama"], cache_modes=["int4", "int12-golay"],
        ber_levels=[0.0], seeds=[42], max_samples=2, max_length=64, progress=quiet,
        device="cpu")
    assert set(comp) == {"tiny-gpt2", "tiny-llama"}
    for entry in comp.values():
        agg = entry["results"].aggregated
        assert agg["int4"][0.0].ppl_mean == agg["int12-golay"][0.0].ppl_mean
        assert np.isfinite(agg["int4"][0.0].ppl_mean)
    report = tarch.format_report(comp)
    assert "tiny-gpt2 (combined c_attn, GQA 1:1)" in report and "separate k/v_proj" in report
    assert tarch.plot_comparison(comp, str(tmp_path / "a.png")) == jarch.plot_comparison(
        comp, str(tmp_path / "b.png"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tarch.plot_comparison(comp, str(tmp_path / "c.png")) is False
    assert not (tmp_path / "c.png").exists()


# -- tpu_eval -------------------------------------------------------------------


ROWS = [dict(mode=m, ber=b, seed=s, ppl=p, errors_corrected=c, errors_detected=0, tokens=100)
        for m, b, s, p, c in [("int4", 0.0, 42, 12.5, 0), ("int4", 0.0, 101, 12.75, 0),
                              ("int12-golay", 1e-2, 42, 13.0, 1234),
                              ("int12-golay", 1e-2, 101, 13.5, 1301),
                              ("int12-golay", 1e-2, 997, float("inf"), 9),
                              ("fp16", 1e-3, 42, 11.0, 0)]]


def test_tpu_eval_tables_match_jax():
    assert ttpu.MODE_ALIASES == jtpu.MODE_ALIASES
    agg = ttpu.aggregate(ROWS)
    assert str(agg) == str(jtpu.aggregate(ROWS))
    assert ttpu.format_markdown(agg) == jtpu.format_markdown(jtpu.aggregate(ROWS))


@pytest.mark.parametrize("mode", ["fp16", "golay", "unprotected"])
def test_tpu_eval_trial_matches_jax(mode, tiny_gpt2):
    """One trial at BER 0 on the same weights and texts: JAX's tokens and
    counts, its perplexity within 1e-5."""
    jp, jc, tp, tc = tiny_gpt2
    texts = jdata.load_wikitext2_test(max_samples=2) + ["   "]
    want = jtpu.run_single_trial(jp, jc, jdata.ByteTokenizer(), texts, mode, 0.0, 42,
                                 max_length=96)
    got = ttpu.run_single_trial(tp, tc, tdata.ByteTokenizer(), texts, mode, 0.0, 42,
                                max_length=96)
    assert got.pop("ppl") == pytest.approx(want.pop("ppl"), rel=1e-5)
    assert got == want
    with pytest.raises(ValueError, match="Unknown mode"):
        ttpu.run_single_trial(tp, tc, tdata.ByteTokenizer(), texts, "nope", 0.0, 42)


# -- quantization x ECC ---------------------------------------------------------


def test_quantization_ecc_comparison_matches_jax(monkeypatch):
    """The study with JAX's flips fed to both (JAX's inject_bit_errors
    recorded, its masks replayed in the port's order): the same rows, the
    MSEs within 1e-5, the counts equal."""
    masks = []
    real = jqe.inject_bit_errors

    def record(data, ber, n_bits, seed=0):
        out = real(data, ber, n_bits, seed=seed)
        masks.append(np.asarray(out).astype(np.int64) ^ np.asarray(data).astype(np.int64))
        return out

    def replay(data, ber, n_bits, seed=0):
        m = torch.from_numpy(masks.pop(0))
        return (data.to(torch.int64) ^ m).to(data.dtype)

    monkeypatch.setattr(jqe, "inject_bit_errors", record)
    monkeypatch.setattr(tqe, "inject_bit_errors", replay)
    kw = dict(backends=["block_absmax", "kivi", "per_token"], ber_levels=[0.0, 1e-2, 5e-2],
              trials=2, shape=(8, 4, 24))
    want = jqe.run_quantization_ecc_comparison(jqe.QuantEccConfig(**kw), progress=quiet)
    got = tqe.run_quantization_ecc_comparison(tqe.QuantEccConfig(**kw), progress=quiet,
                                              device="cpu")
    assert not masks and len(got) == len(want) == 3 * 4 * 3
    for g, w in zip(got, want):
        for k in ("quant_mse", "post_ecc_mse", "mse_amplification"):
            assert g.pop(k) == pytest.approx(w.pop(k), rel=1e-5), (g, k)
        assert g == w
    assert any(r["errors_corrected"] > 0 for r in got)


def test_quantization_ecc_table_matches_jax():
    rows = [dict(backend="kivi", ecc="golay", ber=1e-2, quant_mse=0.01234, post_ecc_mse=0.0125,
                 mse_amplification=1.0129, errors_corrected=5, errors_detected=0)]
    assert tqe.format_table(rows) == jqe.format_table(rows)


# -- latency --------------------------------------------------------------------


def test_latency_grid_matches_jax_keys():
    cfg = dict(codecs=["hamming74", "golay"], shapes=[(512,)], trials=1, warmup=1)
    got = tlat.run_latency_experiment(tlat.CodecBenchmarkConfig(**cfg), device="cpu")
    want = jlat.run_latency_experiment(jlat.CodecBenchmarkConfig(**cfg))
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert (g["codec"], g["shape"], g["n_values"]) == (w["codec"], w["shape"], w["n_values"])
        assert g["throughput_mvalues_sec"] > 0
    report = tlat.format_report(got)
    assert report.splitlines()[:2] == jlat.format_report(want).splitlines()[:2]
    assert "golay" in report


# -- fault tolerance --------------------------------------------------------------


def test_decode_throughput_matches_jax_cache():
    """benchmark_decode_throughput on tiny-llama: JAX's keys, and the cache
    bytes of JAX's generation state for the same shapes."""
    tc = tconfig.get_model_config("tiny-llama")
    params = treg.init_params(tc, 0, device="cpu")
    for mode in ("int12-golay", "int4", "fp16"):
        r = tft.benchmark_decode_throughput(params, tc, tkv.policy_for_mode(mode, seed=42), 1, 16,
                                            4)
        state, _, _ = jrt.init_generation_state(jconfig.get_model_config("tiny-llama"),
                                                jkv.policy_for_mode(mode, seed=42), 1,
                                                16 + 3 * 4 + 8)
        want = sum(int(np.prod(v.shape)) * v.dtype.itemsize for k, v in state.items()
                   if k != "context_len")
        assert r["cache_bytes"] == want and r["cache_gb"] == want / 1e9
        assert list(r) == ["codec", "ber", "batch", "decode_tokens_per_sec", "ms_per_token",
                           "cache_bytes", "cache_gb"]
        assert r["decode_tokens_per_sec"] > 0 and r["codec"] == tkv.policy_for_mode(mode).codec


def test_peak_memory_and_grid_tables():
    """On the CPU live_array_bytes is what the generation state holds; the
    grid's tables are JAX's on the same rows."""
    assert tft.peak_memory_stats("cpu", 1234) == {"live_array_bytes": 1234}
    tc = tconfig.get_model_config("tiny-llama")
    params = treg.init_params(tc, 0, device="cpu")
    grid = tft.benchmark_grid(params, tc, ["int12-golay"], batches=(1,), contexts=(16,),
                              decode_tokens=2, progress=quiet)
    r = grid[0]
    assert r["memory"] == {"live_array_bytes": r["cache_bytes"]}
    rows = [dict(r, memory={}) for r in grid] + [dict(
        grid[0], arm="int4", decode_tokens_per_sec=99.5, ms_per_token=1.25, cache_gb=0.5)]
    assert tft.format_grid_tables(rows) == jft.format_grid_tables(rows)
    res = {"throughput": [dict(codec="int4", decode_tokens_per_sec=10.0, ms_per_token=2.0,
                               overhead_vs_unprotected=1.0, cache_gb=0.001)],
           "ppl_vs_ber": [dict(arm="int4", ber=1e-3, ppl_mean=12.5, ppl_values=[12.5])]}
    assert tft.format_report(res) == jft.format_report(res)


def test_ppl_vs_ber_matches_jax(tiny_gpt2):
    jp, jc, tp, tc = tiny_gpt2
    texts = jdata.load_wikitext2_test(max_samples=2)
    kw = dict(arms=["int4-hamming84", "fp16"], ber_levels=[0.0], seeds=[42], max_length=48)
    want = jft.benchmark_ppl_vs_ber(jp, jc, jdata.ByteTokenizer(), texts, **kw)
    got = tft.benchmark_ppl_vs_ber(tp, tc, tdata.ByteTokenizer(), texts, **kw)
    for g, w in zip(got, want):
        assert g.pop("ppl_mean") == pytest.approx(w.pop("ppl_mean"), rel=1e-5)
        np.testing.assert_allclose(g.pop("ppl_values"), w.pop("ppl_values"), rtol=1e-5)
        assert g == w


# -- every CLI needs a card unless told -----------------------------------------


def test_clis_need_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: no --device means that card")
    out = str(tmp_path / "x.json")
    for main, argv in ((tlat.main, ["--trials", "1"]), (tqe.main, ["--trials", "1"]),
                       (tgen.main, []), (tarch.main, []), (tft.main, []),
                       (ttpu.main, ["--model", "tiny-gpt2"]),
                       (ttrain.main, ["--steps", "2", "--output", out])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)
    assert os.listdir(tmp_path) == []
