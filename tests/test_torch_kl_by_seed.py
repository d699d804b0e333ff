"""The KL-by-seed study (qkv_ecc_tpu_torch/evaluation/experiments/kl_by_seed.py)
on the CPU: its trials are the sweep's, and its variants split the flips
at the first positions. Small: trained-tiny, 3 texts, max_length 64."""

import dataclasses

import torch

from qkv_ecc_tpu_torch.evaluation import sweep as tsweep
from qkv_ecc_tpu_torch.evaluation.experiments import kl_by_seed as kbs
from qkv_ecc_tpu_torch.evaluation.experiments.monte_carlo import MonteCarloConfig, eval_texts
from qkv_ecc_tpu_torch.evaluation.metrics import generate_clean_logits
from qkv_ecc_tpu_torch.evaluation.models import load_model

torch.set_num_threads(1)

SEEDS = [42, 7]


def study(first):
    config = MonteCarloConfig(model="trained-tiny", cache_modes=["int4-hamming84"], seeds=SEEDS,
                              max_samples=3, max_length=64, allow_random_init=False,
                              device="cpu")
    return config, kbs.run(config, 1e-2, ["cpu"], first, progress=lambda *_: None)


def test_trials_are_the_sweeps():
    """With the flips drawn where the forward runs and none cleared, each
    trial is run_sweep's trial of that seed, field for field (the same
    flips: same generator, same seed)."""
    config, out = study(0)
    params, cfg, tok = load_model("trained-tiny", allow_random_init=False, device="cpu")
    texts = eval_texts(config)
    clean = generate_clean_logits(params, cfg, tok, texts, max_length=64)
    sc = tsweep.SweepConfig(cache_modes=["int4-hamming84"], ber_levels=[1e-2], seeds=SEEDS,
                            max_length=64, compute_top5=False, compute_catastrophic=False,
                            clean_logits=clean)
    want = {t.seed: dataclasses.asdict(t) for t in tsweep.run_sweep(params, cfg, tok, texts,
                                                                     sc).trials}
    assert [t["variant"] for t in out["trials"]] == ["all"] * len(SEEDS)
    for t in out["trials"]:
        for k in ("kl_divergence", "perplexity", "errors_corrected", "errors_detected",
                  "bits_flipped"):
            assert t[k] == want[t["seed"]][k], (t["seed"], k)
        assert t["bits_flipped"] > 0 and t["multi_bit_seen"] > 0
    kl = out["summary"]["int4-hamming84 cpu all"]["kl_divergence"]
    assert kl["n"] == len(SEEDS) and kl["min"] <= kl["mean"] <= kl["max"]
    assert sum(out["config"]["texts_by_padded_length"].values()) == 3


def test_variants_split_the_first_positions():
    """"rest" and "first" split each seed's flips, and their multi-bit
    codewords, at position 4: their counts add up to "all"'s."""
    _, out = study(4)
    by = {(t["seed"], t["variant"]): t for t in out["trials"]}
    assert len(by) == 3 * len(SEEDS)
    for seed in SEEDS:
        a, r, f = (by[(seed, v)] for v in kbs.VARIANTS)
        for k in ("bits_flipped", "multi_bit_seen"):
            assert a[k] == r[k] + f[k], (seed, k)
        assert r["multi_bit_seen_first"] == 0
        assert f["multi_bit_seen_first"] == f["multi_bit_seen"] == a["multi_bit_seen_first"]
        assert 0 < f["bits_flipped"] < a["bits_flipped"]


def test_multi_bit_counts_codewords_of_two_or_more_flips():
    masks = torch.tensor([0, 1, 3, 0x800001, 7, 0x10], dtype=torch.int32)
    assert kbs.multi_bit(masks) == 3
