"""The KL divergence of single Monte-Carlo trials, seed by seed, with the
flips drawn by the generator of a chosen device and, optionally, with the
flips of the first token positions cleared or kept alone. It asks how far
a trial's KL moves from seed to seed, whether the generator that draws the
flips moves it, and how much of it the first positions carry:

    python -m qkv_ecc_tpu_torch.evaluation.experiments.kl_by_seed \
        --model trained-tiny --cache-modes int4-hamming int4-hamming84 \
        --seeds 42 101 997 --mask-devices card cpu --first 1 \
        --output kl_by_seed.json

A trial is sweep.run_single_trial at BER --ber with the KL pass on (top-5
and the catastrophic pass off), over the Monte-Carlo CLI's texts
(--max-samples, --max-length). "card" draws the flips on the forward's
device, as the CLI does; "cpu" draws them with the CPU generator and moves
them there. With --first k every trial also runs with the flips of
positions < k cleared ("rest") and with those alone ("first"). Each trial
records the codewords with two or more flipped bits that its texts see
(a text sees the flips of its padded length), in all and at positions < k.
Runs on the card unless given --device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import time
from collections import Counter
from typing import List, Optional

import torch

from .. import metrics
from ..data import pad_to_bucket, tokenize
from ..metrics import generate_clean_logits
from ..models import load_model
from ..sweep import SweepConfig, run_single_trial
from .monte_carlo import MonteCarloConfig, eval_texts

VARIANTS = ("all", "rest", "first")


def multi_bit(masks: torch.Tensor) -> int:
    """Codewords of ``masks`` with two or more flipped bits."""
    m = masks.to(torch.int32)
    ones = sum((m >> b) & 1 for b in range(24))
    return int((ones >= 2).sum())


@contextlib.contextmanager
def drawn_masks(mask_device: Optional[str], first: int, variant: str, seen: dict):
    """metrics.forward_masks drawing its flips on ``mask_device`` (None: the
    forward's device), then moved to the forward's device; "rest" clears the
    flips at positions < ``first``, "first" keeps those alone. ``seen``
    gets, by padded length, (multi-bit codewords, those at positions <
    ``first``) of the masks handed on."""
    real = metrics.forward_masks

    def draw(policy, num_layers, shape, device):
        out = []
        for m in real(policy, num_layers, shape, mask_device or device):
            if m is not None:
                m = m.to(device)  # [L, 2, 1, P, ...]: positions on axis 3
                if variant != "all":
                    keep = torch.arange(m.shape[3], device=device) < first
                    keep = keep if variant == "first" else ~keep
                    m = m * keep.view(1, 1, 1, -1, *([1] * (m.dim() - 4))).to(m.dtype)
                seen[shape[1]] = (multi_bit(m), multi_bit(m[:, :, :, :first]))
            out.append(m)
        return tuple(out)

    metrics.forward_masks = draw
    try:
        yield
    finally:
        metrics.forward_masks = real


def padded_lengths(tokenizer, texts, max_length: int) -> Counter:
    """The texts a trial scores, counted by padded length."""
    lengths = Counter()
    for text in texts:
        if text.strip():
            ids = tokenize(tokenizer, text, max_length)
            if ids.shape[1] >= 2:
                lengths[pad_to_bucket(ids, bucket=32)[0].shape[1]] += 1
    return lengths


def summarize(values: List[float]) -> dict:
    n = len(values)
    mean = statistics.fmean(values)
    std = statistics.stdev(values) if n > 1 else 0.0
    return {"n": n, "mean": mean, "std": std, "sem": std / math.sqrt(n),
            "median": statistics.median(values), "min": min(values), "max": max(values)}


def run(config: MonteCarloConfig, ber: float, mask_devices: List[str], first: int,
        progress=print) -> dict:
    """Every (mode, seed, mask device, variant) trial and their summaries."""
    params, cfg, tok = load_model(config.model, allow_random_init=config.allow_random_init,
                                  device=config.device)
    texts = eval_texts(config)
    clean = generate_clean_logits(params, cfg, tok, texts, max_length=config.max_length)
    sc = SweepConfig(cache_modes=config.cache_modes, ber_levels=[ber], seeds=config.seeds,
                     max_length=config.max_length, stride=config.stride,
                     compute_top5=False, compute_catastrophic=False, clean_logits=clean)
    lengths = padded_lengths(tok, texts, config.max_length)
    variants = VARIANTS if first else VARIANTS[:1]
    trials, t0 = [], time.perf_counter()
    for mode in config.cache_modes:
        for masks in mask_devices:
            for variant in variants:
                for seed in config.seeds:
                    seen = {}
                    with drawn_masks(None if masks == "card" else masks, first, variant, seen):
                        tr = run_single_trial(params, cfg, tok, texts, mode, ber, seed, sc)
                    trials.append({
                        "cache_mode": mode, "seed": seed, "masks": masks, "variant": variant,
                        "kl_divergence": tr.kl_divergence, "perplexity": tr.perplexity,
                        "errors_corrected": tr.errors_corrected,
                        "errors_detected": tr.errors_detected, "bits_flipped": tr.bits_flipped,
                        "multi_bit_seen": sum(lengths[p] * s[0] for p, s in seen.items()),
                        "multi_bit_seen_first": sum(lengths[p] * s[1] for p, s in seen.items()),
                    })
                progress(f"{mode} masks {masks} {variant}: {len(config.seeds)} seeds, "
                         f"{time.perf_counter() - t0:.1f} s so far")
    seconds = time.perf_counter() - t0
    summary = {}
    for t in trials:
        summary.setdefault(f"{t['cache_mode']} {t['masks']} {t['variant']}", []).append(t)
    summary = {k: {"kl_divergence": summarize([t["kl_divergence"] for t in ts]),
                   "perplexity": summarize([t["perplexity"] for t in ts]),
                   "multi_bit_seen_first": summarize([t["multi_bit_seen_first"] for t in ts])}
               for k, ts in summary.items()}
    return {"config": {"model": config.model, "cache_modes": config.cache_modes, "ber": ber,
                       "seeds": config.seeds, "max_samples": config.max_samples,
                       "max_length": config.max_length, "mask_devices": mask_devices,
                       "first": first, "texts_by_padded_length": dict(sorted(lengths.items()))},
            "device": (torch.cuda.get_device_name() if str(config.device or "cuda") != "cpu"
                       else "cpu"),
            "seconds": seconds, "seconds_per_trial": seconds / len(trials),
            "summary": summary, "trials": trials}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description="Monte-Carlo trials' KL seed by seed")
    parser.add_argument("--model", default="trained-tiny")
    parser.add_argument("--cache-modes", nargs="+", default=["int4-hamming", "int4-hamming84"])
    parser.add_argument("--ber", type=float, default=1e-2)
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 101, 997])
    parser.add_argument("--mask-devices", nargs="+", default=["card", "cpu"],
                        help="where the flips are drawn: 'card' (the forward's device) or a "
                        "torch device")
    parser.add_argument("--first", type=int, default=1,
                        help="also run each trial without, and with only, the flips of the "
                        "first positions (0: not)")
    parser.add_argument("--max-samples", type=int, default=20)
    parser.add_argument("--max-length", type=int, default=256)
    parser.add_argument("--require-checkpoint", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA card)")
    parser.add_argument("--output", default=None, help="write the JSON here")
    args = parser.parse_args(argv)
    config = MonteCarloConfig(model=args.model, cache_modes=args.cache_modes, seeds=args.seeds,
                              max_samples=args.max_samples, max_length=args.max_length,
                              allow_random_init=not args.require_checkpoint, device=args.device)
    out = run(config, args.ber, args.mask_devices, args.first)
    for key, s in out["summary"].items():
        kl = s["kl_divergence"]
        print(f"{key}: KL mean {kl['mean']:.6f} +-{kl['sem']:.6f} (sem), std {kl['std']:.6f}, "
              f"median {kl['median']:.6f}, range {kl['min']:.6f}-{kl['max']:.6f} over "
              f"{kl['n']} seeds")
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
