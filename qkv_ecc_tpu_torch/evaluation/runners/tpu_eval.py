"""Standalone perplexity sweep runner for large-model publication runs
(counterpart of ``qkv_ecc_tpu/evaluation/runners/tpu_eval.py``, whose name
it keeps so that a reader finds it; it runs on the CUDA card):

    python -m qkv_ecc_tpu_torch.evaluation.runners.tpu_eval --model gpt2 \
        --seeds 42 --ber-levels 0 1e-2 --output runs/gpt2_runner.json

Mode aliases, the WikiText perplexity loop at max_length 512 (one forward
per text), a markdown table and the aggregation over seeds, with JAX's
flags and one more, ``--device`` (``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict, List

from ...models.kv_policy import policy_for_mode
from ...models.registry import loss_and_stats
from ..data import load_wikitext2_test, pad_to_bucket, tokenize
from ..models import load_model

# Mode aliases accepted by the runner
MODE_ALIASES = {
    "fp16": "fp16",
    "fp8": "fp8",
    "int4": "int4",
    "unprotected": "int4",
    "hamming": "int4-hamming",
    "hamming74": "int4-hamming",
    "int4-hamming": "int4-hamming",
    "hamming84": "int4-hamming84",
    "int4-hamming84": "int4-hamming84",
    "secded": "int4-hamming84",
    "interp": "int4-hamming84-interp",
    "hamming84-interp": "int4-hamming84-interp",
    "int4-hamming84-interp": "int4-hamming84-interp",
    "golay": "int12-golay",
    "int12-golay": "int12-golay",
}


def run_single_trial(
    params, cfg, tokenizer, texts, mode: str, ber: float, seed: int,
    max_length: int = 512,
) -> Dict:
    """One trial at the runner's protocol (max_length 512, one forward per
    text, padded to a multiple of 64), on the parameters' device."""
    canonical = MODE_ALIASES.get(mode)
    if canonical is None:
        raise ValueError(f"Unknown mode '{mode}'. Known: {sorted(MODE_ALIASES)}")
    policy = policy_for_mode(canonical, ber=ber, seed=seed)
    total_loss, total_tokens = 0.0, 0
    corrected = detected = 0
    for text in texts:
        if not text.strip():
            continue
        ids = tokenize(tokenizer, text, max_length)
        if ids.shape[1] < 2:
            continue
        padded, labels, L = pad_to_bucket(ids, bucket=64)
        loss, count, _, stats = loss_and_stats(params, padded, labels, cfg, policy)
        loss = float(loss)
        if math.isnan(loss) or math.isinf(loss):
            continue
        total_loss += loss * L
        total_tokens += L
        corrected += int(stats["errors_corrected"])
        detected += int(stats["errors_detected"])
    return {
        "mode": canonical,
        "ber": ber,
        "seed": seed,
        "ppl": math.exp(total_loss / total_tokens) if total_tokens else float("inf"),
        "errors_corrected": corrected,
        "errors_detected": detected,
        "tokens": total_tokens,
    }


def run_ppl_sweep(
    model_name: str,
    modes: List[str],
    ber_levels: List[float],
    seeds: List[int],
    max_samples: int = 20,
    max_length: int = 512,
    progress=print,
    *,
    device=None,
) -> List[Dict]:
    """(mode x ber x seed) sweep on ``device`` (None: the card)."""
    params, cfg, tokenizer = load_model(model_name, device=device)
    texts = load_wikitext2_test(max_samples=max_samples)
    results = []
    for mode in modes:
        for ber in ber_levels:
            for seed in seeds:
                r = run_single_trial(
                    params, cfg, tokenizer, texts, mode, ber, seed, max_length
                )
                progress(
                    f"  {r['mode']:<24} BER={ber:<8.0e} seed={seed:<6} "
                    f"PPL={r['ppl']:.3f}"
                )
                results.append(r)
    return results


def aggregate(results: List[Dict]) -> List[Dict]:
    """Mean/std across seeds per (mode, ber)."""
    groups: Dict[tuple, List[Dict]] = {}
    for r in results:
        groups.setdefault((r["mode"], r["ber"]), []).append(r)
    agg = []
    for (mode, ber), rs in groups.items():
        ppls = [r["ppl"] for r in rs]
        mean = sum(ppls) / len(ppls)
        std = (
            (sum((p - mean) ** 2 for p in ppls) / (len(ppls) - 1)) ** 0.5
            if len(ppls) > 1
            else 0.0
        )
        agg.append(
            {
                "mode": mode,
                "ber": ber,
                "ppl_mean": mean,
                "ppl_std": std,
                "n_seeds": len(rs),
                "errors_corrected_mean": sum(r["errors_corrected"] for r in rs)
                / len(rs),
            }
        )
    return agg


def format_markdown(agg: List[Dict]) -> str:
    """Markdown results table."""
    lines = [
        "| Mode | BER | PPL (mean ± std) | Errors corrected |",
        "|---|---|---|---|",
    ]
    for r in sorted(agg, key=lambda r: (r["mode"], r["ber"])):
        lines.append(
            f"| {r['mode']} | {r['ber']:.0e} | "
            f"{r['ppl_mean']:.3f} ± {r['ppl_std']:.3f} | "
            f"{r['errors_corrected_mean']:,.0f} |"
        )
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description="Publication perplexity sweep runner")
    p.add_argument("--model", default="gpt2")
    p.add_argument("--modes", nargs="+",
                   default=["fp16", "int4", "hamming", "hamming84", "interp", "golay"])
    p.add_argument("--ber-levels", type=float, nargs="+", default=[0, 1e-4, 1e-3, 1e-2])
    p.add_argument("--seeds", type=int, nargs="+", default=[42, 101, 997])
    p.add_argument("--max-samples", type=int, default=20)
    p.add_argument("--max-length", type=int, default=512)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    results = run_ppl_sweep(
        args.model, args.modes, args.ber_levels, args.seeds,
        args.max_samples, args.max_length, device=args.device,
    )
    agg = aggregate(results)
    md = format_markdown(agg)
    print(md)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"trials": results, "aggregated": agg}, f, indent=2)
    return agg


if __name__ == "__main__":
    main()
