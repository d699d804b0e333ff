"""Monte-Carlo fault-injection experiment: the publication entry point
(counterpart of ``qkv_ecc_tpu/evaluation/experiments/monte_carlo.py``, with
its flags and one more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.monte_carlo \
        --model trained-tiny --output-dir results/run1 --seeds 42 101 997

runs on the card; ``--device cpu`` runs on the CPU. Writes, under
--output-dir, monte_carlo_results.json, results_table.txt,
results_table.tex, paper_tables.tex, tables/{perplexity,storage_overhead,
correction_rates,throughput}.tex and the resumable sweep_checkpoint.jsonl,
with the JAX CLI's JSON keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import List, Optional

from ..constants import (
    BER_LEVELS,
    CACHE_MODE_LABELS,
    CACHE_MODE_ORDER,
    DEFAULT_CONFIG,
    get_cache_modes,
)
from ..data import load_wikitext2_test
from ..latex_tables import (
    format_all_latex_tables,
    format_correction_rate_table,
    format_perplexity_table,
    format_storage_overhead_table,
    format_throughput_table,
)
from ..metrics import generate_clean_logits
from ..models import TRAINED_CHECKPOINTS, checkpoint_path, load_model
from ..sweep import SweepConfig, SweepResults, run_sweep


@dataclasses.dataclass
class MonteCarloConfig:
    model: str = "gpt2"
    cache_modes: List[str] = dataclasses.field(
        default_factory=lambda: list(CACHE_MODE_ORDER)
    )
    ber_levels: List[float] = dataclasses.field(default_factory=lambda: list(BER_LEVELS))
    seeds: List[int] = dataclasses.field(default_factory=lambda: [42, 101, 997])
    max_samples: int = 20
    max_length: int = DEFAULT_CONFIG["max_length"]
    stride: int = DEFAULT_CONFIG["stride"]
    output_dir: str = "results/monte_carlo"
    compute_kl: bool = True
    compute_top5: bool = True
    compute_catastrophic: bool = True
    allow_random_init: bool = True
    device: Optional[str] = None  # None: the card


def eval_texts(config: MonteCarloConfig) -> List[str]:
    """The texts the experiment scores: a trained checkpoint's held-out
    split saved next to it (text the model never trained on), else
    load_wikitext2_test's."""
    if config.model in TRAINED_CHECKPOINTS:
        tp = checkpoint_path(config.model) + ".eval_texts.json"
        if os.path.exists(tp):
            with open(tp) as fh:
                return json.load(fh)[: config.max_samples]
    return load_wikitext2_test(max_samples=config.max_samples)


def run_monte_carlo_experiment(config: MonteCarloConfig, progress=print):
    """Load model + data, precompute clean logits, run the sweep."""
    progress(f"Loading model {config.model}...")
    params, model_cfg, tokenizer = load_model(
        config.model, allow_random_init=config.allow_random_init, device=config.device
    )
    progress(f"Loading evaluation texts (max {config.max_samples})...")
    texts = eval_texts(config)

    clean_logits = None
    if config.compute_kl:
        progress("Precomputing clean logits for KL baseline...")
        clean_logits = generate_clean_logits(
            params, model_cfg, tokenizer, texts, max_length=config.max_length
        )

    os.makedirs(config.output_dir, exist_ok=True)
    sweep_cfg = SweepConfig(
        cache_modes=config.cache_modes,
        ber_levels=config.ber_levels,
        seeds=config.seeds,
        max_length=config.max_length,
        stride=config.stride,
        compute_kl_divergence=config.compute_kl,
        compute_top5=config.compute_top5,
        compute_catastrophic=config.compute_catastrophic,
        clean_logits=clean_logits,
        # resume support: a killed run restarts from the last finished trial
        checkpoint_path=os.path.join(config.output_dir, "sweep_checkpoint.jsonl"),
    )

    t0 = time.time()

    def cb(desc, cur, total):
        progress(f"  [{cur + 1}/{total}] {desc} ({time.time() - t0:.0f}s elapsed)")

    results = run_sweep(params, model_cfg, tokenizer, texts, sweep_cfg, cb)
    progress(f"Sweep finished in {time.time() - t0:.0f}s")
    return results


def format_results_table(results: SweepResults) -> str:
    """ASCII tables: perplexity, KL, top-5, errors corrected / detected."""
    aggregated = results.aggregated
    bers = sorted({b for m in aggregated.values() for b in m})
    lines = []

    def header(title):
        lines.append("")
        lines.append(title)
        lines.append("-" * 78)
        lines.append(
            f"{'Mode':<22}" + "".join(f"{('BER=' + format(b, '.0e') if b else 'BER=0'):>14}" for b in bers)
        )
        lines.append("-" * 78)

    header("PERPLEXITY (mean ± std)")
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        row = f"{CACHE_MODE_LABELS.get(mode, mode):<22}"
        for b in bers:
            agg = aggregated[mode].get(b)
            row += (
                f"{agg.ppl_mean:>8.2f}±{agg.ppl_std:<5.2f}" if agg else f"{'--':>14}"
            )
        lines.append(row)

    header("KL DIVERGENCE (nats)")
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        row = f"{CACHE_MODE_LABELS.get(mode, mode):<22}"
        for b in bers:
            agg = aggregated[mode].get(b)
            row += f"{agg.kl_divergence_mean:>14.4f}" if agg else f"{'--':>14}"
        lines.append(row)

    header("TOP-5 ACCURACY")
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        row = f"{CACHE_MODE_LABELS.get(mode, mode):<22}"
        for b in bers:
            agg = aggregated[mode].get(b)
            row += f"{agg.top5_accuracy_mean:>13.1%}" + " " if agg else f"{'--':>14}"
        lines.append(row)

    header("ERRORS CORRECTED / DETECTED")
    for mode in CACHE_MODE_ORDER:
        if mode not in aggregated:
            continue
        row = f"{CACHE_MODE_LABELS.get(mode, mode):<22}"
        for b in bers:
            agg = aggregated[mode].get(b)
            if agg:
                row += f"{agg.errors_corrected_mean:>7,.0f}/{agg.errors_detected_mean:<6,.0f}"
            else:
                row += f"{'--':>14}"
        lines.append(row)
    lines.append("")
    return "\n".join(lines)


def save_results(results: SweepResults, config: MonteCarloConfig):
    """Write the JSON, ASCII and LaTeX files; returns the ASCII table."""
    os.makedirs(config.output_dir, exist_ok=True)
    tables_dir = os.path.join(config.output_dir, "tables")
    os.makedirs(tables_dir, exist_ok=True)

    payload = {
        "config": {
            "model": config.model,
            "cache_modes": config.cache_modes,
            "ber_levels": config.ber_levels,
            "seeds": config.seeds,
            "max_samples": config.max_samples,
            "max_length": config.max_length,
            "stride": config.stride,
        },
        "trials": [dataclasses.asdict(t) for t in results.trials],
        "aggregated": {
            mode: {str(ber): dataclasses.asdict(agg) for ber, agg in by_ber.items()}
            for mode, by_ber in results.aggregated.items()
        },
    }
    with open(os.path.join(config.output_dir, "monte_carlo_results.json"), "w") as f:
        json.dump(payload, f, indent=2, default=str)

    ascii_table = format_results_table(results)
    files = {
        "results_table.txt": ascii_table,
        "results_table.tex": format_perplexity_table(results),
        "paper_tables.tex": format_all_latex_tables(results),
        "tables/perplexity.tex": format_perplexity_table(results),
        "tables/storage_overhead.tex": format_storage_overhead_table(),
        "tables/correction_rates.tex": format_correction_rate_table(results),
        "tables/throughput.tex": format_throughput_table(),
    }
    for name, text in files.items():
        with open(os.path.join(config.output_dir, name), "w") as f:
            f.write(text)
    return ascii_table


def main(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        description="Monte-Carlo ECC KV-cache fault-injection experiment"
    )
    parser.add_argument("--model", default="gpt2", help="model name (see constants.MODELS)")
    parser.add_argument("--output-dir", default="results/monte_carlo")
    parser.add_argument("--seeds", type=int, nargs="+", default=[42, 101, 997])
    parser.add_argument("--ber-levels", type=float, nargs="+", default=None)
    parser.add_argument("--cache-modes", nargs="+", default=None)
    parser.add_argument("--max-samples", type=int, default=20)
    parser.add_argument("--max-length", type=int, default=DEFAULT_CONFIG["max_length"])
    parser.add_argument("--protected-only", action="store_true")
    parser.add_argument("--no-kl", action="store_true")
    parser.add_argument("--no-top5", action="store_true")
    parser.add_argument("--no-catastrophic", action="store_true")
    parser.add_argument(
        "--require-checkpoint",
        action="store_true",
        help="fail instead of falling back to random-init weights",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device to run on (default: the CUDA card; 'cpu' for the CPU)",
    )
    args = parser.parse_args(argv)

    modes = args.cache_modes
    if modes is None:
        modes = get_cache_modes(protected_only=args.protected_only)

    config = MonteCarloConfig(
        model=args.model,
        cache_modes=modes,
        ber_levels=args.ber_levels if args.ber_levels is not None else list(BER_LEVELS),
        seeds=args.seeds,
        max_samples=args.max_samples,
        max_length=args.max_length,
        output_dir=args.output_dir,
        compute_kl=not args.no_kl,
        compute_top5=not args.no_top5,
        compute_catastrophic=not args.no_catastrophic,
        allow_random_init=not args.require_checkpoint,
        device=args.device,
    )
    results = run_monte_carlo_experiment(config)
    table = save_results(results, config)
    print(table)
    print(f"Results written to {config.output_dir}")
    return results


if __name__ == "__main__":
    main()
