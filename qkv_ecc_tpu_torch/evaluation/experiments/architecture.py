"""Architecture comparison: shows ECC protection generalizes across
combined-QKV (GPT-2) and separate-KV GQA (Llama) architectures (counterpart
of ``qkv_ecc_tpu/evaluation/experiments/architecture.py``, with its flags
and one more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.architecture \
        --output runs/architecture.json

runs the Monte-Carlo sweep (``sweep.run_sweep``) on each model on the card
(``--device cpu``: on the CPU). Both architectures are native model
definitions with the same KV policy interface, so no model sniffing is
needed.
"""

from __future__ import annotations

from typing import Dict, List

from ...models.config import get_model_config
from ..constants import MODELS
from ..data import load_wikitext2_test
from ..models import load_model
from ..sweep import SweepConfig, run_sweep


def analyze_architecture(model_name: str) -> Dict:
    """Structural facts relevant to KV protection, from the model's
    configuration (no weights are loaded)."""
    if model_name not in MODELS:
        raise ValueError(f"Unknown model: {model_name}. Known: {sorted(MODELS)}")
    cfg = get_model_config(MODELS[model_name]["config"])
    return {
        "model": model_name,
        "arch": cfg.arch,
        "kv_projection": "combined c_attn" if cfg.arch == "gpt2" else "separate k/v_proj",
        "num_heads": cfg.num_heads,
        "num_kv_heads": cfg.num_kv_heads,
        "gqa_ratio": cfg.num_heads // cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "kv_values_per_token": 2 * cfg.num_kv_heads * cfg.head_dim,
        "positional": "absolute learned" if cfg.arch == "gpt2" else "rotary",
    }


def run_architecture_comparison(
    models: List[str] | None = None,
    cache_modes: List[str] | None = None,
    ber_levels: List[float] | None = None,
    seeds: List[int] | None = None,
    max_samples: int = 4,
    max_length: int = 128,
    progress=print,
    *,
    device=None,
) -> Dict[str, Dict]:
    """Dual sweep across architectures on ``device`` (None: the card)."""
    models = models or ["tiny-gpt2", "tiny-llama"]
    cache_modes = cache_modes or ["int4", "int4-hamming84", "int12-golay"]
    ber_levels = ber_levels if ber_levels is not None else [0, 1e-2]
    seeds = seeds or [42]

    out = {}
    for name in models:
        progress(f"=== {name} ===")
        params, cfg, tokenizer = load_model(name, device=device)
        texts = load_wikitext2_test(max_samples=max_samples)
        sweep_cfg = SweepConfig(
            cache_modes=cache_modes,
            ber_levels=ber_levels,
            seeds=seeds,
            max_length=max_length,
            compute_kl_divergence=False,
            compute_top5=False,
            compute_catastrophic=False,
        )
        results = run_sweep(params, cfg, tokenizer, texts, sweep_cfg)
        out[name] = {
            "architecture": analyze_architecture(name),
            "results": results,
        }
    return out


def format_report(comparison: Dict[str, Dict]) -> str:
    lines = []
    for name, entry in comparison.items():
        arch = entry["architecture"]
        results = entry["results"]
        lines.append(f"\n{name} ({arch['kv_projection']}, GQA {arch['gqa_ratio']}:1)")
        lines.append("-" * 64)
        for mode, by_ber in results.aggregated.items():
            for ber, agg in sorted(by_ber.items()):
                lines.append(
                    f"  {mode:<24} BER={ber:<8.0e} "
                    f"PPL {agg.ppl_mean:8.2f} "
                    f"corrected {agg.errors_corrected_mean:10,.0f}"
                )
    return "\n".join(lines)


def plot_comparison(comparison: Dict[str, Dict], output_path: str) -> bool:
    """PPL-vs-BER line plot, one panel per architecture. Returns False if
    matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False

    names = list(comparison)
    fig, axes = plt.subplots(1, len(names), figsize=(7 * len(names), 5),
                             squeeze=False)
    for ax, name in zip(axes[0], names):
        entry = comparison[name]
        arch = entry["architecture"]
        for mode, by_ber in entry["results"].aggregated.items():
            pts = sorted(
                (max(ber, 1e-8), agg.ppl_mean) for ber, agg in by_ber.items()
            )
            ax.plot([b for b, _ in pts], [p for _, p in pts],
                    marker="o", linewidth=2, label=mode)
        ax.set_xscale("log")
        ax.set_xlabel("Bit Error Rate (BER)")
        ax.set_ylabel("Perplexity")
        ax.set_title(f"{name} ({arch['kv_projection']})")
        ax.legend()
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return True


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Architecture comparison experiment")
    p.add_argument("--models", nargs="+", default=["tiny-gpt2", "tiny-llama"])
    p.add_argument("--max-samples", type=int, default=4)
    p.add_argument("--output", default=None,
                   help="JSON path; a .txt report and a .png PPL-vs-BER "
                        "plot are written next to it")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    comparison = run_architecture_comparison(
        models=args.models, max_samples=args.max_samples, device=args.device
    )
    report = format_report(comparison)
    print(report)
    if args.output:
        import json
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        base = os.path.splitext(args.output)[0]
        if not plot_comparison(comparison, base + ".png"):
            print(
                "matplotlib unavailable; skipping PPL-vs-BER plot "
                f"({base}.png not written)"
            )
        with open(args.output, "w") as f:
            json.dump(comparison, f, indent=2, default=str)
        with open(base + ".txt", "w") as f:
            f.write(report + "\n")
    return comparison


if __name__ == "__main__":
    main()
