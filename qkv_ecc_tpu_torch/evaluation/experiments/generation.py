"""Generation degradation demo: greedy text generation under each cache
mode at a high BER, with failure-pattern analysis (counterpart of
``qkv_ecc_tpu/evaluation/experiments/generation.py``, with its flags and
one more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.generation \
        --model trained-tiny --output runs/generation.json

decodes on the card through the paged-cache kernels (``--device cpu``:
their plain versions on the CPU): greedy ``runtime.generate`` per mode at
BER 0.05, repetition-loop detection, agreement with a clean golay run.
"""

from __future__ import annotations

from typing import Dict, List

from ...models.kv_policy import policy_for_mode
from ...models.registry import _params_device
from ...models.runtime import FUSED_CODECS, generate
from ..data import tokenize
from ..models import load_model


def analyze_generation(token_ids: List[int]) -> Dict:
    """Detect degenerate patterns: repetition loops and low diversity."""
    ids = list(map(int, token_ids))
    n = len(ids)
    analysis = {
        "length": n,
        "unique_ratio": len(set(ids)) / n if n else 0.0,
        "repetition_loop": False,
        "loop_period": 0,
    }
    # period-p loop detection over the tail
    for period in range(1, min(8, n // 3) + 1):
        tail = ids[-3 * period :]
        if len(tail) == 3 * period and tail[:period] == tail[period : 2 * period] == tail[2 * period :]:
            analysis["repetition_loop"] = True
            analysis["loop_period"] = period
            break
    return analysis


def run_generation_demo(
    model_name: str = "tiny-gpt2",
    prompt: str = "The future of machine learning is",
    cache_modes: List[str] | None = None,
    ber: float = 0.05,
    max_new_tokens: int = 32,
    seed: int = 42,
    progress=print,
    *,
    device=None,
) -> Dict[str, Dict]:
    """Generate under each mode and analyze degradation, on ``device``
    (None: the card)."""
    params, cfg, tokenizer = load_model(model_name, device=device)
    device = _params_device(params)
    if cache_modes is None:
        cache_modes = ["int4", "int4-hamming", "int4-hamming84", "int12-golay"]

    ids = tokenize(tokenizer, prompt)
    results = {}
    for mode in cache_modes:
        policy = policy_for_mode(mode, ber=ber, seed=seed)
        if policy.codec not in FUSED_CODECS:
            progress(f"  [skip] {mode}: codec not in the generation path")
            continue
        out = generate(params, ids, cfg, policy, max_new_tokens=max_new_tokens, device=device)
        new_tokens = out[0, ids.shape[1] :].cpu().tolist()
        text = tokenizer.decode(new_tokens)
        results[mode] = {
            "tokens": new_tokens,
            "text": text,
            "analysis": analyze_generation(new_tokens),
        }
        progress(f"  {mode:24s} -> {text[:60]!r}")
    # clean baseline for agreement scoring
    clean_policy = policy_for_mode("int12-golay", ber=0.0)
    clean = generate(params, ids, cfg, clean_policy, max_new_tokens=max_new_tokens,
                     device=device)
    clean_tokens = clean[0, ids.shape[1] :].cpu()
    for mode, r in results.items():
        r["agreement_with_clean"] = float(
            (clean_tokens == clean_tokens.new_tensor(r["tokens"])).float().mean())
    return results


def format_report(results: Dict[str, Dict]) -> str:
    lines = [
        f"{'mode':<24}{'agree':>7}{'unique':>8}{'loop':>6}  text",
        "-" * 90,
    ]
    for mode, r in results.items():
        a = r["analysis"]
        lines.append(
            f"{mode:<24}{r['agreement_with_clean']:>6.0%}{a['unique_ratio']:>8.2f}"
            f"{str(a['repetition_loop']):>6}  {r['text'][:48]!r}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Generation degradation demo")
    p.add_argument("--model", default="tiny-gpt2")
    p.add_argument("--ber", type=float, default=0.05)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--output", default=None,
                   help="JSON path; a .txt report is written next to it")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = run_generation_demo(
        args.model, ber=args.ber, max_new_tokens=args.max_new_tokens, device=args.device
    )
    report = format_report(results)
    print(report)
    if args.output:
        import json
        import os

        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2, default=str)
        with open(os.path.splitext(args.output)[0] + ".txt", "w") as f:
            f.write(report + "\n")
    return results


if __name__ == "__main__":
    main()
