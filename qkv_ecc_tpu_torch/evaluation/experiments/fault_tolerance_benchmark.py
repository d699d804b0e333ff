"""System-level fault-tolerance comparison: the unprotected INT4 cache
against the ECC-protected ones under injected faults - decode throughput,
per-token latency, memory, and PPL-vs-BER (counterpart of
``qkv_ecc_tpu/evaluation/experiments/fault_tolerance_benchmark.py``, with
its flags and one more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.fault_tolerance_benchmark \
        --grid --output runs/fault_tolerance.json

decodes on the card through the paged-cache kernels (``--device cpu``:
their plain versions on the CPU). Arms: int4 (the baseline, no ECC),
int12-golay and int4-hamming84, with the same fault-injection machinery.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, List

import numpy as np
import torch

from ...models.kv_policy import KVCachePolicy, policy_for_mode, stream_seed
from ...models.registry import _params_device, loss_and_stats
from ...models.runtime import decode_loop, init_generation_state, prefill
from ..data import load_wikitext2_test, pad_to_bucket, tokenize
from ..models import load_model
from ..timing import synchronize


@dataclasses.dataclass
class FaultToleranceConfig:
    model: str = "tiny-llama"
    batch: int = 4
    prompt_len: int = 32
    decode_tokens: int = 32
    ber_levels: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 1e-3, 1e-2]
    )
    arms: List[str] = dataclasses.field(
        default_factory=lambda: ["int4", "int12-golay", "int4-hamming84"]
    )
    seeds: List[int] = dataclasses.field(default_factory=lambda: [42])
    max_samples: int = 4


def benchmark_decode_throughput(
    params, cfg, policy: KVCachePolicy, batch: int, prompt_len: int,
    decode_tokens: int,
) -> Dict:
    """Steady-state decode throughput (tokens/s) and per-token latency on
    the parameters' device: a warm-up round, then the faster of two timed
    rounds of ``decode_tokens`` greedy steps, each waited for (the card
    synchronised)."""
    device = _params_device(params)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)
    # capacity covers warmup + BOTH timed rounds
    state, block_table, _ = init_generation_state(
        cfg, policy, batch, prompt_len + 3 * decode_tokens + 8, device=device
    )
    gen = torch.Generator(device=device).manual_seed(policy.seed)
    logits, state = prefill(params, ids, state, block_table, cfg, policy, gen)
    logits, state, toks = decode_loop(
        params, logits, state, block_table, cfg, policy, gen, decode_tokens
    )
    synchronize(toks)

    dt = float("inf")
    for r in range(2):
        gen = torch.Generator(device=device).manual_seed(stream_seed(policy.seed, 1 + r))
        t0 = time.perf_counter()
        logits, state, toks = decode_loop(
            params, logits, state, block_table, cfg, policy, gen, decode_tokens
        )
        synchronize(toks)
        dt = min(dt, time.perf_counter() - t0)

    cache_bytes = sum(
        v.numel() * v.element_size() for k, v in state.items() if k != "context_len"
    )
    return {
        "codec": policy.codec,
        "ber": policy.ber,
        "batch": batch,
        "decode_tokens_per_sec": batch * decode_tokens / dt,
        "ms_per_token": dt / decode_tokens * 1e3,
        "cache_bytes": cache_bytes,
        "cache_gb": cache_bytes / 1e9,
    }


def peak_memory_stats(device=None, held_bytes: int = 0) -> Dict:
    """Live/peak device memory accounting with JAX's keys. On a CUDA
    device: bytes_in_use and peak_bytes_in_use from the caching
    allocator's statistics (torch.cuda.memory_stats), bytes_limit the
    card's memory (torch.cuda.mem_get_info), live_array_bytes the bytes
    allocated. Elsewhere live_array_bytes is ``held_bytes``, what the
    caller's generation state holds."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    out: Dict = {}
    if device.type == "cuda":
        stats = torch.cuda.memory_stats(device)
        out["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
        out["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
        out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
        out["live_array_bytes"] = out["bytes_in_use"]
    else:
        out["live_array_bytes"] = int(held_bytes)
    return out


def benchmark_grid(
    params, cfg, arms: List[str], batches=(1, 4, 8), contexts=(256, 1024),
    decode_tokens: int = 32, progress=print,
) -> List[Dict]:
    """tokens/s, ms/token, cache and peak memory over a batch x context
    grid per arm (on a card each cell's peak is its own: the allocator's
    peak is reset before it)."""
    device = _params_device(params)
    out = []
    for arm in arms:
        for batch in batches:
            for ctx in contexts:
                policy = policy_for_mode(arm, ber=0.0, seed=42)
                if device.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(device)
                r = benchmark_decode_throughput(
                    params, cfg, policy, batch, ctx, decode_tokens
                )
                r.update({"arm": arm, "context_len": ctx})
                r["memory"] = peak_memory_stats(device, r["cache_bytes"])
                out.append(r)
                peak = r["memory"].get(
                    "peak_bytes_in_use", r["memory"]["live_array_bytes"]
                )
                progress(
                    f"  {arm:<18} b={batch:<3} ctx={ctx:<6} "
                    f"{r['decode_tokens_per_sec']:8.1f} tok/s "
                    f"{r['ms_per_token']:6.2f} ms/tok "
                    f"cache {r['cache_gb']*1e3:7.1f} MB peak {peak/1e9:.2f} GB"
                )
    return out


def format_grid_tables(grid: List[Dict]) -> str:
    """batch x context tables per arm: throughput, latency, memory."""
    arms = sorted({r["arm"] for r in grid})
    batches = sorted({r["batch"] for r in grid})
    contexts = sorted({r["context_len"] for r in grid})

    def cell(arm, b, c, key, fmt):
        for r in grid:
            if r["arm"] == arm and r["batch"] == b and r["context_len"] == c:
                return fmt.format(r[key])
        return "-"

    lines = []
    for title, key, fmt in (
        ("THROUGHPUT (tokens/s)", "decode_tokens_per_sec", "{:10.1f}"),
        ("LATENCY (ms/token)", "ms_per_token", "{:10.2f}"),
        ("KV CACHE (MB)", "cache_gb", None),
    ):
        lines += [title, "-" * 72]
        header = f"{'arm':<20}{'batch':>6}" + "".join(
            f"{'ctx=' + str(c):>12}" for c in contexts
        )
        lines.append(header)
        for arm in arms:
            for b in batches:
                row = f"{arm:<20}{b:>6}"
                for c in contexts:
                    if key == "cache_gb":
                        row += f"{float(cell(arm, b, c, key, '{}') or 0)*1e3:>12.1f}"
                    else:
                        row += f"{cell(arm, b, c, key, fmt):>12}"
                lines.append(row)
        lines.append("")
    return "\n".join(lines)


def benchmark_ppl_vs_ber(
    params, cfg, tokenizer, texts, arms: List[str], ber_levels: List[float],
    seeds: List[int], max_length: int = 128,
) -> List[Dict]:
    """PPL per (arm, BER): one forward per text on the parameters'
    device."""
    out = []
    for arm in arms:
        for ber in ber_levels:
            ppls = []
            for seed in seeds:
                policy = policy_for_mode(arm, ber=ber, seed=seed)
                total_loss, total_tokens = 0.0, 0
                for text in texts:
                    ids = tokenize(tokenizer, text, max_length)
                    if ids.shape[1] < 2:
                        continue
                    padded, labels, L = pad_to_bucket(ids)
                    loss, count, _, _ = loss_and_stats(params, padded, labels, cfg, policy)
                    total_loss += float(loss) * L
                    total_tokens += L
                ppls.append(
                    math.exp(total_loss / total_tokens) if total_tokens else float("inf")
                )
            out.append(
                {
                    "arm": arm,
                    "ber": ber,
                    "ppl_mean": sum(ppls) / len(ppls),
                    "ppl_values": ppls,
                }
            )
    return out


def run_ber_sweep_comparison(config: FaultToleranceConfig | None = None, progress=print, *,
                             device=None):
    """Full system comparison on ``device`` (None: the card)."""
    config = config or FaultToleranceConfig()
    params, cfg, tokenizer = load_model(config.model, device=device)
    texts = load_wikitext2_test(max_samples=config.max_samples)

    progress("== decode throughput ==")
    throughput = []
    for arm in config.arms:
        policy = policy_for_mode(arm, ber=0.0, seed=42)
        r = benchmark_decode_throughput(
            params, cfg, policy, config.batch, config.prompt_len, config.decode_tokens
        )
        throughput.append(r)
        progress(
            f"  {arm:<18} {r['decode_tokens_per_sec']:8.1f} tok/s "
            f"{r['ms_per_token']:6.2f} ms/tok cache {r['cache_gb']*1e3:.1f} MB"
        )

    progress("== PPL vs BER ==")
    ppl = benchmark_ppl_vs_ber(
        params, cfg, tokenizer, texts, config.arms, config.ber_levels, config.seeds
    )
    for r in ppl:
        progress(f"  {r['arm']:<18} BER={r['ber']:<8.0e} PPL {r['ppl_mean']:.3f}")

    base = next(
        (t for t in throughput if t["codec"] == "int4"), throughput[0]
    )
    for t in throughput:
        t["overhead_vs_unprotected"] = (
            base["decode_tokens_per_sec"] / t["decode_tokens_per_sec"]
        )
    return {"throughput": throughput, "ppl_vs_ber": ppl}


def format_report(results: Dict) -> str:
    lines = ["THROUGHPUT", "-" * 70]
    for t in results["throughput"]:
        lines.append(
            f"  {t['codec']:<14}{t['decode_tokens_per_sec']:>10.1f} tok/s"
            f"{t['ms_per_token']:>9.2f} ms/tok"
            f"{t['overhead_vs_unprotected']:>8.2f}x vs int4"
            f"{t['cache_gb'] * 1e3:>9.1f} MB cache"
        )
    lines += ["", "PPL vs BER", "-" * 70]
    for r in results["ppl_vs_ber"]:
        lines.append(f"  {r['arm']:<18} BER={r['ber']:<10.0e} PPL {r['ppl_mean']:.3f}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    import os

    p = argparse.ArgumentParser(description="System fault-tolerance benchmark")
    p.add_argument("--model", default="tiny-llama")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--decode-tokens", type=int, default=32)
    p.add_argument(
        "--grid", action="store_true",
        help="also run the batch x context throughput/latency/memory grid",
    )
    p.add_argument("--grid-batches", type=int, nargs="+", default=[1, 4, 8])
    p.add_argument("--grid-contexts", type=int, nargs="+", default=[256, 1024])
    p.add_argument("--output", default=None,
                   help="JSON path; a .txt report is written next to it")
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = run_ber_sweep_comparison(
        FaultToleranceConfig(
            model=args.model, batch=args.batch, decode_tokens=args.decode_tokens
        ),
        device=args.device,
    )
    report = format_report(results)
    if args.grid:
        params, cfg, _ = load_model(args.model, device=args.device)
        grid = benchmark_grid(
            params, cfg, FaultToleranceConfig().arms,
            batches=tuple(args.grid_batches),
            contexts=tuple(args.grid_contexts),
            decode_tokens=args.decode_tokens,
        )
        results["grid"] = grid
        report += "\n\n" + format_grid_tables(grid)
    print(report)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2, default=str)
        with open(os.path.splitext(args.output)[0] + ".txt", "w") as f:
            f.write(report + "\n")
    return results


if __name__ == "__main__":
    main()
