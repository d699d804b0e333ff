"""Codec latency experiment: per-codec encode/decode timing across tensor
shapes with phase attribution and bandwidth efficiency (counterpart of
``qkv_ecc_tpu/evaluation/experiments/latency.py``, with its flags and one
more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.latency --trials 5

runs on the card (``--device cpu``: on the CPU). Each phase is timed on the
host clock with the card synchronised before and after it
(``timing.TimingContext``); the bandwidth efficiency is against the H100's
memory rate in ``constants.CHIP_BANDWIDTH_GBPS``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

import numpy as np
import torch

from ...codecs import (
    golay_decode,
    golay_encode,
    hamming74_decode,
    hamming74_encode,
    hamming84_decode,
    hamming84_encode,
)
from ...device import resolve_device
from ..constants import compute_bandwidth_efficiency
from ..timing import AggregatedTimingStats, TimingContext, TimingStats, run_warmup


@dataclasses.dataclass
class CodecBenchmarkConfig:
    codecs: List[str] = dataclasses.field(
        default_factory=lambda: ["hamming74", "hamming84", "golay"]
    )
    shapes: List[tuple] = dataclasses.field(
        default_factory=lambda: [(1 << 16,), (1 << 20,), (1 << 22,)]
    )
    trials: int = 5
    warmup: int = 2
    chip: str | None = None


_CODEC_FNS = {
    "hamming74": (hamming74_encode, hamming74_decode, 1),
    "hamming84": (hamming84_encode, hamming84_decode, 1),
    "golay": (golay_encode, golay_decode, 3),
}


def benchmark_codec(codec: str, shape: tuple, trials=5, warmup=2, *, device=None) -> Dict:
    """Roundtrip encode/decode timing with phase attribution on ``device``
    (None: the card)."""
    device = resolve_device(device)
    enc_fn, dec_fn, group = _CODEC_FNS[codec]
    rng = np.random.default_rng(0)
    host_vals = rng.integers(0, 16, shape + ((group,) if group > 1 else ()), dtype=np.uint8)
    n_values = host_vals.size
    host = torch.from_numpy(host_vals)

    agg = AggregatedTimingStats()
    run_warmup(lambda v: dec_fn(enc_fn(v))[0], host.to(device), iterations=warmup)

    on = torch.empty(0, device=device)  # each phase waits for this device
    for _ in range(trials):
        stats = TimingStats(values_processed=n_values)
        with TimingContext(stats, "host_to_device", on):
            vals = host.to(device)
        with TimingContext(stats, "encode", on):
            cw = enc_fn(vals)
        with TimingContext(stats, "decode", on):
            dec_fn(cw)
        agg.add(stats)

    bytes_per_value = {"hamming74": 1, "hamming84": 1, "golay": 4 / 3}[codec]
    return {
        "codec": codec,
        "shape": list(shape),
        "n_values": n_values,
        "encode_ms": agg.phase_ms_mean("encode"),
        "decode_ms": agg.phase_ms_mean("decode"),
        "total_ms_mean": agg.total_ms_mean,
        "total_ms_std": agg.total_ms_std,
        "throughput_mvalues_sec": agg.throughput_mean,
        "transfer_overhead_pct": agg.transfer_overhead_mean,
        "bandwidth_efficiency_pct": compute_bandwidth_efficiency(
            agg.throughput_mean, bytes_per_value
        ),
    }


def run_latency_experiment(config: CodecBenchmarkConfig | None = None, *,
                           device=None) -> List[Dict]:
    """Grid over codecs x shapes on ``device`` (None: the card)."""
    config = config or CodecBenchmarkConfig()
    results = []
    for codec in config.codecs:
        for shape in config.shapes:
            results.append(
                benchmark_codec(codec, shape, config.trials, config.warmup, device=device)
            )
    return results


def format_report(results: List[Dict]) -> str:
    lines = [
        f"{'codec':<12}{'n_values':>10}{'enc ms':>9}{'dec ms':>9}"
        f"{'Mval/s':>10}{'xfer %':>8}{'BW eff %':>10}",
        "-" * 68,
    ]
    for r in results:
        lines.append(
            f"{r['codec']:<12}{r['n_values']:>10}{r['encode_ms']:>9.2f}"
            f"{r['decode_ms']:>9.2f}{r['throughput_mvalues_sec']:>10.0f}"
            f"{r['transfer_overhead_pct']:>8.1f}{r['bandwidth_efficiency_pct']:>10.2f}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Codec latency experiment")
    p.add_argument("--output", default=None)
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = run_latency_experiment(CodecBenchmarkConfig(trials=args.trials),
                                     device=args.device)
    print(format_report(results))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
