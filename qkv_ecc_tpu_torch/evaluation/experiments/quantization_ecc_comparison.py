"""Quantization x ECC cross-product quality study: quantization MSE vs
post-ECC MSE per (quantizer backend, codec, BER) (counterpart of
``qkv_ecc_tpu/evaluation/experiments/quantization_ecc_comparison.py``, with
its flags and one more, ``--device``):

    python -m qkv_ecc_tpu_torch.evaluation.experiments.quantization_ecc_comparison

6 backends x 4 ECC arms x BER levels with MSE aggregation and a table, on
the card (``--device cpu``: on the CPU). The flips are the port's seeded
draws (``codecs.inject_bit_errors``), statistically JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ...codecs import (
    QuantizationConfig,
    QuantizationMode,
    get_quantizer,
    golay_decode,
    golay_encode,
    hamming74_decode,
    hamming74_encode,
    hamming84_decode,
    hamming84_encode,
    inject_bit_errors,
    interpolate_double_errors,
)
from ...device import resolve_device


@dataclasses.dataclass
class QuantEccConfig:
    backends: List[str] = dataclasses.field(
        default_factory=lambda: [
            "block_absmax", "per_token", "per_channel",
            "kivi", "kivi_symmetric", "group_wise",
        ]
    )
    ecc_arms: List[str] = dataclasses.field(
        default_factory=lambda: ["none", "hamming74", "hamming84", "golay"]
    )
    ber_levels: List[float] = dataclasses.field(
        default_factory=lambda: [0.0, 1e-3, 1e-2, 5e-2]
    )
    trials: int = 3
    shape: tuple = (64, 8, 64)


def _apply_ecc(q_data: torch.Tensor, ecc: str, ber: float, seed: int):
    """INT4 nibbles -> encode -> inject -> decode -> INT4 nibbles. Returns
    (nibbles, corrected, detected or uncorrectable)."""
    if ecc == "none":
        if ber > 0:
            q_data = inject_bit_errors(q_data, ber, 4, seed=seed)
        return q_data & 0xF, 0, 0
    if ecc == "hamming74":
        cw = hamming74_encode(q_data)
        if ber > 0:
            cw = inject_bit_errors(cw, ber, 7, seed=seed)
        data, _, corrected = hamming74_decode(cw)
        return data, int(corrected), 0
    if ecc == "hamming84":
        cw = hamming84_encode(q_data)
        if ber > 0:
            cw = inject_bit_errors(cw, ber, 8, seed=seed)
        data, et, corrected, detected = hamming84_decode(cw)
        data = interpolate_double_errors(data, et, seq_dim=0)
        return data, int(corrected), int(detected)
    if ecc == "golay":
        flat = q_data.reshape(-1)
        pad = (-flat.shape[0]) % 3
        flat = torch.nn.functional.pad(flat, (0, pad))
        cw = golay_encode(flat.reshape(-1, 3))
        if ber > 0:
            cw = inject_bit_errors(cw, ber, 24, seed=seed)
        trip, _, corrected, unc = golay_decode(cw)
        data = trip.reshape(-1)
        if pad:
            data = data[:-pad]
        return data.reshape(q_data.shape), int(corrected), int(unc)
    raise ValueError(ecc)


def run_quantization_ecc_comparison(config: QuantEccConfig | None = None, progress=print, *,
                                    device=None):
    """Main cross-product loop on ``device`` (None: the card). The inputs
    are JAX's: N(0, 1) values from numpy's default_rng(0), in its order."""
    config = config or QuantEccConfig()
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    results = []
    for backend in config.backends:
        quantizer = get_quantizer(
            backend, QuantizationConfig(block_size=32, group_size=32)
        )
        for ecc in config.ecc_arms:
            for ber in config.ber_levels:
                mses, quant_mses, corrected_total, detected_total = [], [], 0, 0
                for trial in range(config.trials):
                    x = torch.from_numpy(
                        rng.normal(size=config.shape).astype(np.float32)
                    ).to(device)
                    qt = quantizer.quantize(x, QuantizationMode.VALUE)
                    quant_mses.append(
                        float(torch.mean((x - quantizer.dequantize(qt)) ** 2))
                    )
                    corrupted, corrected, detected = _apply_ecc(
                        qt.data, ecc, ber, seed=trial * 7919 + 13
                    )
                    qt2 = dataclasses.replace(qt, data=corrupted)
                    x2 = quantizer.dequantize(qt2)
                    mses.append(float(torch.mean((x - x2) ** 2)))
                    corrected_total += corrected
                    detected_total += detected
                results.append(
                    {
                        "backend": backend,
                        "ecc": ecc,
                        "ber": ber,
                        "quant_mse": sum(quant_mses) / len(quant_mses),
                        "post_ecc_mse": sum(mses) / len(mses),
                        "mse_amplification": (
                            sum(mses) / max(sum(quant_mses), 1e-12)
                        ),
                        "errors_corrected": corrected_total,
                        "errors_detected": detected_total,
                    }
                )
        progress(f"  {backend}: done")
    return results


def format_table(results: List[Dict]) -> str:
    """MSE amplification table."""
    lines = [
        f"{'backend':<16}{'ecc':<12}{'BER':>8}{'quant MSE':>12}{'post MSE':>12}{'amp':>8}",
        "-" * 68,
    ]
    for r in results:
        lines.append(
            f"{r['backend']:<16}{r['ecc']:<12}{r['ber']:>8.0e}"
            f"{r['quant_mse']:>12.5f}{r['post_ecc_mse']:>12.5f}"
            f"{r['mse_amplification']:>8.1f}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description="Quantization x ECC matrix study")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    results = run_quantization_ecc_comparison(QuantEccConfig(trials=args.trials),
                                              device=args.device)
    print(format_table(results))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
