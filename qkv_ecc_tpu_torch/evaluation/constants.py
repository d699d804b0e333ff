"""The bandwidth part of ``qkv_ecc_tpu/evaluation/constants.py`` (:217-245):
the peak memory rates of the NVIDIA cards, for the kernel benchmark's
bandwidth efficiency. The TPU rates stay in the JAX package; the cache
modes, BER levels and model table come with the quality path."""

from __future__ import annotations

# Peak memory bandwidth (GB/s) of the NVIDIA cards (NVIDIA's data sheets)
CHIP_BANDWIDTH_GBPS = {
    "T4": 320.0,
    "A100-40GB": 1555.0,
    "A100-80GB": 2039.0,
    "H100": 3352.0,
}

DEFAULT_CHIP = "H100"


def get_chip_bandwidth(chip: str | None = None) -> float:
    """The chip's peak GB/s; an unknown or absent name reads the default
    chip's."""
    if chip is None:
        chip = DEFAULT_CHIP
    return CHIP_BANDWIDTH_GBPS.get(chip, CHIP_BANDWIDTH_GBPS[DEFAULT_CHIP])


def compute_bandwidth_efficiency(
    throughput_mvalues_sec: float, bytes_per_value: float = 1.0, chip: str | None = None
) -> float:
    """Percent of the chip's peak memory rate that the throughput moves."""
    peak = get_chip_bandwidth(chip)
    achieved = throughput_mvalues_sec * bytes_per_value / 1000.0
    return 100.0 * achieved / peak
