"""Monte-Carlo parameter sweep with statistical aggregation (counterpart of
``qkv_ecc_tpu/evaluation/sweep.py``): the (cache_mode x BER x seed)
experiment engine with Bessel-corrected std and Student-t 95% CIs, and a
JSONL checkpoint of finished trials that a restarted sweep resumes from.

A trial drives the port's models on the parameters' device. The flips of a
forward are drawn per (seed, layer, K or V) and shape, as
``kv_policy.process_kv`` draws them on every call, so within a trial every
text and every pass (loss, KL, top-5, the per-sample windows) sees the same
pattern for its shape, as in JAX; the texts of one length therefore run as
one batch (``metrics.forward_rows``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from dataclasses import field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..models.kv_policy import decode_kv, encode_kv, policy_for_mode
from ..models.registry import _params_device
from .constants import BER_LEVELS, CACHE_MODE_ORDER, DEFAULT_CONFIG
from .data import pad_to_bucket, tokenize
from .metrics import (
    compute_catastrophic_rate,
    compute_mean_kl_divergence,
    compute_per_sample_perplexity,
    compute_top5_accuracy,
    forward_rows,
)
from .timing import synchronize, time_fn_chained


@dataclasses.dataclass
class SweepConfig:
    cache_modes: List[str] = field(default_factory=lambda: list(CACHE_MODE_ORDER))
    ber_levels: List[float] = field(default_factory=lambda: list(BER_LEVELS))
    seeds: List[int] = field(default_factory=lambda: [42])
    aggregate_seeds: bool = True

    max_length: int = DEFAULT_CONFIG["max_length"]
    stride: int = DEFAULT_CONFIG["stride"]
    block_size: int = DEFAULT_CONFIG["block_size"]

    compute_kl_divergence: bool = True
    compute_top5: bool = True
    compute_catastrophic: bool = True
    catastrophic_threshold: float = 1000.0

    clean_logits: Optional[List[Any]] = None

    enable_timing: bool = False
    warmup_iterations: int = 3

    # Trial-level checkpointing: completed (mode, ber, seed) trials are
    # appended as JSON lines; a restarted sweep skips them.
    checkpoint_path: Optional[str] = None

    @classmethod
    def default(cls) -> "SweepConfig":
        return cls()

    @classmethod
    def full(cls) -> "SweepConfig":
        from .constants import get_ber_levels, get_cache_modes, get_seeds

        return cls(
            cache_modes=get_cache_modes(),
            ber_levels=get_ber_levels(),
            seeds=get_seeds(),
        )

    @classmethod
    def with_timing(cls) -> "SweepConfig":
        return cls(enable_timing=True, warmup_iterations=3)

    def fingerprint(self, model_cfg=None, texts=None) -> str:
        """Stable hash of everything that determines a trial's result, stored
        with each checkpoint record so a resumed sweep only reuses trials of
        an identical experiment (eval protocol, model and data)."""
        import hashlib

        parts = [
            f"max_length={self.max_length}",
            f"stride={self.stride}",
            f"block_size={self.block_size}",
            f"catastrophic_threshold={self.catastrophic_threshold}",
        ]
        if model_cfg is not None:
            parts.append(f"model={model_cfg}")
        if texts is not None:
            h = hashlib.sha256("\x00".join(texts).encode()).hexdigest()[:16]
            parts.append(f"texts={len(texts)}:{h}")
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


@dataclasses.dataclass
class TrialResult:
    cache_mode: str
    ber: float
    seed: int
    perplexity: float
    errors_corrected: int = 0
    errors_detected: int = 0
    total_values: int = 0

    kl_divergence: float = 0.0
    top5_accuracy: float = 1.0
    catastrophic_rate: float = 0.0

    encode_time_ms: float = 0.0
    decode_time_ms: float = 0.0
    throughput_mvalues_sec: float = 0.0
    transfer_overhead_pct: float = 0.0
    is_cpu_bound: bool = False

    injection_count: int = 0
    bits_flipped: int = 0
    correction_rate: float = 0.0
    detection_rate: float = 0.0
    silent_corruption_rate: float = 0.0

    @property
    def computed_correction_rate(self) -> float:
        total = self.errors_corrected + self.errors_detected
        return self.errors_corrected / total if total else 0.0

    @property
    def computed_detection_rate(self) -> float:
        total = self.errors_corrected + self.errors_detected
        return self.errors_detected / total if total else 0.0


def _t_critical_95(df: int) -> float:
    """Two-tailed t-critical at alpha=0.05 with table + interpolation."""
    t_table = {
        1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571,
        6: 2.447, 7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228,
        11: 2.201, 12: 2.179, 13: 2.160, 14: 2.145, 15: 2.131,
        16: 2.120, 17: 2.110, 18: 2.101, 19: 2.093, 20: 2.086,
        25: 2.060, 30: 2.042, 40: 2.021, 50: 2.009, 100: 1.984,
    }
    if df in t_table:
        return t_table[df]
    if df > 100:
        return 1.96
    lower = max(k for k in t_table if k < df)
    upper = min(k for k in t_table if k > df)
    frac = (df - lower) / (upper - lower)
    return t_table[lower] + frac * (t_table[upper] - t_table[lower])


@dataclasses.dataclass
class AggregatedResult:
    cache_mode: str
    ber: float
    ppl_mean: float
    ppl_std: float
    errors_corrected_mean: float
    errors_detected_mean: float
    total_values: int
    n_trials: int

    kl_divergence_mean: float = 0.0
    kl_divergence_std: float = 0.0
    top5_accuracy_mean: float = 1.0
    top5_accuracy_std: float = 0.0
    catastrophic_rate_mean: float = 0.0
    catastrophic_rate_std: float = 0.0

    encode_time_ms_mean: float = 0.0
    decode_time_ms_mean: float = 0.0
    throughput_mvalues_sec_mean: float = 0.0

    injection_count_mean: float = 0.0
    correction_rate_mean: float = 0.0
    correction_rate_std: float = 0.0
    detection_rate_mean: float = 0.0
    detection_rate_std: float = 0.0

    ppl_ci95: float = 0.0
    kl_divergence_ci95: float = 0.0
    top5_accuracy_ci95: float = 0.0
    catastrophic_rate_ci95: float = 0.0

    @classmethod
    def from_trials(cls, trials: List[TrialResult]) -> "AggregatedResult":
        """Means, Bessel-corrected stds and t-based CIs over the trials in
        Python floats, as JAX's: an infinite perplexity makes the mean inf
        and the std and CI NaN."""
        if not trials:
            raise ValueError("Cannot aggregate empty trial list")
        n = len(trials)
        t_crit = _t_critical_95(n - 1 if n > 1 else 1)

        def msc(values):
            m = sum(values) / len(values)
            if len(values) > 1:
                s = (sum((v - m) ** 2 for v in values) / (len(values) - 1)) ** 0.5
                ci = t_crit * s / (len(values) ** 0.5)
            else:
                s, ci = 0.0, 0.0
            return m, s, ci

        ppl_m, ppl_s, ppl_ci = msc([t.perplexity for t in trials])
        kl_m, kl_s, kl_ci = msc([t.kl_divergence for t in trials])
        t5_m, t5_s, t5_ci = msc([t.top5_accuracy for t in trials])
        cat_m, cat_s, cat_ci = msc([t.catastrophic_rate for t in trials])
        cr_m, cr_s, _ = msc([t.correction_rate for t in trials])
        dr_m, dr_s, _ = msc([t.detection_rate for t in trials])

        return cls(
            cache_mode=trials[0].cache_mode,
            ber=trials[0].ber,
            ppl_mean=ppl_m,
            ppl_std=ppl_s,
            errors_corrected_mean=sum(t.errors_corrected for t in trials) / n,
            errors_detected_mean=sum(t.errors_detected for t in trials) / n,
            total_values=trials[0].total_values,
            n_trials=n,
            kl_divergence_mean=kl_m,
            kl_divergence_std=kl_s,
            top5_accuracy_mean=t5_m,
            top5_accuracy_std=t5_s,
            catastrophic_rate_mean=cat_m,
            catastrophic_rate_std=cat_s,
            encode_time_ms_mean=sum(t.encode_time_ms for t in trials) / n,
            decode_time_ms_mean=sum(t.decode_time_ms for t in trials) / n,
            throughput_mvalues_sec_mean=sum(t.throughput_mvalues_sec for t in trials) / n,
            injection_count_mean=sum(t.injection_count for t in trials) / n,
            correction_rate_mean=cr_m,
            correction_rate_std=cr_s,
            detection_rate_mean=dr_m,
            detection_rate_std=dr_s,
            ppl_ci95=ppl_ci,
            kl_divergence_ci95=kl_ci,
            top5_accuracy_ci95=t5_ci,
            catastrophic_rate_ci95=cat_ci,
        )


@dataclasses.dataclass
class SweepResults:
    config: SweepConfig
    trials: List[TrialResult] = field(default_factory=list)
    aggregated: Dict[str, Dict[float, AggregatedResult]] = field(default_factory=dict)

    def get_aggregated(self, cache_mode: str, ber: float):
        return self.aggregated.get(cache_mode, {}).get(ber)

    def get_trials(self, cache_mode=None, ber=None, seed=None):
        result = self.trials
        if cache_mode is not None:
            result = [t for t in result if t.cache_mode == cache_mode]
        if ber is not None:
            result = [t for t in result if t.ber == ber]
        if seed is not None:
            result = [t for t in result if t.seed == seed]
        return result


def run_single_trial(
    params, model_cfg, tokenizer, texts, cache_mode: str, ber: float,
    seed: int, config: SweepConfig,
) -> TrialResult:
    """One (mode, BER, seed) trial: each text's forward at max_length with
    labels=input_ids, PPL = exp(token-weighted mean loss) over the texts
    whose loss is finite, their ECC counts summed; then the KL, top-5 and
    catastrophic passes that the config asks for."""
    policy = policy_for_mode(cache_mode, ber=ber, seed=seed)

    rows, lengths = [], []
    for text in texts:
        if not text.strip():
            continue
        ids = tokenize(tokenizer, text, config.max_length)
        if ids.shape[1] < 2:
            continue
        padded, labels, seq_len = pad_to_bucket(ids, bucket=32)
        rows.append((padded, labels))
        lengths.append(seq_len)
    # each text's loss and ECC counts (the texts of one length run as one
    # batch and share their flips, so a text's counts are the batch's / B)
    per_text = [None] * len(rows)
    for idx, _, losses, stats in forward_rows(params, model_cfg, policy, [r[0] for r in rows],
                                              [r[1] for r in rows]):
        counts = {k: int(v) for k, v in stats.items()}
        if any(v % len(idx) for v in counts.values()):
            raise RuntimeError(f"ECC counts {counts} do not split over {len(idx)} texts")
        for i, loss in zip(idx, losses):
            per_text[i] = (loss, {k: v // len(idx) for k, v in counts.items()})

    total_loss = 0.0
    total_tokens = 0
    agg_stats = {
        "errors_corrected": 0,
        "errors_detected": 0,
        "total_values": 0,
        "bits_flipped": 0,
    }
    injection_count = 0
    for (loss, stats), seq_len in zip(per_text, lengths):
        if math.isnan(loss) or math.isinf(loss):
            continue
        total_loss += loss * seq_len
        total_tokens += seq_len
        for k in agg_stats:
            agg_stats[k] += stats[k]
        if policy.inject_errors:
            injection_count += model_cfg.num_layers

    ppl = float("inf") if total_tokens == 0 else math.exp(total_loss / total_tokens)

    kl_div, top5_acc, cat_rate = 0.0, 1.0, 0.0
    if config.compute_kl_divergence and config.clean_logits is not None:
        kl_div = compute_mean_kl_divergence(
            params, model_cfg, policy, tokenizer, texts, config.clean_logits,
            max_length=config.max_length,
        )
    if config.compute_top5:
        top5_acc = compute_top5_accuracy(
            params, model_cfg, policy, tokenizer, texts, max_length=config.max_length
        )
    if config.compute_catastrophic:
        per_sample = compute_per_sample_perplexity(
            params, model_cfg, policy, tokenizer, texts,
            max_length=config.max_length, stride=config.stride,
        )
        cat_rate = compute_catastrophic_rate(
            per_sample, threshold=config.catastrophic_threshold
        )

    timing_fields = {}
    if config.enable_timing:
        timing_fields = _measure_trial_timing(model_cfg, policy, config,
                                              _params_device(params))

    corrected = agg_stats["errors_corrected"]
    detected = agg_stats["errors_detected"]
    total_events = corrected + detected
    return TrialResult(
        cache_mode=cache_mode,
        ber=ber,
        seed=seed,
        perplexity=ppl,
        errors_corrected=corrected,
        errors_detected=detected,
        total_values=agg_stats["total_values"],
        bits_flipped=agg_stats["bits_flipped"],
        kl_divergence=kl_div,
        top5_accuracy=top5_acc,
        catastrophic_rate=cat_rate,
        injection_count=injection_count,
        correction_rate=corrected / total_events if total_events else 0.0,
        detection_rate=detected / total_events if total_events else 0.0,
        **timing_fields,
    )


def _measure_trial_timing(model_cfg, policy, config, device):
    """TrialResult's timing fields (enable_timing=True): the codec's encode
    and decode times at the trial's per-layer K/V shape on ``device``
    (``time_fn_chained``: CUDA events on the card, the host clock on the
    CPU), and the host->device upload of the same values relative to the
    decode (is_cpu_bound when the upload takes longer)."""
    if policy.codec in ("fp16", "fp8"):
        return {}
    D = model_cfg.head_dim
    shape = (1, config.max_length, model_cfg.num_kv_heads, D)
    host = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    x = torch.from_numpy(host).to(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def enc(t):
        return encode_kv(t, policy, gen)[0]

    cw, scale, _ = encode_kv(x, policy, gen)

    def dec(c):
        return decode_kv(c, scale, policy, head_dim=D)[0]

    it = max(3, config.warmup_iterations)
    enc_s = time_fn_chained(enc, x, iters=it)
    dec_s = time_fn_chained(dec, cw, iters=it)
    n = x.numel()
    t0 = time.perf_counter()
    uploaded = torch.from_numpy(host).to(device)
    synchronize(uploaded)
    xfer_s = time.perf_counter() - t0
    total = dec_s + xfer_s
    return {
        "encode_time_ms": enc_s * 1e3,
        "decode_time_ms": dec_s * 1e3,
        "throughput_mvalues_sec": n / dec_s / 1e6 if dec_s > 0 else 0.0,
        "transfer_overhead_pct": 100.0 * xfer_s / total if total > 0 else 0.0,
        "is_cpu_bound": xfer_s > dec_s,
    }


def load_sweep_checkpoint(path, fingerprint: str = None) -> Dict[tuple, TrialResult]:
    """Completed trials from a JSONL checkpoint, keyed by (cache_mode, ber,
    seed). Records whose ``config_fingerprint`` differs from
    ``fingerprint`` are skipped (another experiment's); records without one
    are accepted only when no fingerprint is required."""
    done: Dict[tuple, TrialResult] = {}
    if path is None or not os.path.exists(path):
        return done
    trial_fields = {f.name for f in dataclasses.fields(TrialResult)}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            raw = json.loads(line)
            if fingerprint is not None and raw.get("config_fingerprint") != fingerprint:
                continue
            t = TrialResult(**{k: v for k, v in raw.items() if k in trial_fields})
            done[(t.cache_mode, t.ber, t.seed)] = t
    return done


def _append_checkpoint(path, trial: TrialResult, fingerprint: str = None):
    rec = dataclasses.asdict(trial)
    if fingerprint is not None:
        rec["config_fingerprint"] = fingerprint
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")


def run_sweep(
    params, model_cfg, tokenizer, texts, config: SweepConfig = None,
    progress_callback: Callable[[str, int, int], None] = None,
) -> SweepResults:
    if config is None:
        config = SweepConfig.default()
    results = SweepResults(config=config)
    fingerprint = config.fingerprint(model_cfg=model_cfg, texts=texts)
    completed = load_sweep_checkpoint(config.checkpoint_path, fingerprint)
    total = len(config.cache_modes) * len(config.ber_levels) * len(config.seeds)
    current = 0
    for cache_mode in config.cache_modes:
        for ber in config.ber_levels:
            trials = []
            for seed in config.seeds:
                if progress_callback:
                    progress_callback(
                        f"{cache_mode} @ BER={ber:.0e} seed={seed}", current, total
                    )
                key = (cache_mode, ber, seed)
                if key in completed:
                    trial = completed[key]
                else:
                    trial = run_single_trial(
                        params, model_cfg, tokenizer, texts, cache_mode, ber,
                        seed, config,
                    )
                    if config.checkpoint_path:
                        _append_checkpoint(config.checkpoint_path, trial, fingerprint)
                results.trials.append(trial)
                trials.append(trial)
                current += 1
            if config.aggregate_seeds and trials:
                results.aggregated.setdefault(cache_mode, {})[ber] = (
                    AggregatedResult.from_trials(trials)
                )
    return results


def run_sweep_single_seed(
    params, model_cfg, tokenizer, texts, config: SweepConfig = None,
    seed: int = 42, progress_callback=None,
) -> Dict[str, Dict[float, TrialResult]]:
    if config is None:
        config = SweepConfig.default()
    config.seeds = [seed]
    config.aggregate_seeds = False
    full = run_sweep(params, model_cfg, tokenizer, texts, config, progress_callback)
    out: Dict[str, Dict[float, TrialResult]] = {}
    for t in full.trials:
        out.setdefault(t.cache_mode, {})[t.ber] = t
    return out
