"""Kernel microbenchmark harness (counterpart of
``qkv_ecc_tpu/benchmarks/harness.py``): per-codec encode/decode Mvalues/s,
fault-injection throughput, the encode->inject->decode pipeline, randomized
block tables, a dense SDPA baseline against the ECC paged attention (K4)
with the overhead ratio, and the JSON emitter.

Names, defaults and the result schema (``KernelBenchResult``, the dict keys,
the rows' names) are the JAX module's. Every function takes ``device``:
None means the card (and raises without one), ``"cpu"`` runs the plain
versions on the CPU, whose times are the host's and no device metric.
``pallas=True`` keeps its name so that a JAX caller runs unchanged: it
means the hand-written kernels (``kernels/codec_kernels.py``, K5-K7);
``False`` the plain codecs of ``qkv_ecc_tpu_torch.codecs``. Times come from
``evaluation.timing.time_fn_chained``: CUDA events on the card.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..codecs import (
    golay_decode,
    golay_encode,
    hamming74_decode,
    hamming74_encode,
    hamming84_decode,
    hamming84_encode,
    inject_bit_errors,
)
from ..device import resolve_device
from ..evaluation.constants import compute_bandwidth_efficiency
from ..evaluation.timing import time_fn, time_fn_chained
from ..kernels import codec_kernels as ck
from ..kernels.common import to_float_storage


@dataclasses.dataclass
class KernelBenchResult:
    name: str
    n_values: int
    time_ms: float
    mvalues_per_sec: float
    bytes_per_value: float = 1.0

    @property
    def gb_per_sec(self) -> float:
        return self.mvalues_per_sec * self.bytes_per_value / 1000.0

    def bandwidth_efficiency(self, chip: Optional[str] = None) -> float:
        return compute_bandwidth_efficiency(
            self.mvalues_per_sec, self.bytes_per_value, chip
        )

    def to_dict(self):
        d = dataclasses.asdict(self)
        d["gb_per_sec"] = self.gb_per_sec
        return d


def _bench(name, fn, *args, n_values, bytes_per_value=1.0, iters=20) -> KernelBenchResult:
    dt = time_fn_chained(fn, *args, iters=iters)
    return KernelBenchResult(
        name=name,
        n_values=n_values,
        time_ms=dt * 1e3,
        mvalues_per_sec=n_values / dt / 1e6,
        bytes_per_value=bytes_per_value,
    )


def _values(n, device):
    """n random nibbles (uint8) from numpy's seed 0, on device."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, 16, n, dtype=np.uint8)).to(resolve_device(device))


def benchmark_hamming84(n: int = 16 * 1024 * 1024, pallas: bool = True, device=None):
    vals = _values(n, device)
    enc_fn = ck.hamming84_encode_cuda if pallas else hamming84_encode
    cw = enc_fn(vals)
    dec_fn = ck.hamming84_decode_cuda if pallas else hamming84_decode
    return [
        _bench("hamming84_encode", enc_fn, vals, n_values=n, bytes_per_value=2),
        _bench("hamming84_decode", dec_fn, cw, n_values=n, bytes_per_value=3),
    ]


def benchmark_hamming74(n: int = 16 * 1024 * 1024, pallas: bool = True, device=None):
    vals = _values(n, device)
    enc_fn = ck.hamming74_encode_cuda if pallas else hamming74_encode
    cw = enc_fn(vals)
    dec_fn = ck.hamming74_decode_cuda if pallas else hamming74_decode
    return [
        _bench("hamming74_encode", enc_fn, vals, n_values=n, bytes_per_value=2),
        _bench("hamming74_decode", dec_fn, cw, n_values=n, bytes_per_value=3),
    ]


def benchmark_golay(n_triplets: int = 4 * 1024 * 1024, pallas: bool = True, device=None):
    rng = np.random.default_rng(0)
    trip = torch.from_numpy(rng.integers(0, 16, (n_triplets, 3), dtype=np.uint8)).to(
        resolve_device(device))
    enc_fn = ck.golay_encode_cuda if pallas else golay_encode
    cw = enc_fn(trip)
    dec_fn = ck.golay_decode_cuda if pallas else golay_decode
    n_values = n_triplets * 3
    return [
        _bench("golay_encode", enc_fn, trip, n_values=n_values, bytes_per_value=7 / 3),
        _bench("golay_decode", dec_fn, cw, n_values=n_values, bytes_per_value=7 / 3),
    ]


def benchmark_fault_injection(n: int = 16 * 1024 * 1024, ber: float = 1e-2, device=None):
    """K9 (the row keeps JAX's name "fault_injection_pallas_prng") against
    the generator-based ``codecs.inject_bit_errors`` (the row JAX names
    after its threefry injector)."""
    data = torch.zeros(n, dtype=torch.uint8, device=resolve_device(device))

    def kernel_inject(d):
        return ck.inject_bit_errors_cuda(d, ber, 8, 42)

    def generator_inject(d):
        return inject_bit_errors(d, ber, 8, seed=42)

    return [
        _bench("fault_injection_pallas_prng", kernel_inject, data, n_values=n,
               bytes_per_value=2),
        _bench("fault_injection_threefry", generator_inject, data, n_values=n,
               bytes_per_value=2),
    ]


def benchmark_encode_inject_decode(n: int = 8 * 1024 * 1024, ber: float = 1e-2, device=None):
    """Full pipeline roundtrip through the plain codecs."""
    vals = _values(n, device)

    def pipeline(v):
        cw = hamming84_encode(v)
        cw = inject_bit_errors(cw, ber, 8, seed=1)
        data, _, c, d = hamming84_decode(cw)
        return data, c, d

    return [_bench("h84_encode_inject_decode", pipeline, vals, n_values=n, bytes_per_value=4)]


def create_random_block_table(batch: int, num_pages: int, num_blocks: int, seed=0,
                              device=None):
    """Randomized non-contiguous block assignment, numpy's permutation from
    ``seed`` (the JAX function's table)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_blocks)[: batch * num_pages]
    return torch.from_numpy(perm.reshape(batch, num_pages).astype(np.int32)).to(
        resolve_device(device))


def build_decode_attention_case(
    batch=8, num_q_heads=32, num_kv_heads=8, head_dim=128, context_len=1024,
    block_size=128, codec="hamming84", seed=0, device=None,
):
    """Random paged cache + query for the attention benchmark, drawn from
    ``np.random.default_rng(seed)`` in the JAX function's order, so cache,
    table and query equal JAX's bit for bit (the float codecs' values stored
    through ``to_float_storage``, as JAX's ``asarray`` rounds them; V holds
    a copy of K's values and scales)."""
    from ..cache.layout import ECCCacheConfig, allocate_ecc_kv_cache

    device = resolve_device(device)
    num_pages = -(-context_len // block_size)
    cfg = ECCCacheConfig(
        num_blocks=batch * num_pages,
        block_size=block_size,
        num_layers=1,
        num_kv_heads=num_kv_heads,
        head_dim=head_dim,
        codec=codec,
    )
    rng = np.random.default_rng(seed)
    cache = allocate_ecc_kv_cache(cfg, device=device)
    if codec in ("fp16", "fp8"):
        raw = torch.from_numpy(rng.normal(size=cache["k_cache"].shape).astype(np.float32))
        stored = to_float_storage(codec, raw).to(device)
        cache["k_cache"] = stored
        cache["v_cache"] = stored.clone()
    else:
        # random packed int32 storage words = random codeword bits (split
        # layout: data and parity arrays randomized independently)
        for name in ("k_cache", "v_cache", "k_parity", "v_parity"):
            if name not in cache:
                continue
            raw = rng.integers(-(2**31), 2**31, cache[name].shape, dtype=np.int64).astype(np.int32)
            cache[name] = torch.from_numpy(raw).to(device)
    cache["k_scales"] = torch.from_numpy(
        rng.uniform(0.05, 0.2, cache["k_scales"].shape).astype(np.float32)).to(device)
    cache["v_scales"] = cache["k_scales"].clone()
    block_table = create_random_block_table(batch, num_pages, cfg.num_blocks, seed, device)
    q = torch.from_numpy(
        rng.normal(size=(batch, num_q_heads, head_dim)).astype(np.float32)).to(device)
    ctx = torch.full((batch,), context_len, dtype=torch.int32, device=device)
    return q, cache, block_table, ctx, cfg


def benchmark_ecc_attention(
    batch=8, num_q_heads=32, num_kv_heads=8, head_dim=128, context_len=1024,
    block_size=128, codec="hamming84", device=None,
) -> Dict:
    """K4 (``paged_attention_ecc``) over the case against a dense decode
    attention at the same shapes: ``scaled_dot_product_attention`` over bf16
    K/V [B, Hkv, ctx, D] (GQA), the yardstick the JAX function builds from
    einsums (``rng(1)`` draws its K, V = K)."""
    from ..kernels.paged_attention import paged_attention_ecc

    q, cache, block_table, ctx, cfg = build_decode_attention_case(
        batch, num_q_heads, num_kv_heads, head_dim, context_len, block_size, codec,
        device=device,
    )

    def ecc_attn(q):
        return paged_attention_ecc(
            q, cache["k_cache"], cache["v_cache"], cache["k_scales"],
            cache["v_scales"], block_table, ctx, 0,
            cache.get("k_parity"), cache.get("v_parity"),
            codec=codec, block_size=block_size,
        )

    dt_ecc = time_fn_chained(ecc_attn, q)

    rng = np.random.default_rng(1)
    k = torch.from_numpy(
        rng.normal(size=(batch, context_len, num_kv_heads, head_dim)).astype(np.float32)
    ).to(device=q.device, dtype=torch.bfloat16).transpose(1, 2).contiguous()
    v = k

    def sdpa(q):
        out = torch.nn.functional.scaled_dot_product_attention(
            q.to(torch.bfloat16)[:, :, None], k, v, enable_gqa=True)
        return out[:, :, 0]

    dt_sdpa = time_fn_chained(sdpa, q)
    tokens_per_sec = batch / dt_ecc
    return {
        "codec": codec,
        "batch": batch,
        "context_len": context_len,
        "ecc_attention_ms": dt_ecc * 1e3,
        "sdpa_baseline_ms": dt_sdpa * 1e3,
        "overhead_ratio": dt_ecc / dt_sdpa,
        "decode_tokens_per_sec": tokens_per_sec,
    }


def run_attention_benchmark_suite(
    batches=(1, 8), context_lens=(512, 2048), codec="hamming84", device=None
) -> List[Dict]:
    out = []
    for b in batches:
        for ctx in context_lens:
            out.append(
                benchmark_ecc_attention(batch=b, context_len=ctx, codec=codec, device=device)
            )
    return out


def benchmark_cpu_vs_tpu_hamming84(n: int = 4 * 1024 * 1024, device=None) -> Dict:
    """Hamming(8,4) decode on the host CPU (the plain decoder on CPU
    tensors) against the accelerator (K6); with ``device="cpu"`` only the
    accelerator entry is filled, on the CPU, as JAX's on a CPU backend."""
    rng = np.random.default_rng(0)
    cw_host = torch.from_numpy(rng.integers(0, 256, n, dtype=np.uint8))
    accel = resolve_device(device)
    out: Dict = {"n_values": n}

    cw_acc = cw_host.to(accel)
    dt_acc = time_fn_chained(ck.hamming84_decode_cuda, cw_acc, iters=10)
    out["accel_platform"] = accel.type
    out["accel_ms"] = dt_acc * 1e3
    out["accel_mvalues_per_sec"] = n / dt_acc / 1e6

    if accel.type != "cpu":
        def cpu_decode(x):
            data, et, c, d = hamming84_decode(x)
            return data

        dt_cpu = time_fn(cpu_decode, cw_host, iters=5)
        out["cpu_ms"] = dt_cpu * 1e3
        out["cpu_mvalues_per_sec"] = n / dt_cpu / 1e6
        out["speedup"] = dt_cpu / dt_acc
    return out


def run_full_benchmark(n: int = 8 * 1024 * 1024, attention: bool = True, device=None) -> Dict:
    """Full suite."""
    results: Dict[str, object] = {"kernels": [], "attention": []}
    for bench in (
        benchmark_hamming84(n, device=device),
        benchmark_hamming74(n, device=device),
        benchmark_golay(n // 3, device=device),
        benchmark_fault_injection(n, device=device),
        benchmark_encode_inject_decode(n, device=device),
    ):
        results["kernels"].extend(r.to_dict() for r in bench)
    results["cpu_vs_accelerator"] = benchmark_cpu_vs_tpu_hamming84(n // 2, device=device)
    if attention:
        results["attention"] = run_attention_benchmark_suite(device=device)
    return results


def save_benchmark_json(results: Dict, path: str):
    with open(path, "w") as f:
        json.dump(results, f, indent=2)


if __name__ == "__main__":
    res = run_full_benchmark()
    print(json.dumps(res, indent=2))
