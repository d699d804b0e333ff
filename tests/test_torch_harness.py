"""The port's kernel benchmark harness, timing, bandwidth constants and
decode scaling (qkv_ecc_tpu_torch.benchmarks, .evaluation) against the JAX
package's, on the CPU: the attention case equals JAX's bit for bit in all
six codecs and K4 reads it as JAX's paged_attention_ecc does, the timing
statistics and the scaling efficiency agree on the same rows, and the
harness and the single-device scaling row have JAX's schema."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.benchmarks import harness as jh  # noqa: E402
from qkv_ecc_tpu.benchmarks import scaling as js  # noqa: E402
from qkv_ecc_tpu.evaluation import constants as jc  # noqa: E402
from qkv_ecc_tpu.evaluation import timing as jt  # noqa: E402
from qkv_ecc_tpu.kernels import paged_attention as jpa  # noqa: E402
from qkv_ecc_tpu_torch.benchmarks import harness as th  # noqa: E402
from qkv_ecc_tpu_torch.benchmarks import scaling as tsc  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import constants as tc  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import timing as tt  # noqa: E402
from qkv_ecc_tpu_torch.kernels import paged_attention as tpa  # noqa: E402
from qkv_ecc_tpu_torch.models.config import TINY_LLAMA  # noqa: E402
from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode  # noqa: E402

torch.set_num_threads(1)
CODECS = ("hamming84", "hamming74", "golay", "int4", "fp16", "fp8")
# a small case: 4 query heads over 2 KV heads, head_dim 16, 3 pages of 16
CASE = dict(batch=2, num_q_heads=4, num_kv_heads=2, head_dim=16, context_len=40,
            block_size=16)


def as_numpy(t):
    """A torch tensor's values as numpy, the float8 / bfloat16 ones by their
    bits (numpy has neither type)."""
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.uint8).numpy()
    return t.numpy()


def jax_bits(a):
    """A JAX array's values as numpy, the bfloat16 / float8 ones by their
    bits."""
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        return a.view(np.int16)
    if str(a.dtype).startswith("float8"):
        return a.view(np.uint8)
    return a


@pytest.mark.parametrize("codec", CODECS)
def test_attention_case_and_k4_match_jax(codec):
    """build_decode_attention_case equals JAX's bit for bit (cache words or
    stored floats, parity, scales, table, query, lengths), V is a copy and
    not K itself, and K4 over the case (the plain read on the CPU) agrees
    with JAX's paged_attention_ecc in interpret mode: within 8 bf16 ulps of
    the largest |V| for the packed codecs (the bf16 rounding of p * v_scale
    over values up to 8 scales), 2^-8 of the largest |V| for the float
    ones."""
    jq, jcache, jbt, jctx, jcfg = jh.build_decode_attention_case(**CASE, codec=codec)
    q, cache, bt, ctx, cfg = th.build_decode_attention_case(**CASE, codec=codec, device="cpu")
    assert sorted(cache) == sorted(jcache)
    for name in cache:
        np.testing.assert_array_equal(jax_bits(jcache[name]), as_numpy(cache[name]),
                                      err_msg=name)
        assert str(cache[name].dtype).removeprefix("torch.") == str(np.asarray(jcache[name]).dtype)
    for want, got in ((jq, q), (jbt, bt), (jctx, ctx)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        assert np.asarray(want).dtype == got.numpy().dtype
    assert cache["v_cache"].data_ptr() != cache["k_cache"].data_ptr()
    assert cache["v_scales"].data_ptr() != cache["k_scales"].data_ptr()
    assert (cfg.num_blocks, cfg.block_size, cfg.codec) == (jcfg.num_blocks, jcfg.block_size,
                                                           jcfg.codec)

    want = np.asarray(jpa.paged_attention_ecc(
        jq, jcache["k_cache"], jcache["v_cache"], jcache["k_scales"], jcache["v_scales"],
        jbt, jctx, 0, jcache.get("k_parity"), jcache.get("v_parity"), codec=codec,
        block_size=CASE["block_size"]))
    got = tpa.paged_attention_ecc(
        q, cache["k_cache"], cache["v_cache"], cache["k_scales"], cache["v_scales"], bt, ctx,
        0, cache.get("k_parity"), cache.get("v_parity"), codec=codec,
        block_size=CASE["block_size"]).numpy()
    if codec in ("fp16", "fp8"):
        atol = 2.0 ** -8 * float(cache["v_cache"].float().abs().max())
    else:
        atol = 2.0 ** -8 * 8.0 * float(cache["v_scales"].abs().max())
    assert np.isfinite(got).all() and got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_timing_stats_match_jax():
    """TimingStats and AggregatedTimingStats give JAX's numbers on the same
    trials, and PHASES are JAX's."""
    assert tt.PHASES == jt.PHASES
    rows = [({"host_to_device": 5_000_000, "encode": 2_000_000, "decode": 3_000_000}, 1000),
            ({"quantize": 1_500_000, "decode": 2_500_000}, 4000),
            ({"host_to_device": 7}, 10)]
    aggs = []
    for mod in (jt, tt):
        agg = mod.AggregatedTimingStats()
        for phases, n in rows:
            st = mod.TimingStats(values_processed=n)
            for p, ns in phases.items():
                st.add(p, ns)
            agg.add(st)
        aggs.append(agg)
    j, t = aggs
    for attr in ("total_ms_mean", "total_ms_std", "throughput_mean", "transfer_overhead_mean"):
        assert getattr(j, attr) == getattr(t, attr), attr
    for p in jt.PHASES:
        assert j.phase_ms_mean(p) == t.phase_ms_mean(p), p
    for a, b in zip(j.trials, t.trials):
        assert a.phase_ns == b.phase_ns and a.total_ms == b.total_ms
        assert a.throughput_mvalues_sec == b.throughput_mvalues_sec
    assert tt.AggregatedTimingStats().mean_std(lambda s: s.total_ms) == (0.0, 0.0)


def test_timers_on_the_cpu():
    """TimingContext adds the block's nanoseconds; time_fn and
    time_fn_chained return positive seconds; the chain feeds each call the
    previous call's input, unchanged in value."""
    st = tt.TimingStats()
    with tt.TimingContext(st, "encode", sync_value=torch.zeros(3)):
        sum(range(1000))
    assert st.phase_ns["encode"] > 0 and st.total_ns == st.phase_ns["encode"]
    with tt.device_timer() as d:
        sum(range(1000))
    assert d["ns"] > 0
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2, x

    x = torch.arange(8, dtype=torch.int32)
    assert tt.time_fn(fn, x, iters=3, warmup=1) > 0
    assert tt.time_fn_chained(fn, x, iters=4, warmup=2, fetch_overhead_s=0.0) > 0
    assert all(torch.equal(s, x) for s in seen)
    xf = torch.linspace(-1, 1, 8)
    assert tt.time_fn_chained(lambda v: (v > 0), xf, iters=2, warmup=1) > 0
    assert torch.equal(tt.run_warmup(fn, x, iterations=2)[1], x)


def test_cpu_times_are_the_host_clock():
    """On the CPU, time_fn_chained is the host clock around the calls, with
    nothing subtracted by default: a call that sleeps 2 ms times at least 2
    ms, and a harness row's time per call is at least the wall time of one
    call of its function divided by the row's iteration count (20)."""
    import time

    def slow(v):
        time.sleep(0.002)
        return v

    assert tt.time_fn_chained(slow, torch.zeros(4, dtype=torch.int32), iters=5, warmup=1) >= 0.002
    enc, dec = th.benchmark_hamming84(4096, device="cpu")
    cw = th.ck.hamming84_encode_cuda(th._values(4096, "cpu"))
    one = []
    for _ in range(5):
        t0 = time.perf_counter()
        th.ck.hamming84_decode_cuda(cw)
        one.append(time.perf_counter() - t0)
    assert dec.time_ms / 1e3 >= min(one) / 20
    assert dec.mvalues_per_sec == pytest.approx(4096 / (dec.time_ms / 1e3) / 1e6)


def test_scaling_efficiency_and_constants_match_jax():
    rows = [{"tier": "in-process-mesh", "mesh": m, "tokens_per_s": v}
            for m, v in (("2x1", 180.0), ("1x1", 100.0), ("4x1", 300.0), ("1x2", 90.0),
                         ("2x2", 170.0))] + [{"tier": "single-device", "mesh": "1",
                                              "tokens_per_s": 50.0}]
    want = js.scaling_efficiency([dict(r) for r in rows])
    got = tsc.scaling_efficiency([dict(r) for r in rows])
    assert want == got
    assert got[0]["weak_scaling_efficiency"] == 0.9
    assert tc.DEFAULT_CHIP == "H100"
    for chip, gbps in tc.CHIP_BANDWIDTH_GBPS.items():
        assert jc.CHIP_BANDWIDTH_GBPS[chip] == gbps
        assert tc.compute_bandwidth_efficiency(1000.0, 3, chip) == \
            jc.compute_bandwidth_efficiency(1000.0, 3, chip)
    assert tc.get_chip_bandwidth() == tc.get_chip_bandwidth("v5e") == 3352.0
    r = th.KernelBenchResult("x", 10, 2.0, 1676000.0, 2.0)
    assert r.bandwidth_efficiency() == 100.0 and r.to_dict()["gb_per_sec"] == 3352.0


def test_full_benchmark_has_jax_schema():
    """run_full_benchmark(n=4096, attention=False) on the CPU has JAX's
    keys, rows in JAX's order with JAX's names, n_values and bytes per
    value; the plain-codec arms (pallas=False) run too."""
    want = jh.run_full_benchmark(n=4096, attention=False)
    got = th.run_full_benchmark(n=4096, attention=False, device="cpu")
    assert list(got) == list(want)
    assert [(r["name"], r["n_values"], r["bytes_per_value"]) for r in got["kernels"]] == \
        [(r["name"], r["n_values"], r["bytes_per_value"]) for r in want["kernels"]]
    assert all(list(a) == list(b) for a, b in zip(got["kernels"], want["kernels"]))
    assert list(got["cpu_vs_accelerator"]) == list(want["cpu_vs_accelerator"])
    assert got["cpu_vs_accelerator"]["accel_platform"] == "cpu" and got["attention"] == []
    for bench in (th.benchmark_hamming84, th.benchmark_hamming74):
        rows = bench(1024, pallas=False, device="cpu")
        assert [r.name for r in rows] == [r.name for r in bench(1024, device="cpu")]
    assert th.benchmark_golay(100, pallas=False, device="cpu")[1].n_values == 300
    table = th.create_random_block_table(3, 4, 20, seed=5, device="cpu")
    np.testing.assert_array_equal(np.asarray(jh.create_random_block_table(3, 4, 20, seed=5)),
                                  table.numpy())


def test_attention_benchmark_row_on_the_cpu(tmp_path):
    """benchmark_ecc_attention at the case's shapes returns JAX's keys; the
    JSON emitter writes what it was given."""
    row = th.benchmark_ecc_attention(**CASE, codec="golay", device="cpu")
    assert list(row) == ["codec", "batch", "context_len", "ecc_attention_ms",
                         "sdpa_baseline_ms", "overhead_ratio", "decode_tokens_per_sec"]
    assert row["codec"] == "golay" and row["batch"] == 2 and row["ecc_attention_ms"] > 0
    path = tmp_path / "bench.json"
    th.save_benchmark_json({"attention": [row]}, str(path))
    assert path.read_text().startswith("{")


def test_single_device_scaling_row():
    """measure_single_device on tiny-llama on the CPU gives the JAX row's
    keys and values of the right kind; main's --meshes defaults to JAX's
    list, runs --meshes single, and a DATAxMODEL mesh through
    measure_tp_mesh (gloo ranks on the CPU) with JAX's row keys; given no
    device, measure_tp_mesh needs a card."""
    pol = policy_for_mode("int12-golay", ber=1e-2, seed=42)
    row = tsc.measure_single_device(TINY_LLAMA, pol, batch=2, prompt_len=8, steps=2,
                                    block_size=16, warmup=1, device="cpu")
    assert list(row) == ["tier", "mesh", "batch", "ms_per_step", "tokens_per_s"]
    assert (row["tier"], row["mesh"], row["batch"]) == ("single-device", "1", 2)
    assert row["ms_per_step"] > 0 and row["tokens_per_s"] > 0
    args = ["--device", "cpu", "--steps", "1", "--prompt-len", "8", "--batch-per-data", "1"]
    out = tsc.main(args + ["--meshes", "single"])
    assert len(out["rows"]) == 1
    assert out["platform"] == "cpu" and out["rows"][0]["block_size"] == 16
    assert set(out["rows"][0]) >= {"model", "mode", "ber", "platform"}
    out = tsc.main(args + ["--meshes", "single,1x1"])
    assert [r["mesh"] for r in out["rows"]] == ["1", "1x1"]
    assert out["rows"][1]["tier"] == "in-process-mesh"
    assert out["rows"][1]["weak_scaling_efficiency"] == 1.0
    import inspect

    default = '"1x1,2x1,4x1,8x1,1x2,2x2"'
    assert default in inspect.getsource(tsc.main) and default in inspect.getsource(js.main)
    if not torch.cuda.is_available():  # given no device: the cards, one a rank
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsc.measure_tp_mesh(TINY_LLAMA, pol, data=1, model=1, batch_per_data=1,
                                prompt_len=8, steps=1, block_size=16)
