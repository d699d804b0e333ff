"""spans.py's readings: on synthetic spans and a synthetic trace, then on a
tiny cell run on the CPU through the session's decode_step hook (host
spans alone: the CPU has no device events and no profiled stretch)."""

import pytest
import torch

from h100_bench import spans as sp
from h100_bench.core.trace import Trace
from h100_bench.tests import tiny

torch.set_num_threads(1)
MS = 1_000_000  # ns


def test_readings_of_synthetic_spans():
    # two steps: write chain 3 + 5 host ms and 1.0 + 1.5 device ms
    steps = [("decode.qkv", 0, 1 * MS, 0.5), ("decode.write_chain", 1 * MS, 4 * MS, 1.0),
             ("decode.attend", 4 * MS, 5 * MS, 7.0),
             ("decode.qkv", 10 * MS, 11 * MS, 0.5), ("decode.write_chain", 11 * MS, 16 * MS, 1.5),
             ("decode.attend", 16 * MS, 17 * MS, 9.0)]
    assert sp.write_chain_ms(steps, 2) == pytest.approx(1.25)
    assert sp.write_chain_enqueue_ms(steps, 2) == pytest.approx(4.0)
    assert sp.per_step(steps, "decode.attend", 2, True) == pytest.approx(8.0)
    assert list(sp.totals(steps, 2, False)) == ["decode.qkv", "decode.write_chain",
                                               "decode.attend"]
    assert sp.write_chain_ms([], 0) is None
    assert sp.write_chain_ms([("decode.write_chain", 0, 1, None)], 1) is None  # host only
    pre = [("prefill.attention", 0, 1, 1500.0), ("prefill.qkv", 1, 2, 10.0),
           ("prefill.attention", 2, 3, 500.0)]
    assert sp.prefill_attn_s(pre) == pytest.approx(2.0)


def test_gaps_named_by_the_program_leaf():
    # the device is busy over [0, 10) and [14, 20) and [23, 30) ms; the host
    # spans sit 100 ms early on the host clock
    kernels = [("k", 0, 10 * MS), ("k", 14 * MS, 20 * MS), ("k", 23 * MS, 30 * MS)]
    bench = [("decode_step", 0, 25 * MS), ("argmax_and_copy", 25 * MS, 30 * MS)]
    trace = Trace(kernels, [], 0, 30 * MS, 1, bench)
    calls = [(-100 * MS + 10_000, -75 * MS)]  # the hook starts 10 us into the span
    off = sp.offset_ns(calls, bench)
    assert off == 100 * MS - 10_000
    program = [("decode.write_chain", -90 * MS, -85 * MS, None),
               ("decode.attend", -85 * MS, -84 * MS, None)]
    gaps = sp.named_gaps(trace, program, 100 * MS)
    assert gaps == {"decode.write_chain": pytest.approx(0.004),
                    "decode_step": pytest.approx(0.003)}
    assert sp.offset_ns(calls * 2, bench) is None  # calls and spans must pair


def test_tiny_cell_on_the_cpu():
    cell = tiny.cell(tiny.TINY_GPT2, tiny.traffic("int12-golay", stats=True))
    out, readings = sp.spanned_run(cell, 20260101, 0.3, False, "cpu")
    assert out.run.window_steps >= 3
    cost = readings["cost"]
    assert all(cost[m]["steps"] >= 1 for m in sp.MODES)
    assert sum(cost[m]["steps"] for m in sp.MODES) == out.run.window_steps
    host = readings["host_ms_per_step"]
    assert list(host)[:3] == ["decode.masks", "decode.embed", "decode.qkv"]
    assert host["decode.write_chain"] > 0
    assert readings["prefill_host_s"]["prefill.attention"] > 0
    # the CPU has no device events and no profiled stretch
    assert readings["write_chain_ms"] is None and readings["prefill_attn_s"] is None
    assert readings["write_chain_enqueue_ms"] is None
    assert "idle_gaps" not in readings
