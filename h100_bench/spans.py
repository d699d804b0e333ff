"""The program's own spans (``qkv_ecc_tpu_torch.tracing``) in one run of a
cell, read beside the benchmark's outside measures.

    python3 h100_bench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the card. It runs the cell once as
``run.py --trace 1`` does, through the session's ``decode_step`` hook:

  set-up            prefill with host spans and device events (CUDA events)
  window            the steps in turn with tracing off, with host spans, and
                    with host spans and device events; each step's time on
                    the device clock (the session's token-copy events) and
                    its enqueue give what tracing costs when on
  profiled stretch  host spans only; mapped onto the device clock by the
                    stretch's marker kernel, they name the idle gaps

and prints the run's result line (``correct`` among it) and then one JSON
line of readings; the same, with every span's total, goes to
``h100_bench_out/spans-<cell>-<seed>.json``. The readings:

  write_chain_ms          device ms a step inside decode.write_chain (the
                          device-event steps)
  write_chain_enqueue_ms  host ms a step inside decode.write_chain (the
                          profiled stretch)
  prefill_attn_s          device s inside prefill.attention over set-up
  attend_vs_attn          decode.attend's device ms a step against attn_ms,
                          scaled by the two sets of steps' summed contexts
  leaves_vs_step          the decode leaves' device ms a step, summed,
                          against those steps' time on the device clock
  idle_gaps               the profiled stretch's idle seconds by the span
                          the host was in, program spans first
  cost                    median step (device clock) and enqueue (host) by
                          tracing mode
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
MODES = ("off", "host", "device")  # the window's steps, in turn


def per_step(spans, name: str, steps: int, device: bool) -> float | None:
    """ms a step inside ``name``: device time (device=True) or host time."""
    if not steps:
        return None
    if device:
        ms = [d for n, _, _, d in spans if n == name and d is not None]
    else:
        ms = [(t1 - t0) * 1e-6 for n, t0, t1, _ in spans if n == name]
    return sum(ms) / steps if ms else None


def totals(spans, steps: int, device: bool) -> dict:
    """{name: ms a step} of every span name, in order of first appearance."""
    names = dict.fromkeys(n for n, *_ in spans)
    return {n: per_step(spans, n, steps, device) for n in names}


def write_chain_ms(device_spans, steps: int):
    return per_step(device_spans, "decode.write_chain", steps, True)


def write_chain_enqueue_ms(host_spans, steps: int):
    return per_step(host_spans, "decode.write_chain", steps, False)


def prefill_attn_s(prefill_spans):
    ms = per_step(prefill_spans, "prefill.attention", 1, True)
    return None if ms is None else ms * 1e-3


def offset_ns(calls, trace_spans) -> int | None:
    """The host clock's offset onto the device clock: each profiled call of
    the hook starts just after the session's own decode_step span, whose
    mapped start is known, so mapped start less the call's start is at
    most the offset; the largest such difference is the closest."""
    starts = [s for n, s, _ in trace_spans if n == "decode_step"]
    if not starts or len(starts) != len(calls):
        return None
    return max(s - t0 for s, (t0, _) in zip(starts, calls))


def named_gaps(trace, program_spans, offset: int) -> dict:
    """{span name: idle seconds} of the stretch, each gap named by the span
    the host was in at its middle: the program's leaves first, then the
    benchmark's own spans (``Trace.span_at``)."""
    from h100_bench.core.trace import Trace

    mapped = [(n, t0 + offset, t1 + offset) for n, t0, t1, _ in program_spans]
    both = Trace(trace.kernels, trace.others, trace.t0, trace.t1, trace.steps,
                 mapped + trace.spans)
    out = {}
    for s, e in both.idle_gaps():
        name = both.span_at((s + e) // 2)
        out[name] = out.get(name, 0.0) + (e - s) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def spanned_run(cell, seed: int, seconds: float, trace: bool, device: str):
    """(outcome, readings) of one run of ``cell`` with the program's spans
    on as the module's docstring says."""
    import torch

    from h100_bench.core.session import WARMUP_STEPS, run_cell
    from qkv_ecc_tpu_torch import tracing
    from qkv_ecc_tpu_torch.models import runtime

    calls = []  # (mode, host start ns, host end ns) of each decode_step call
    profiling = torch._C._autograd._profiler_enabled

    def step(*args, **kw):
        k = len(calls)
        if k < WARMUP_STEPS:
            mode = "warmup"
        elif profiling():
            mode = "profiled"
        elif calls[-1][0] in ("profiled", "after"):
            mode = "after"
        else:
            mode = MODES[(k - WARMUP_STEPS) % len(MODES)]
        if mode in ("host", "profiled"):
            tracing.enable(device_events=False)
        elif mode == "device":
            tracing.enable(device_events=True)
        else:
            tracing.disable()
        t0 = time.perf_counter_ns()
        out = runtime.decode_step(*args, **kw)
        calls.append((mode, t0, time.perf_counter_ns()))
        return out

    tracing.drain()
    tracing.enable(device_events=True)
    try:
        out = run_cell(cell, seed, seconds, trace, device, T_START, hooks={"decode_step": step})
    finally:
        tracing.disable()
    spans = tracing.drain()
    run = out.run

    first = calls[0][1]
    prefill = [s for s in spans if s[1] < first]
    by_call = [[] for _ in calls]
    starts = [t0 for _, t0, _ in calls]
    i = 0
    for s in spans[len(prefill):]:
        while i + 1 < len(calls) and s[1] >= starts[i + 1]:
            i += 1
        by_call[i].append(s)

    # the window's steps; without a profiled stretch the round's last
    # steps follow them in turn as well
    window = [k for k, (m, *_) in enumerate(calls) if m in MODES][:run.window_steps]
    # gap_ms[w - 1]: window step w's time, token copy to token copy
    step_ms = {m: [] for m in MODES}
    enq_ms = {m: [] for m in MODES}
    for w, k in enumerate(window):
        m, t0, t1 = calls[k]
        enq_ms[m].append((t1 - t0) * 1e-6)
        if w and run.gap_ms:
            step_ms[m].append(run.gap_ms[w - 1])
    med = lambda v: statistics.median(v) if v else None  # noqa: E731
    cost = {m: {"steps": len(enq_ms[m]), "step_ms": med(step_ms[m]),
                "enqueue_ms": med(enq_ms[m])} for m in MODES}

    dev_calls = [k for k in window if calls[k][0] == "device"]
    dev_spans = [s for k in dev_calls for s in by_call[k]]
    dev_steps = [w for w, k in enumerate(window) if calls[k][0] == "device" and w]
    host_calls = [k for k in window if calls[k][0] == "host"]
    host_spans = [s for k in host_calls for s in by_call[k]]
    prof_calls = [k for k, (m, *_) in enumerate(calls) if m == "profiled"]
    prof_spans = [s for k in prof_calls for s in by_call[k]]

    readings = {
        "write_chain_ms": write_chain_ms(dev_spans, len(dev_calls)),
        "write_chain_enqueue_ms": write_chain_enqueue_ms(prof_spans, len(prof_calls)),
        "prefill_attn_s": prefill_attn_s(prefill),
        "setup_prefill_s": run.setup_parts.get("prefill"),
        "cost": cost,
        "device_ms_per_step": totals(dev_spans, len(dev_calls), True),
        "host_ms_per_step": totals(host_spans, len(host_calls), False),
        "profiled_host_ms_per_step": totals(prof_spans, len(prof_calls), False),
        "prefill_device_s": {n: v * 1e-3 if v is not None else None
                             for n, v in totals(prefill, 1, True).items()},
        "prefill_host_s": {n: v * 1e-3 for n, v in totals(prefill, 1, False).items()},
    }
    leaves = sum(v for v in readings["device_ms_per_step"].values() if v is not None)
    readings["leaves_vs_step"] = {
        "leaves_ms": leaves,
        "step_ms_mean": (sum(run.gap_ms[w - 1] for w in dev_steps) / len(dev_steps)
                         if dev_steps and run.gap_ms else None)}
    if run.trace is not None:
        from h100_bench.core.spec import metric_reader

        j_dev = [run.window_j[w] for w, k in enumerate(window) if calls[k][0] == "device"]
        ctx_dev = sum(run.ctx_sum(j) for j in j_dev) / max(len(j_dev), 1)
        ctx_trace = sum(run.ctx_sum(j) for j in run.trace_j) / len(run.trace_j)
        attn = metric_reader("attn_ms")(run)
        readings["attend_vs_attn"] = {
            "attend_ms": readings["device_ms_per_step"].get("decode.attend"),
            "attn_ms": attn, "attn_ms_scaled": attn * ctx_dev / ctx_trace,
            "ctx_device_steps": ctx_dev, "ctx_traced_steps": ctx_trace}
        off = offset_ns([(t0, t1) for m, t0, t1 in calls if m == "profiled"], run.trace.spans)
        if off is not None:
            gaps = named_gaps(run.trace, prof_spans, off)
            readings["idle_gaps"] = gaps
            inside = sum(v for n, v in gaps.items() if n.startswith("decode."))
            readings["idle_in_decode_leaves_pct"] = (
                100.0 * inside / (inside + gaps.get("decode_step", 0.0))
                if inside + gaps.get("decode_step", 0.0) else None)
    return out, readings


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench.core import result, spec

    if not torch.cuda.is_available():
        print("spans.py needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload, ROOT)
    out, readings = spanned_run(cell, args.seed, args.seconds, True, "cuda")
    line, report = result.assemble(cell, out, True, args.seed)
    readings["card"] = torch.cuda.get_device_name(0)
    for text in report:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    result.OUT_DIR.mkdir(exist_ok=True)
    (result.OUT_DIR / f"spans-{cell.name}-{args.seed}.json").write_text(
        json.dumps(readings, indent=1))
    brief = {k: v for k, v in readings.items()
             if k not in ("device_ms_per_step", "host_ms_per_step", "profiled_host_ms_per_step",
                          "prefill_device_s", "prefill_host_s")}
    print(json.dumps(brief))
    return 0


if __name__ == "__main__":
    sys.exit(main())
