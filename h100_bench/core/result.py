"""The run's result line, its check report, and the small summary it
leaves in the checkout (``h100_bench_out/``)."""

from __future__ import annotations

import json

import torch

from . import check, spec

OUT_DIR = spec.ROOT / "h100_bench_out"


def assemble(cell, out, trace: bool, seed: int):
    """(the result line as a dict, the lines of the check report)."""
    nums = check.numbers(out.served)
    detail = nums.pop("detail", None)
    correct, checks = check.verdict(nums, cell.traffic["limits"], out.failed)
    detail["not_compared"] = {k: v for k, v in nums.items() if k not in checks}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(out.run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if trace and out.run.trace is not None:
        device["busy_s"] = out.run.trace.busy_s
        device["window_s"] = out.run.trace.window_s
        line["breakdown"] = out.run.trace.breakdown()
    line["window_steps"] = out.run.window_steps
    # a checkout's first run builds the kernels: its setup_s is recorded apart
    line["setup_compiled"] = out.run.compiled
    line["build_s"] = out.run.setup_parts.get("build", 0.0)
    line["checks"] = checks
    report = [f"set-up compiled the kernels: {out.run.compiled} "
              f"(build {line['build_s']:.1f} s of setup_s {out.run.setup_s:.1f} s)"]
    report += [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    report.append(f"correct: {correct}")
    _summary(cell, seed, trace, out, line, detail)
    return line, report


def _summary(cell, seed, trace, out, line, detail):
    """Spans and the line, a few tens of kB, one file per (cell, seed,
    trace), overwritten by a rerun."""
    OUT_DIR.mkdir(exist_ok=True)
    run = out.run
    doc = {"line": line, "setup_s": run.setup_s, "setup_parts": run.setup_parts,
           "compiled": run.compiled, "spin_ms": run.spin_ms, "window_s": run.window_s,
           "enqueue_ms": run.enqueue_ms, "gap_ms": run.gap_ms, "host_gap_ms": run.host_gap_ms, "detail": detail}
    if run.trace is not None and run.window_steps:
        # the device's busy time a step (traced) over the untraced window's
        # step: the idle share with the profiler off
        busy = run.trace.busy_s / run.trace.steps
        doc["idle_pct_untraced"] = 100.0 * (1.0 - busy * run.window_steps / run.window_s)
    path = OUT_DIR / f"{cell.name}-{seed}-{int(trace)}.json"
    path.write_text(json.dumps(doc))
