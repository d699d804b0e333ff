"""Device trace of a short steady stretch: torch.profiler with CUDA activity
alone (CPU activity slows the host's enqueue, which paces these steps).

The stretch is bracketed by two marker kernels (``torch.cuda._sleep``,
named spin_kernel) launched on an idle device right after a synchronize;
the first marker's start, less the host clock when it was launched, maps
the benchmark's host spans onto the device timeline, so that each idle gap
can be named by the span the host was in.
"""

from __future__ import annotations

import dataclasses
import time

import torch

MARKER = "spin_kernel"


@dataclasses.dataclass
class Trace:
    kernels: list  # (name, start_ns, end_ns) on the device clock, markers excluded
    others: list  # memcpy / memset (name, start_ns, end_ns)
    t0: int  # stretch on the device clock: first marker's end ..
    t1: int  # .. second marker's start
    steps: int
    spans: list  # host spans (name, start_ns, end_ns) mapped onto the device clock

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self):
        """Union of every device operation's interval inside the stretch."""
        ivs = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.kernels + self.others
                     if e > self.t0 and s < self.t1)
        merged = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def idle_gaps(self):
        """(start, end) of each stretch of the window with no device operation."""
        gaps, t = [], self.t0
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            gaps.append((t, self.t1))
        return gaps

    def kernel_ms_per_step(self, pick) -> float:
        return sum(e - s for n, s, e in self.kernels if pick(n)) * 1e-6 / self.steps

    def breakdown(self) -> dict:
        by_op = {}
        for n, s, e in self.kernels + self.others:
            key = short_name(n)
            by_op[key] = by_op.get(key, 0) + (e - s) * 1e-9
        by_span = {}
        for s, e in self.idle_gaps():
            name = self.span_at((s + e) // 2)
            by_span[name] = by_span.get(name, 0) + (e - s) * 1e-9
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {"device_ops": top(by_op), "idle_gaps": top(by_span)}

    def span_at(self, t: int) -> str:
        for name, s, e in self.spans:
            if s <= t < e:
                return name
        return "harness"


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:120]


def _device_events(prof):
    """(name, kind, start_ns, end_ns) of every device-side event of a
    finished profiler."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = str(ev.activity_type()).lower() if hasattr(ev, "activity_type") else "kernel"
        start = ev.start_ns()
        out.append((ev.name(), kind, start, start + ev.duration_ns()))
    return out


def traced(run_steps, n_steps: int, spans: list) -> Trace:
    """Run ``run_steps(n_steps)`` under the profiler; ``spans`` is the list
    the steps append their host spans to (perf_counter_ns), emptied first.
    Returns the Trace, or raises RuntimeError when the profiler saw no
    device event (then nothing device-side is measured)."""
    from torch.profiler import ProfilerActivity, profile

    spans.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        run_steps(n_steps)
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = _device_events(prof)
    marks = sorted((s, e) for n, _, s, e in events if MARKER in n)
    if len(marks) < 2:
        raise RuntimeError(f"the profiler saw {len(events)} device events and "
                           f"{len(marks)} markers: device time not measured")
    offset = marks[0][0] - h0
    kernels, others = [], []
    for n, kind, s, e in events:
        if MARKER in n:
            continue
        (others if ("memcpy" in kind or "memset" in kind or "Memcpy" in n or "Memset" in n)
         else kernels).append((n, s, e))
    mapped = [(name, s + offset, e + offset) for name, s, e in spans]
    return Trace(kernels, others, marks[0][1], marks[-1][0], n_steps, mapped)
