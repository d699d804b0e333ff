"""Phase-level timing instrumentation (counterpart of
``qkv_ecc_tpu/evaluation/timing.py``).

``TimingStats``, ``AggregatedTimingStats`` and ``PHASES`` are the JAX
module's. Where JAX fences with ``block_until_ready``, the timers here
synchronise the CUDA devices that hold the given tensors
(``torch.cuda.synchronize``; nothing to wait for on the CPU), and
``time_fn_chained`` times the card with CUDA events. Phases follow the codec
pipeline: host_to_device / quantize / encode / decode / dequantize.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Dict, List

import torch

PHASES = ("host_to_device", "quantize", "encode", "decode", "dequantize")


@dataclasses.dataclass
class TimingStats:
    """Per-phase wall-clock nanoseconds for one trial."""

    phase_ns: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {p: 0 for p in PHASES}
    )
    values_processed: int = 0

    def add(self, phase: str, ns: int):
        self.phase_ns[phase] = self.phase_ns.get(phase, 0) + ns

    @property
    def total_ns(self) -> int:
        return sum(self.phase_ns.values())

    @property
    def total_ms(self) -> float:
        return self.total_ns / 1e6

    def phase_ms(self, phase: str) -> float:
        return self.phase_ns.get(phase, 0) / 1e6

    @property
    def transfer_overhead_pct(self) -> float:
        total = self.total_ns
        return 100.0 * self.phase_ns.get("host_to_device", 0) / total if total else 0.0

    @property
    def throughput_mvalues_sec(self) -> float:
        compute_ns = self.total_ns - self.phase_ns.get("host_to_device", 0)
        if compute_ns <= 0:
            return 0.0
        return self.values_processed / (compute_ns / 1e9) / 1e6


@dataclasses.dataclass
class AggregatedTimingStats:
    """Mean/std across trials per phase."""

    trials: List[TimingStats] = dataclasses.field(default_factory=list)

    def add(self, stats: TimingStats):
        self.trials.append(stats)

    def _vals(self, fn):
        return [fn(t) for t in self.trials]

    def mean_std(self, fn):
        vals = self._vals(fn)
        if not vals:
            return 0.0, 0.0
        m = sum(vals) / len(vals)
        if len(vals) > 1:
            s = (sum((v - m) ** 2 for v in vals) / (len(vals) - 1)) ** 0.5
        else:
            s = 0.0
        return m, s

    @property
    def total_ms_mean(self):
        return self.mean_std(lambda t: t.total_ms)[0]

    @property
    def total_ms_std(self):
        return self.mean_std(lambda t: t.total_ms)[1]

    @property
    def throughput_mean(self):
        return self.mean_std(lambda t: t.throughput_mvalues_sec)[0]

    @property
    def transfer_overhead_mean(self):
        return self.mean_std(lambda t: t.transfer_overhead_pct)[0]

    def phase_ms_mean(self, phase: str):
        return self.mean_std(lambda t: t.phase_ms(phase))[0]


def _tensors(value):
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)


def synchronize(value) -> None:
    """Wait for every CUDA device that holds a tensor of ``value`` (a
    tensor, or tuples, lists and dicts of them); CPU tensors are ready."""
    for dev in {t.device for t in _tensors(value) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class TimingContext:
    """Context manager attributing a block to a phase; synchronizes the
    devices of ``sync_value`` before and after so the interval is real
    device time."""

    def __init__(self, stats: TimingStats, phase: str, sync_value=None):
        self.stats = stats
        self.phase = phase
        self.sync_value = sync_value
        self._t0 = 0

    def __enter__(self):
        synchronize(self.sync_value)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        synchronize(self.sync_value)
        self.stats.add(self.phase, time.perf_counter_ns() - self._t0)
        return False


@contextmanager
def device_timer():
    """Yields a dict whose 'ns' key holds the elapsed time."""
    out = {"ns": 0}
    t0 = time.perf_counter_ns()
    yield out
    out["ns"] = time.perf_counter_ns() - t0


def run_warmup(fn, *args, iterations: int = 3):
    """Run fn a few times and wait for its result."""
    result = None
    for _ in range(iterations):
        result = fn(*args)
    synchronize(result)
    return result


def time_fn(fn, *args, iters: int = 10, warmup: int = 2):
    """Median wall time of fn(*args), each call waited for (its result's
    devices synchronised)."""
    for _ in range(warmup):
        synchronize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        synchronize(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _first_tensor(o):
    while isinstance(o, (tuple, list)):
        o = o[0]
    return o


def _chain(prev_x, out):
    """prev_x combined with a zero derived from out's first element: the
    next call's input depends on this call's output."""
    s = _first_tensor(out).reshape(-1)[0]
    if s.dtype == torch.bool:
        s = s.to(torch.uint8)
    zero = (s * 0 if s.is_floating_point() else s & 0).to(prev_x.dtype)
    return prev_x + zero if prev_x.is_floating_point() else prev_x ^ zero


def time_fn_chained(fn, x, *args, iters: int = 20, warmup: int = 3,
                    fetch_overhead_s: float = 0.0):
    """Mean time of ``fn(x, *args)`` over a data-dependence chain: each
    iteration's first input is combined with a zero derived from the
    previous output (the chain itself is a pass over x per call).

    For x on the card: CUDA events from the first timed launch to the last,
    the device's time with the chain's own kernels, with no host fetch to
    subtract. For x on the CPU: the host clock around the calls, minus
    ``fetch_overhead_s``. The argument keeps the JAX signature, whose
    default (0.025 s) is a workaround for the TPU's remote runtime; a local
    host clock has no such fetch, so the port's default is 0 and it applies
    to this host-clock path alone."""
    r = x
    for _ in range(warmup):
        r = _chain(r, fn(r, *args))
    if x.device.type == "cuda":
        with torch.cuda.device(x.device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                r = _chain(r, fn(r, *args))
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / iters
    _ = r.reshape(-1)[0].item()
    t0 = time.perf_counter()
    for _ in range(iters):
        r = _chain(r, fn(r, *args))
    _ = r.reshape(-1)[0].item()
    return max(time.perf_counter() - t0 - fetch_overhead_s, 1e-9) / iters
