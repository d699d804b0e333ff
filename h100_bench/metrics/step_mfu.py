"""The whole step's share of the chip's peak by its binding roof: the
window's steps' least time (core/counts.py: the larger of the model's
operations at the dtype's peak and its weights plus attention bytes at
HBM speed) over the profiler-off window's wall time."""

from h100_bench.core import counts


def read(run):
    if not run.window_j:
        return None
    least = sum(counts.step_least_s(run.model, run.arm, run.collect_stats, run.ctx(j))
                for j in run.window_j)
    return 100.0 * least / run.window_s
