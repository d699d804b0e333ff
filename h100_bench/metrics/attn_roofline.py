"""The least time of the traced steps' attention work (core/counts.py:
the larger of its bytes at HBM speed and its operations at the dtype's
peak), as a share of the attention kernels' device time."""

from pathlib import Path

from h100_bench.core import counts
from h100_bench.core.spec import load_module

_ATTN = load_module(Path(__file__).resolve().parent / "attn_ms.py", "attn_ms").matches


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_ms_per_step(_ATTN) * run.trace.steps * 1e-3
    if spent <= 0:
        return None
    least = sum(counts.attn_least_s(run.model, run.arm, run.collect_stats, run.ctx(j))
                for j in run.trace_j)
    return 100.0 * least / spent
