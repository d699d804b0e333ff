"""The least time of the traced steps' latent reads (core/counts.py
attn_least_s over the architecture's description: every visited row's
stored words and scale, the new rows written, the queries and outputs, at
HBM speed; q . k and p . v of every head at the bfloat16 peak), as a share
of the latent read's device time (latent_attn_ms's kernel)."""

from pathlib import Path

from h100_bench.core import counts
from h100_bench.core.spec import load_module

_LATENT = load_module(Path(__file__).resolve().parent / "latent_attn_ms.py",
                      "latent_attn_ms").matches


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_ms_per_step(_LATENT) * run.trace.steps * 1e-3
    if spent <= 0:
        return None
    least = sum(counts.attn_least_s(run.model, run.arm, run.collect_stats, run.ctx(j))
                for j in run.trace_j)
    return 100.0 * least / spent
