"""Device ms a step of the expert layer's grouped products
(kernels/grouped.py grouped_mm on the card: torch._grouped_mm, CUTLASS's
grouped GEMM over a GroupProblemShape, and the kernel that prepares its
per-group problems)."""

import re

PATTERN = re.compile(r"GroupProblemShape|grouped_gemm")


def matches(name: str) -> bool:
    return bool(PATTERN.search(name))


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.kernel_ms_per_step(matches)
    return ms if ms > 0 else None
