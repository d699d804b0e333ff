"""Device ms a step of the matrix products (cuBLAS and CUTLASS kernels:
projections, MLP and LM head)."""

import re

PATTERN = re.compile(r"gemm|gemv|nvjet|xmma|cutlass|cublas|splitk|Kernel2", re.IGNORECASE)


def matches(name: str) -> bool:
    return bool(PATTERN.search(name))


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_ms_per_step(matches)
