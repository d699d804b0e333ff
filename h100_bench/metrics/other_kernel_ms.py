"""Device ms a step of the kernels that are neither attention nor a matrix
product: the write chain, the codecs' elementwise work, norms, RoPE,
activations, argmax. The two other classes are those of attn_ms.py and
gemm_ms.py."""

from pathlib import Path

from h100_bench.core.spec import load_module

_HERE = Path(__file__).resolve().parent
_ATTN = load_module(_HERE / "attn_ms.py", "attn_ms").matches
_GEMM = load_module(_HERE / "gemm_ms.py", "gemm_ms").matches


def read(run):
    if run.trace is None:
        return None
    return run.trace.kernel_ms_per_step(lambda n: not _ATTN(n) and not _GEMM(n))
