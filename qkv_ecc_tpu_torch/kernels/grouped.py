"""The expert layer's grouped product (models/deepseek_v2.py ``moe``): rows
of ``a`` sorted by group, group g's rows [offs[g - 1], offs[g]) multiplied
by b[g], all groups in one launch whatever their number, with the offsets
read on the device (no host sync). It replaces no TPU kernel: the JAX
package has no expert layer.

On the card it is ``torch._grouped_mm`` (CUTLASS's grouped GEMM for sm_90,
bfloat16 in, float32 accumulation): the expert weights the step reads bound
it (1.1 GB a layer at DeepSeek-V2-Lite's 64 experts), and a grouped launch
reads each expert's matrices once for all its rows. On the CPU,
``grouped_mm_plain`` computes the same function group by group. Launches
count on ``grouped_mm.launches``.
"""

from __future__ import annotations

import torch


def grouped_mm_plain(a, b, offs):
    """a [M, K], b [G, K, N], offs [G] int32 cumulative row ends (offs[-1]
    <= M; rows past it are 0) -> [M, N] in a's dtype, each group's product
    in float32."""
    out = torch.zeros((a.shape[0], b.shape[2]), dtype=a.dtype, device=a.device)
    start = 0
    for g, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = (a[start:end].to(torch.float32) @ b[g].to(torch.float32)).to(a.dtype)
        start = end
    return out


def grouped_mm(a, b, offs):
    """a [M, K] bfloat16 rows sorted by group, b [G, K, N], offs [G] int32
    -> [M, N]: torch._grouped_mm on the card, grouped_mm_plain on the CPU."""
    grouped_mm.launches += 1
    if a.device.type == "cpu":
        return grouped_mm_plain(a, b, offs)
    if a.device.type != "cuda":
        raise ValueError(f"grouped_mm: no kernel for device {a.device}")
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError(f"torch {torch.__version__} has no _grouped_mm")
    return torch._grouped_mm(a, b, offs=offs)


grouped_mm.launches = 0
