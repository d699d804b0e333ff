"""The yardstick: the bytes and operations a decode step needs, counted
from the architecture's description (``archs/<name>.py``: ``layers`` and
``model``), and the H100's published peaks (SXM part, dense; NVIDIA's
data sheet): HBM3 at 3.35 TB/s, 989 TFLOP/s in bfloat16, 67 TFLOP/s in
float32 outside the tensor cores.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; contexts are those the step attends. ``ctx``
is the step's contexts, one a row, the new token included.
"""

from __future__ import annotations

import numpy as np

from .spec import arch_module

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def describe(config: dict) -> dict:
    """{"layers": archs/<name>.layers(config), and model(config)'s keys}."""
    arch = arch_module(config)
    return {"layers": arch.layers(config), **arch.model(config)}


def visited(ctx: np.ndarray, window) -> int:
    """Context tokens a layer's queries attend, summed over the rows: each
    row's context, or its window where that is shorter."""
    if window is None:
        return int(ctx.sum())
    return int(np.minimum(ctx, window).sum())


def attn_bytes(model: dict, arm, collect_stats: bool, ctx: np.ndarray) -> int:
    """One decode step's attention bytes over all layers. Per layer: every
    visited context token's stored words of each cache row that the read
    needs (data, plus parity where the read corrects, as the new token's
    are written), and its scale; the query and the output in the model
    dtype; the new token's written words and scales."""
    eb = DTYPE_BYTES[model["dtype"]]
    batch = len(ctx)
    total = 0
    for layer in model["layers"]:
        token = sum(count * (arm.read_words(width, collect_stats) * 4 + 4)
                    for _, count, width in layer["rows"])
        qo = batch * layer["heads"] * (layer["qk_width"] + layer["pv_width"]) * eb
        total += visited(ctx, layer["window"]) * token + batch * token + qo
    return total


def attn_flops(model: dict, ctx: np.ndarray) -> int:
    """q.k and p.v of every head over every visited context token, all
    layers."""
    return sum(2 * layer["heads"] * (layer["qk_width"] + layer["pv_width"])
               * visited(ctx, layer["window"]) for layer in model["layers"])


def matmul_params(model: dict) -> int:
    """Parameters of the matrix products one token goes through: every
    layer's active products, and the LM head."""
    return sum(layer["products_active"] for layer in model["layers"]) + model["lm_head"]


def weight_bytes(model: dict, batch: int) -> int:
    """The weights a step reads: every layer's held matrices, the LM head,
    the norms and biases, and the embedding rows of the batch's tokens."""
    held = sum(layer["products_held"] + layer["small"] for layer in model["layers"])
    return DTYPE_BYTES[model["dtype"]] * (held + model["lm_head"] + model["final_norm"]
                                          + batch * model["embed_row"])


def step_least_s(model: dict, arm, collect_stats: bool, ctx: np.ndarray) -> float:
    """The least time of one decode step: the larger of its operations at
    the dtype's peak and its bytes (weights and attention) at HBM speed."""
    batch = len(ctx)
    flops = 2 * batch * matmul_params(model) + attn_flops(model, ctx)
    data = weight_bytes(model, batch) + attn_bytes(model, arm, collect_stats, ctx)
    return max(flops / PEAK_FLOPS[model["dtype"]], data / HBM_BYTES_S)


def attn_least_s(model: dict, arm, collect_stats: bool, ctx: np.ndarray) -> float:
    return max(attn_flops(model, ctx) / PEAK_FLOPS[model["dtype"]],
               attn_bytes(model, arm, collect_stats, ctx) / HBM_BYTES_S)
