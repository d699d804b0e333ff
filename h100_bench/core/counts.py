"""The yardstick: the bytes and operations a decode step needs, counted
from shapes, and the H100's published peaks (SXM part, dense; NVIDIA's
data sheet): HBM3 at 3.35 TB/s, 989 TFLOP/s in bfloat16, 67 TFLOP/s in
float32 outside the tensor cores.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again; contexts are those the step attends.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def attn_bytes(shape: dict, arm, collect_stats: bool, ctx_sum: int, batch: int) -> int:
    """One decode step's attention bytes over all layers. Per layer: every
    context token's stored words that the read needs (data, plus parity
    where the read corrects), and its scale, for K and V; the query and the
    output in the model dtype; the new token's written words and scales.
    ctx_sum: the step's contexts summed over rows (the new token included).
    shape: layers, heads, kv_heads, head_dim, dtype."""
    L, H, Hkv, D = shape["layers"], shape["heads"], shape["kv_heads"], shape["head_dim"]
    eb = DTYPE_BYTES[shape["dtype"]]
    read = (arm.read_words(D, collect_stats) * 4 + 4) * 2 * Hkv * ctx_sum
    if arm.scrub_decode(collect_stats):
        written = arm.data_words(D)
    else:
        written = arm.data_words(D) + arm.parity_words(D)
    new = batch * Hkv * 2 * (written * 4 + 4)
    qo = 2 * batch * H * D * eb
    return L * (read + new + qo)


def attn_flops(shape: dict, ctx_sum: int) -> int:
    """q.k and p.v of every head over every context token, all layers."""
    return shape["layers"] * 4 * shape["heads"] * shape["head_dim"] * ctx_sum


def matmul_params(shape: dict) -> int:
    """Parameters of the step's matrix products: every layer's projections
    and MLP, and the LM head."""
    E, I, H, Hkv, D = (shape["hidden"], shape["intermediate"], shape["heads"],
                       shape["kv_heads"], shape["head_dim"])
    if shape["arch"] == "llama":
        per = E * (H + 2 * Hkv) * D + H * D * E + 3 * E * I
    else:
        per = 4 * E * E + 2 * E * I
    return shape["layers"] * per + E * shape["vocab"]


def weight_bytes(shape: dict, batch: int) -> int:
    """The weights a step reads: the products' matrices whole, the norms
    and biases, and the embedding rows of the batch's tokens (and their
    position rows)."""
    E, eb, L = shape["hidden"], DTYPE_BYTES[shape["dtype"]], shape["layers"]
    if shape["arch"] == "llama":
        small = (2 * L + 1) * E
        rows = batch * E
    else:
        small = L * (4 * E + 3 * E + E + shape["intermediate"] + E) + 2 * E
        rows = 2 * batch * E
    return eb * (matmul_params(shape) + small + rows)


def step_least_s(shape: dict, arm, collect_stats: bool, ctx_sum: int, batch: int) -> float:
    """The least time of one decode step: the larger of its operations at
    the dtype's peak and its bytes (weights and attention) at HBM speed."""
    flops = 2 * batch * matmul_params(shape) + attn_flops(shape, ctx_sum)
    data = weight_bytes(shape, batch) + attn_bytes(shape, arm, collect_stats, ctx_sum, batch)
    return max(flops / PEAK_FLOPS[shape["dtype"]], data / HBM_BYTES_S)


def attn_least_s(shape: dict, arm, collect_stats: bool, ctx_sum: int, batch: int) -> float:
    return max(attn_flops(shape, ctx_sum) / PEAK_FLOPS[shape["dtype"]],
               attn_bytes(shape, arm, collect_stats, ctx_sum, batch) / HBM_BYTES_S)


def shape_of(config: dict) -> dict:
    """The sizes the counts need, from a configuration file (the published
    config's keys)."""
    if config["reference"] == "llama":
        E, H = config["hidden_size"], config["num_attention_heads"]
        return {"arch": "llama", "layers": config["num_hidden_layers"], "hidden": E,
                "heads": H, "kv_heads": config["num_key_value_heads"],
                "head_dim": config.get("head_dim") or E // H,
                "intermediate": config["intermediate_size"], "vocab": config["vocab_size"],
                "dtype": config["torch_dtype"]}
    E, H = config["n_embd"], config["n_head"]
    return {"arch": "gpt2", "layers": config["n_layer"], "hidden": E, "heads": H,
            "kv_heads": H, "head_dim": E // H, "intermediate": config.get("n_inner") or 4 * E,
            "vocab": config["vocab_size"], "dtype": config["torch_dtype"]}
