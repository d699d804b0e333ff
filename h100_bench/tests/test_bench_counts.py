"""The bytes and operations behind attn_roofline and step_mfu, against hand
counts at tiny shapes (2 layers, 4 query heads over 2 KV heads of 16
values, float32; 3 rows, contexts summing to 100 tokens)."""

import pytest

from h100_bench.core import counts
from h100_bench.reference.arms import arm

SHAPE = {"arch": "llama", "layers": 2, "hidden": 64, "heads": 4, "kv_heads": 2, "head_dim": 16,
         "intermediate": 128, "vocab": 256, "dtype": "float32"}
B, CTX = 3, 100
QO = 2 * B * 4 * 16 * 4  # the query and the output, float32


@pytest.mark.parametrize("mode,stats,read_words,written_words", [
    # hamming84 at 16 values: 2 data words, 2 parity words
    ("int4-hamming84-interp", False, 4, 4),  # the correcting read streams parity
    ("int4-hamming84", False, 2, 2),  # scrubbed: data words only; parity stored apart
    ("int4-hamming84", True, 4, 4),  # counting steps write raw words and correct
    # golay at 16 values: 24 padded values, 8 codewords: 2 data words, 4 parity words
    ("int12-golay", True, 6, 6),
    ("int12-golay", False, 2, 2),
    # int4: 2 data words, no parity
    ("int4-write-inject", False, 2, 2),
    # hamming74 at 16 values: 32 padded values, 4 data words, 3 parity words
    ("int4-hamming", True, 7, 7),
])
def test_attention_bytes(mode, stats, read_words, written_words):
    per_token = (read_words * 4 + 4) * 2 * 2  # words and a scale, K and V, 2 KV heads
    new = B * 2 * 2 * (written_words * 4 + 4)
    want = 2 * (per_token * CTX + new + QO)
    assert counts.attn_bytes(SHAPE, arm(mode), stats, CTX, B) == want


def test_attention_flops():
    assert counts.attn_flops(SHAPE, CTX) == 2 * (2 * 4 * 16 * CTX + 2 * 4 * 16 * CTX)


def test_model_counts():
    per_layer = 64 * 64 + 2 * 64 * 32 + 64 * 64 + 3 * 64 * 128  # q, k and v, o, the MLP
    assert counts.matmul_params(SHAPE) == 2 * per_layer + 64 * 256
    gpt2 = dict(SHAPE, arch="gpt2", heads=4, kv_heads=4)
    assert counts.matmul_params(gpt2) == 2 * (3 * 64 * 64 + 64 * 64 + 2 * 64 * 128) + 64 * 256
    small = 2 * 2 * 64 + 64  # two norms a layer and the final one
    assert counts.weight_bytes(SHAPE, B) == 4 * (counts.matmul_params(SHAPE) + small + B * 64)


def test_least_times_take_the_binding_roof():
    a = arm("int4-hamming84-interp")
    data = counts.weight_bytes(SHAPE, B) + counts.attn_bytes(SHAPE, a, False, CTX, B)
    flops = 2 * B * counts.matmul_params(SHAPE) + counts.attn_flops(SHAPE, CTX)
    assert counts.step_least_s(SHAPE, a, False, CTX, B) == max(
        data / 3.35e12, flops / 67e12)
    assert counts.attn_least_s(SHAPE, a, False, CTX, B) == max(
        counts.attn_bytes(SHAPE, a, False, CTX, B) / 3.35e12,
        counts.attn_flops(SHAPE, CTX) / 67e12)


def test_shapes_of_the_configurations():
    import json
    from h100_bench.core.spec import BENCH_DIR

    m = counts.shape_of(json.loads((BENCH_DIR / "configs" / "mistral-7b-v0.3.json").read_text()))
    assert (m["layers"], m["heads"], m["kv_heads"], m["head_dim"], m["dtype"]) == (
        32, 32, 8, 128, "bfloat16")
    assert counts.matmul_params(m) == 32 * (4096 * 48 * 128 + 4096 * 4096 + 3 * 4096 * 14336) \
        + 4096 * 32768
    g = counts.shape_of(json.loads((BENCH_DIR / "configs" / "gpt2-124m.json").read_text()))
    assert (g["layers"], g["heads"], g["head_dim"], g["intermediate"]) == (12, 12, 64, 3072)
