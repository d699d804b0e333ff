"""The bytes and operations behind attn_roofline and step_mfu: against hand
counts on fixture descriptions (2 layers, 4 query heads over 2 KV heads of
16 values, float32; 3 rows, contexts summing to 100 tokens), against the
counts the benchmark read before the architectures had modules of their
own (pinned), and the weights against that harness's draws."""

import json
import math

import numpy as np
import pytest
import torch

from h100_bench.core import counts, spec
from h100_bench.core.spec import BENCH_DIR
from h100_bench.core.weights import make_weights
from h100_bench.reference.arms import arm
from h100_bench.tests import tiny

B = 3
CTX = np.array([30, 33, 37])  # 100 tokens
QO = 2 * B * 4 * 16 * 4  # the query and the output, float32
E, I, V = 64, 128, 256
GQA = E * 64 + 2 * E * 32 + 64 * E + 3 * E * I  # q, k and v, o, the MLP


def layer(**kw):
    """A grouped-query layer: 4 heads of 16 over 2 KV heads, whole context."""
    out = {"heads": 4, "qk_width": 16, "pv_width": 16, "rows": [("k", 2, 16), ("v", 2, 16)],
           "window": None, "products_active": GQA, "products_held": GQA, "small": 2 * E}
    out.update(kw)
    return out


def model(*layers):
    return {"layers": list(layers), "embed_row": E, "lm_head": E * V, "final_norm": E,
            "dtype": "float32"}


MODEL = model(layer(), layer())


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
    want = 2 * (per_token * 100 + new + QO)
    assert counts.attn_bytes(MODEL, arm(mode), stats, CTX) == want


def test_attention_flops():
    assert counts.attn_flops(MODEL, CTX) == 2 * (2 * 4 * 16 * 100 + 2 * 4 * 16 * 100)


def test_model_counts():
    assert counts.matmul_params(MODEL) == 2 * GQA + E * V
    small = 2 * 2 * E + E  # two norms a layer and the final one
    assert counts.weight_bytes(MODEL, B) == 4 * (counts.matmul_params(MODEL) + small + B * E)


def test_least_times_take_the_binding_roof():
    a = arm("int4-hamming84-interp")
    data = counts.weight_bytes(MODEL, B) + counts.attn_bytes(MODEL, a, False, CTX)
    flops = 2 * B * counts.matmul_params(MODEL) + counts.attn_flops(MODEL, CTX)
    assert counts.step_least_s(MODEL, a, False, CTX) == max(data / 3.35e12, flops / 67e12)
    assert counts.attn_least_s(MODEL, a, False, CTX) == max(
        counts.attn_bytes(MODEL, a, False, CTX) / 3.35e12,
        counts.attn_flops(MODEL, CTX) / 67e12)


def test_windowed_layer_visits_its_window():
    """A window of 32 over contexts 30, 33, 37: 30 + 32 + 32 tokens."""
    windowed = model(layer(window=32), layer())
    a = arm("int4-write-inject")  # 2 data words a row
    assert counts.visited(CTX, 32) == 94 and counts.visited(CTX, None) == 100
    assert counts.attn_flops(windowed, CTX) == 2 * 4 * 32 * 94 + 2 * 4 * 32 * 100
    per_token = (2 * 4 + 4) * 2 * 2
    new = B * 2 * 2 * (2 * 4 + 4)
    assert counts.attn_bytes(windowed, a, False, CTX) == per_token * 194 + 2 * (new + QO)


def test_one_latent_row_read_as_k_and_v():
    """16 heads over one 576-value row a token, read whole as K (q.k over
    576) and its first 512 as V: the row's bytes counted once."""
    latent = model(layer(heads=16, qk_width=576, pv_width=512, rows=[("kv", 1, 576)]))
    a = arm("int4-write-inject")  # 576 / 8 = 72 data words a row
    assert counts.attn_flops(latent, CTX) == 2 * 16 * (576 + 512) * 100
    assert counts.attn_bytes(latent, a, False, CTX) == (
        100 * (72 * 4 + 4) + B * (72 * 4 + 4) + B * 16 * (576 + 512) * 4)


def test_experts_active_and_held_differ():
    """64 routed experts of width 1408 (6 a token) and 2 shared, at hidden
    2048: a token multiplies through 8 experts and the router, the step
    reads all 66 experts."""
    h, w = 2048, 1408
    expert = 3 * h * w
    router = h * 64
    moe = model(layer(products_active=GQA + router + 8 * expert,
                      products_held=GQA + router + 66 * expert))
    assert counts.matmul_params(moe) == GQA + router + 8 * expert + E * V
    assert counts.weight_bytes(moe, B) == 4 * (
        GQA + router + 66 * expert + E * V + 2 * E + E + B * E)


# read with the counts of the harness whose architectures were branches of
# core/counts.py, at ctx = batch x ((prompt_min + prompt_max) // 2 + 1)
PINNED = {
    "gpt2-golay-counts-1k": ("gpt2-124m", 123532032, 507196416, 31798591488, 53225717760,
                             0.009643518777313433, 0.009492116862089553),
    "mistral7b-interp-4k": ("mistral-7b-v0.3", 7113539584, 14228660224, 26659520512,
                            206225539072, 0.012205427085373134, 0.007958065824477611),
    "mistral7b-h84-chat": ("mistral-7b-v0.3", 7113539584, 14228660224, 2642935808,
                           38721814528, 0.005036297322985075, 0.0007889360620895522),
}


@pytest.mark.parametrize("traffic", sorted(PINNED))
def test_counts_of_the_cells_are_pinned(traffic):
    name, params, wbytes, abytes, aflops, step_s, attn_s = PINNED[traffic]
    config = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    tf = json.loads((BENCH_DIR / "workloads" / f"{traffic}.json").read_text())
    m, a, stats = counts.describe(config), arm(tf["mode"]), bool(tf.get("collect_ecc_stats"))
    ctx = np.full(tf["batch"], (tf["prompt_min"] + tf["prompt_max"]) // 2 + 1)
    assert counts.matmul_params(m) == params
    assert counts.weight_bytes(m, tf["batch"]) == wbytes
    assert counts.attn_bytes(m, a, stats, ctx) == abytes
    assert counts.attn_flops(m, ctx) == aflops
    assert counts.step_least_s(m, a, stats, ctx) == step_s
    assert counts.attn_least_s(m, a, stats, ctx) == attn_s


def test_shapes_of_the_configurations():
    m = counts.describe(json.loads((BENCH_DIR / "configs" / "mistral-7b-v0.3.json").read_text()))
    assert len(m["layers"]) == 32 and m["dtype"] == "bfloat16"
    assert {(x["heads"], x["qk_width"], tuple(x["rows"])) for x in m["layers"]} == {
        (32, 128, (("k", 8, 128), ("v", 8, 128)))}
    assert counts.matmul_params(m) == 32 * (4096 * 48 * 128 + 4096 * 4096 + 3 * 4096 * 14336) \
        + 4096 * 32768
    g = counts.describe(json.loads((BENCH_DIR / "configs" / "gpt2-124m.json").read_text()))
    assert len(g["layers"]) == 12 and g["embed_row"] == 2 * 768
    assert {(x["heads"], x["qk_width"], x["products_active"]) for x in g["layers"]} == {
        (12, 64, 4 * 768 * 768 + 2 * 768 * 3072)}


def _weights_before_the_arch_modules(cfg, seed: int, device) -> dict:
    """The weights as core/weights.py drew them before the architectures had
    modules of their own, kept as it was to hold the draws to it."""
    from h100_bench.core.traffic import WEIGHTS, sub_seed

    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    dtype = cfg.torch_dtype

    def normal(shape, std):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(std)

    def full(shape, value):
        return torch.full(shape, value, device=device, dtype=dtype)

    L, E, V, I = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.intermediate_size
    if cfg.arch == "llama":
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        shapes = {"q_proj": (E, H * D), "k_proj": (E, Hkv * D), "v_proj": (E, Hkv * D),
                  "o_proj": (H * D, E), "gate_proj": (E, I), "up_proj": (E, I),
                  "down_proj": (I, E)}
        stacks = {k: normal((L,) + s, 0.02) for k, s in shapes.items()}
        stacks["input_norm"] = stacks["post_attn_norm"] = full((L, E), 1.0)
        params = {"embed": normal((V, E), 0.02), "final_norm": full((E,), 1.0)}
        if not cfg.tie_word_embeddings:
            params["lm_head"] = normal((E, V), 0.02)
        params["layers"] = [{k: s[i] for k, s in stacks.items()} for i in range(L)]
        return params
    out_std = 0.02 / math.sqrt(2 * L)
    mats = {"c_attn": ((E, 3 * E), 0.02), "c_proj": ((E, E), out_std),
            "c_fc": ((E, I), 0.02), "mlp_proj": ((I, E), out_std)}
    stacks = {k: (normal((L,) + s, std), full((L, s[1]), 0.0)) for k, (s, std) in mats.items()}
    ones, zeros = full((L, E), 1.0), full((L, E), 0.0)
    layers = []
    for i in range(L):
        lp = {k: {"w": w[i], "b": b[i]} for k, (w, b) in stacks.items()}
        lp["ln_1"] = {"g": ones[i], "b": zeros[i]}
        lp["ln_2"] = {"g": ones[i], "b": zeros[i]}
        layers.append(lp)
    return {"wte": normal((V, E), 0.02),
            "wpe": normal((cfg.max_position_embeddings, E), 0.01),
            "ln_f": {"g": full((E,), 1.0), "b": full((E,), 0.0)}, "layers": layers}


@pytest.mark.parametrize("config", [tiny.TINY_LLAMA, tiny.TINY_GPT2],
                         ids=lambda c: c["port_model"])
def test_weights_are_drawn_as_before(config):
    from qkv_ecc_tpu_torch.models.config import get_model_config
    from qkv_ecc_tpu_torch.models.registry import tree_leaves

    cfg = get_model_config(config["port_model"])
    seed = 2 ** 31 + 12345
    have = tree_leaves(make_weights(spec.arch_module(config), cfg, seed, "cpu"))
    want = tree_leaves(_weights_before_the_arch_modules(cfg, seed, "cpu"))
    assert list(have) == list(want)
    assert all(torch.equal(have[k], want[k]) for k in want)
