"""DeepSeek-V2 in the harness (archs/deepseek_v2.py, reference/deepseek_v2.py,
the dsv2-lite-golay-counts-8k cell), on the CPU:

  * the arch module and the reference state the same cache, window and
    heads, for the Lite and the port's tiny configuration;
  * a tiny cell of the architecture runs through session and check with
    ECC counts, correct; a bfloat16 one of hidden 256 passes where its fp8
    control fails, with limits between their readings at that size;
  * the new cell's counts, pinned by hand: 580 bytes a token-layer read and
    written (144 words and a scale), 2 * 16 * (576 + 512) flops a
    token-layer, and the Lite's 15.7B parameters held;
  * on the card: the latent read against its plain version, and the decode
    step's CUDA graph against the eager step, bit for bit, neither
    synchronising the host.
"""

import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from h100_bench.core import check, counts, spec
from h100_bench.reference.arms import arm
from h100_bench.tests import tiny

torch.set_num_threads(2)

TINY_DSV2 = {"hidden_size": 64, "num_attention_heads": 4, "num_hidden_layers": 3,
             "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16,
             "v_head_dim": 16, "intermediate_size": 128, "first_k_dense_replace": 1,
             "n_routed_experts": 8, "num_experts_per_tok": 2, "n_shared_experts": 1,
             "moe_intermediate_size": 32, "norm_topk_prob": False, "routed_scaling_factor": 1,
             "rope_theta": 10000, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
             "vocab_size": 256,
             "rope_scaling": {"type": "yarn", "factor": 40,
                              "original_max_position_embeddings": 64, "beta_fast": 32,
                              "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 0.707},
             "torch_dtype": "float32", "port_model": "tiny-deepseek-v2",
             "reference": "deepseek_v2"}
LITE = json.loads((spec.BENCH_DIR / "configs" / "deepseek-v2-lite.json").read_text())
CELL = "dsv2-lite-golay-counts-8k"


@pytest.mark.parametrize("config", [TINY_DSV2, LITE], ids=["tiny", "lite"])
def test_arch_module_is_tied_to_the_reference(config):
    layers = spec.arch_module(config).layers(config)
    model = importlib.import_module("h100_bench.reference.deepseek_v2").Model(config, None, None)
    assert len(layers) == model.L
    for i, layer in enumerate(layers):
        assert [tuple(r) for r in layer["rows"]] == model.cache(i)
        assert layer["window"] == model.window(i) is None
        assert layer["heads"] == model.H
        assert layer["qk_width"] == layer["rows"][0][2] and layer["pv_width"] == model.r


def test_port_sizes_are_the_configs():
    from h100_bench.core.session import port_config

    for config in (TINY_DSV2, LITE):
        cfg = port_config(config)
        assert cfg.arch == "deepseek_v2" and cfg.head_dim == config["kv_lora_rank"] + \
            config["qk_rope_head_dim"]


def test_tiny_cell_runs_correct_with_counts():
    tf = tiny.traffic("int12-golay", stats=True)
    out, nums, correct = tiny.run(TINY_DSV2, tf)
    assert correct, nums
    assert out.attempted > 0 and out.failed == 0
    assert set(out.served.stored[int(out.served.prompts.sample[0])][0].shape[2:]) == {1, 12}


def _register_mid_dsv2() -> dict:
    """A bfloat16 DeepSeek-V2 of hidden 256 over 4 layers (one dense, three
    of 8 experts), registered with the port's configs; its configuration
    file."""
    from qkv_ecc_tpu_torch.models import config as C

    name = "bench-test-dsv2-bfloat16"
    C.MODEL_CONFIGS[name] = dataclasses.replace(
        C.get_model_config("tiny-deepseek-v2"), name=name, hidden_size=256, num_layers=4,
        num_heads=4, head_dim=96, intermediate_size=512, vocab_size=1024, kv_lora_rank=64,
        qk_nope_head_dim=32, qk_rope_head_dim=32, v_head_dim=32, moe_intermediate_size=64,
        yarn_original_max_position=256, dtype="bfloat16")
    return dict(TINY_DSV2, hidden_size=256, num_hidden_layers=4, intermediate_size=512,
                vocab_size=1024, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=32,
                v_head_dim=32, moe_intermediate_size=64,
                rope_scaling=dict(TINY_DSV2["rope_scaling"], original_max_position_embeddings=256),
                torch_dtype="bfloat16", port_model=name)


def test_fp8_control_fails_where_the_bfloat16_program_passes():
    config = _register_mid_dsv2()
    limits = {"logit_gap_mean": 2e-3, "far_value_pct": 0.05, "bad_codewords": 0,
              "ecc_count_diff": 0}
    tf = tiny.traffic("int12-golay", stats=True, batch=3, prompt_min=200, prompt_max=260,
                      prefill_tokens_sq=3 * 260 * 260, new_tokens=12, check_rows=3,
                      limits=limits)
    out, nums, correct = tiny.run(config, tf, control=True)
    control = nums.pop("control")
    assert correct, nums
    assert not check.verdict(dict(nums, **control), limits, 0)[0], control


def test_cell_counts_pinned_by_hand():
    model = counts.describe(LITE)
    a = arm("int12-golay")
    L, B, T = 27, 3, 100
    ctx = np.array([30, 33, 37])
    # 72 data and 72 parity words and a scale: 580 B a token and layer
    # (counting steps read both); the new rows; q (576) and out (512) bf16
    qo = B * 16 * (576 + 512) * 2
    assert counts.attn_bytes(model, a, True, ctx) == L * (580 * T + 580 * B + qo)
    assert counts.attn_bytes(model, a, False, ctx) == L * (292 * T + 292 * B + qo)
    assert counts.attn_flops(model, ctx) == L * 2 * 16 * 1088 * T
    held = sum(layer["products_held"] + layer["small"] for layer in model["layers"])
    assert held + model["lm_head"] + 102400 * 2048 + 2048 == 15_706_484_224
    active = counts.matmul_params(model)
    assert active == 2_451_308_544
    assert spec.load_cell(CELL).traffic["batch"] == 256


@pytest.mark.card
@pytest.mark.parametrize("decode", [True, False], ids=["correcting", "scrubbed"])
def test_latent_read_on_the_card_is_its_plain_version(card, decode):
    """csrc/latent_attend.cu at the Lite's shape against latent_attend_plain
    on the CPU: caches with Golay errors of every weight, a split sequence
    (5000 tokens over a cluster), a row of context 1 and a row of page -1.
    Stored words and counts exact; outputs within the bfloat16 rounding of
    the weights, whose running maxima differ with the split (2% of the
    largest output)."""
    from qkv_ecc_tpu_torch.kernels import paged_attention as pa
    from qkv_ecc_tpu_torch.kernels import swar

    gen = torch.Generator().manual_seed(25)
    L, bs, D, H, DV = 2, 128, 576, 16, 512
    ctx = torch.tensor([5000, 1, 300, 65], dtype=torch.int32)
    B, pages = len(ctx), 40
    NB = B * pages + 1
    nib = torch.randint(0, 16, (L, NB, bs, D), generator=gen, dtype=torch.int32)
    cw = swar.golay_split_unpack(swar.golay_pack_rows_from_nibbles(nib, D), D)
    u = torch.rand((24,) + tuple(cw.shape), generator=gen)
    e = ((u < 0.03).to(torch.int32) << torch.arange(24).reshape(24, 1, 1, 1, 1)).sum(
        0, dtype=torch.int32)
    rows = swar.golay_split_pack(cw ^ e, D).permute(0, 1, 3, 2)[:, :, None]
    data, par = rows[:, :, :, :72].contiguous(), rows[:, :, :, 72:].contiguous()
    scales = torch.rand((L, NB, 1, bs), generator=gen) * 0.2 + 0.01
    table = (1 + torch.arange(B * pages, dtype=torch.int32)).reshape(B, pages)
    table[3] = -1
    q = (torch.randn((B, H, D), generator=gen) * 0.3).to(torch.bfloat16)
    new = swar.golay_pack_rows_from_nibbles(
        torch.randint(0, 16, (B, 1, D), generator=gen, dtype=torch.int32), D)
    if not decode:
        new = new[..., :72].contiguous()
    ks = torch.rand((B, 1), generator=gen) * 0.1
    outs = []
    for dev in ("cpu", "cuda"):
        a = [x.clone().to(dev) for x in (q, new, ks, data, scales, table, ctx)]
        p = par.clone().to(dev) if decode else None
        r = pa.paged_latent_write_attend(*a, 1, p, scrub=not decode, block_size=bs,
                                          sm_scale=0.1147, pv_width=DV, collect_stats=decode)
        out, st = r if decode else (r, None)
        outs.append([t.cpu() if t is not None else None
                     for t in (out.float(), st, a[3], a[4], p)])
    (o0, s0, c0, sc0, p0), (o1, s1, c1, sc1, p1) = outs
    assert torch.equal(c0, c1) and torch.equal(sc0, sc1)
    if decode:
        assert torch.equal(p0, p1) and torch.equal(s0, s1) and int(s0[0, 1]) > 0
    assert (o0 - o1).abs().max() <= 0.02 * o0.abs().max()


@pytest.mark.card
@pytest.mark.parametrize("stats", [True, False], ids=["counts", "scrubbed"])
def test_decode_step_graph_is_the_eager_step_and_syncs_nothing(card, stats):
    """tiny-deepseek-v2 in bfloat16 on the card: after one prefill, five
    decode steps eagerly (each the first, eager call of a new
    runtime.LatentGraph) and five through one LatentGraph (eager, then
    captured, then replayed) from copies of the same state and masks give
    the same logits, cache and counts to the bit and the same launch counts
    (a replay adds the captured launches), and the last three steps of each
    run under torch.cuda.set_sync_debug_mode("error")."""
    from qkv_ecc_tpu_torch.kernels.grouped import grouped_mm
    from qkv_ecc_tpu_torch.kernels.paged_attention import paged_latent_write_attend
    from qkv_ecc_tpu_torch.models import registry, runtime
    from qkv_ecc_tpu_torch.models.config import TINY_DEEPSEEK_V2
    from qkv_ecc_tpu_torch.models.kv_policy import (hoisted_logical_masks, hoisted_write_deltas,
                                                    policy_for_mode)

    cfg = dataclasses.replace(TINY_DEEPSEEK_V2, dtype="bfloat16")
    dev = torch.device("cuda")
    params = registry.init_params(cfg, seed=3, device=dev, dtype=torch.bfloat16)
    pol = policy_for_mode("int12-golay", ber=1e-2)
    B, P, L = 4, 100, cfg.num_layers
    state, table, _ = runtime.init_generation_state(cfg, pol, B, P + 8, 64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    ids = torch.randint(0, cfg.vocab_size, (B, P), device=dev, generator=gen)
    logits, state = runtime.prefill(params, ids, state, table, cfg, pol, gen)
    masks = []
    for _ in range(5):
        raw = hoisted_logical_masks(pol, L, runtime.write_mask_shape(pol, B, cfg),
                                    generator=gen, rows=1)
        masks.append(raw if stats else hoisted_write_deltas(pol, L, None, raw_masks=raw, rows=1))
    runs = []
    for graphs in (False, True):
        st = {k: v.clone() for k, v in state.items()}
        tok, out = torch.argmax(logits, -1), []
        before = (paged_latent_write_attend.launches, grouped_mm.launches)
        for j, m in enumerate(masks):
            if not graphs:
                runtime._LATENT_GRAPHS.clear()
            torch.cuda.set_sync_debug_mode("error" if j >= 2 else 0)
            try:
                lg, st = runtime.decode_step(params, tok, st, table, cfg, pol, None, 64, stats,
                                             hoisted_masks=m)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            out.append(lg)
            tok = torch.argmax(lg, -1)
        graph = runtime._LATENT_GRAPHS[st["kv_cache"]]
        assert (graph.graph is not None) == graphs and graph.calls == (5 if graphs else 1)
        launched = (paged_latent_write_attend.launches - before[0],
                    grouped_mm.launches - before[1])
        runs.append((out, st, launched))
    (eager, se, eager_n), (graphed, sg, graphed_n) = runs
    assert eager_n == graphed_n and eager_n[0] == 5 * L
    assert all(torch.equal(a, b) for a, b in zip(eager, graphed))
    for name, t in se.items():
        assert torch.equal(t, sg[name]), name
