"""DeepSeek-V2 on the port (models/deepseek_v2.py, the latent cache of
models/runtime.py, the latent read of kernels/paged_attention.py, the
grouped product of kernels/grouped.py), on the CPU at the tiny
configuration, against tests/plain_deepseek_v2.py (plain torch, the
published non-absorbed form) and the cache's arithmetic as
h100_bench/reference/codecs.py writes it from its definitions:

  * prefill then decode steps give the plain forward's logits over the same
    round trip (prefill: an uncorrectable Golay word keeps its data; decode:
    it reads 0), in int12-golay scrubbed and counting, at BER 0 and 1e-2;
    the stored words are the reference's encode with the replayed flips
    (scrubbed where the mode scrubs), and the counts are the flips' counts,
    each latent codeword once a read;
  * the latent read's plain version is the non-absorbed attention over the
    port's own decoded rows; its pairs of byte-lane groups are golay.cuh's
    rows of 3 data and 3 parity words;
  * the expert layer is a per-token loop over experts, in three grouped
    launches whatever the expert count; rows of page -1 leave live rows as
    they were; YaRN's frequencies and softmax scale are the published
    formulas' numbers, written out; causal_attention's default keeps gpt2's
    and llama's logits to the bit;
  * every other arm, the mesh, the server and training raise for the
    architecture.
"""

import dataclasses
import functools

import pytest
import torch

from h100_bench.reference import codecs as cd
from qkv_ecc_tpu_torch.kernels import grouped, swar
from qkv_ecc_tpu_torch.kernels import paged_attention as pa
from qkv_ecc_tpu_torch.models import deepseek_v2 as ds
from qkv_ecc_tpu_torch.models import layers, registry, runtime
from qkv_ecc_tpu_torch.models.config import TINY_DEEPSEEK_V2, TINY_GPT2, TINY_LLAMA
from qkv_ecc_tpu_torch.models.kv_policy import hoisted_write_deltas, policy_for_mode

import plain_deepseek_v2 as plain

torch.set_num_threads(1)
CFG = TINY_DEEPSEEK_V2
B, P, N, BS = 2, 21, 5, 16
W = CFG.head_dim  # 48 values a row: 16 codewords
NCW = W // 3


def sizes(cfg=CFG) -> dict:
    return {"hidden_size": cfg.hidden_size, "num_attention_heads": cfg.num_heads,
            "kv_lora_rank": cfg.kv_lora_rank, "qk_nope_head_dim": cfg.qk_nope_head_dim,
            "qk_rope_head_dim": cfg.qk_rope_head_dim, "v_head_dim": cfg.v_head_dim,
            "first_k_dense_replace": cfg.first_k_dense_replace,
            "n_routed_experts": cfg.n_routed_experts,
            "num_experts_per_tok": cfg.num_experts_per_tok, "norm_topk_prob": cfg.norm_topk_prob,
            "routed_scaling_factor": cfg.routed_scaling_factor, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.rms_norm_eps,
            "rope_scaling": {"type": "yarn", "factor": cfg.yarn_factor,
                             "original_max_position_embeddings": cfg.yarn_original_max_position,
                             "beta_fast": cfg.yarn_beta_fast, "beta_slow": cfg.yarn_beta_slow,
                             "mscale": cfg.yarn_mscale, "mscale_all_dim": cfg.yarn_mscale_all_dim}}


@pytest.fixture(scope="module")
def params():
    return registry.init_params(CFG, seed=0, device="cpu")


def _read(q, s, e, keep):
    """Clean nibbles q [.., W] with flips e [.., 16] read back: Golay's
    decode, an uncorrectable word keeping its data (``keep``) or reading 0."""
    delta, ok, _ = cd.golay_decode_error(e)
    d = cd.golay_data_of_values(q) ^ delta
    if not keep:
        d = torch.where(ok, d, torch.zeros_like(d))
    return cd.dequantize(cd.golay_values_of_data(d, W), s)


def _encode(q):
    d = cd.golay_data_of_values(q)
    return d | cd.golay_tables("cpu")[0][d.long()] << 12


def _scrubbed(cw, e):
    delta, ok, _ = cd.golay_decode_error(e)
    d = torch.where(ok, (cw & 0xFFF) ^ delta, torch.zeros_like(cw))
    return d | cd.golay_tables("cpu")[0][d.long()] << 12


def run_program(params, mode_stats, ber, seed=5):
    """Prefill B prompts of P tokens, then N greedy decode steps with write
    masks drawn here: (prefill logits, decode logits [N, B, V], fed tokens
    [B, N], the state, the prefill's flips [L][B, P, 16], the decode's
    [L][B, N, 16], the prompt ids)."""
    scrub = mode_stats == "scrubbed"
    pol = policy_for_mode("int12-golay", ber=ber, seed=7)
    L = CFG.num_layers
    ids = torch.randint(0, CFG.vocab_size, (B, P), generator=torch.Generator().manual_seed(seed))
    state, table, _ = runtime.init_generation_state(CFG, pol, B, P + N, BS, device="cpu")
    logits, state = runtime.prefill(params, ids, state, table, CFG, pol,
                                    torch.Generator().manual_seed(seed + 1))
    replay = torch.Generator().manual_seed(seed + 1)
    pre = [cd.flip_pattern((B, P, 1, NCW), ber, 24, replay)[:, :, 0] if ber else
           torch.zeros((B, P, NCW), dtype=torch.int32) for _ in range(L)]
    masks = torch.Generator().manual_seed(seed + 2)
    dec, out, fed = [], [], []
    tok = torch.argmax(logits, -1)
    for _ in range(N):
        fed.append(tok)
        raw = (cd.flip_pattern((L, 1, B, 1, 1, NCW), ber, 24, masks) if ber
               else torch.zeros((L, 1, B, 1, 1, NCW), dtype=torch.int32))
        dec.append(raw[:, 0, :, 0, 0])
        hoisted = None
        if ber:
            hoisted = (hoisted_write_deltas(pol, L, None, raw_masks=raw, rows=1) if scrub
                       else raw)
        step, state = runtime.decode_step(params, tok, state, table, CFG, pol, None, BS,
                                          not scrub, hoisted_masks=hoisted)
        out.append(step)
        tok = torch.argmax(step, -1)
    dec = torch.stack(dec, 2)  # [L, B, N, 16]
    return logits, torch.stack(out), torch.stack(fed, 1), state, table, pre, list(dec), ids


@pytest.mark.parametrize("ber", [0.0, 1e-2])
@pytest.mark.parametrize("mode_stats", ["scrubbed", "counts"])
def test_prefill_and_decode_match_the_plain_forward(params, mode_stats, ber, monkeypatch):
    """The program as it runs (its latent read in bfloat16) against the
    plain forward's logits; then, with the read in float32 ("highest", so
    that the decode rows are the plain forward's to float32's rounding), the
    logits again, the stored words to the bit and the counts."""
    fast = run_program(params, mode_stats, ber)
    monkeypatch.setattr(runtime, "paged_latent_write_attend",
                        functools.partial(pa.paged_latent_write_attend, precision="highest"))
    logits, steps, fed, state, table, pre, dec, ids = run_program(params, mode_stats, ber)
    kept = {}

    def prefill_rt(layer, rows):
        q, s = cd.quantize_int4(rows)
        kept[layer] = (q, s)
        return _read(q, s, pre[layer], keep=True)

    def decode_rt(layer, rows):
        qd, sd = cd.quantize_int4(rows[:, P:])
        kept[layer] = (torch.cat([kept[layer][0], qd], 1), torch.cat([kept[layer][1], sd], 1))
        return _read(*kept[layer], torch.cat([pre[layer], dec[layer]], 1), keep=False)

    want_pre = plain.forward(params, sizes(), ids, prefill_rt)[:, -1]
    want_dec = plain.forward(params, sizes(), torch.cat([ids, fed], 1), decode_rt)[:, P:]
    # prefill attends in float32 throughout, as the decode at "highest":
    # float32's own rounding, in another order (the absorbed query)
    assert torch.allclose(logits, want_pre, rtol=1e-4, atol=1e-5)
    assert torch.allclose(steps.transpose(0, 1), want_dec, rtol=1e-4, atol=1e-5)
    # the read as it runs rounds the query and each weight p * scale to
    # bfloat16 (2^-9 relative each): a percent of the logits' range
    assert torch.equal(fast[2], fed)  # the same tokens fed at this size
    assert (fast[1].transpose(0, 1) - want_dec).abs().max() <= 1e-2 * want_dec.abs().max()

    # stored words: the reference's encode with the replayed flips
    L = CFG.num_layers
    for b in range(B):
        pages = table[b].long()
        rows = torch.cat([state["kv_cache"][:, pages], state["kv_parity"][:, pages]], 3)
        rows = rows.permute(0, 1, 4, 2, 3).reshape(L, -1, 1, rows.shape[3])[:, :P + N, 0]
        stored = cd.stored_codewords("golay", rows, W)  # [L, P + N, 16]
        for layer in range(L):
            cw = _encode(kept[layer][0][b])
            e = torch.cat([pre[layer][b], dec[layer][b]])
            want = _scrubbed(cw, e)
            if mode_stats == "counts":  # decode steps write raw words
                want[P:] = (cw ^ e)[P:]
            assert torch.equal(stored[layer], want), (b, layer)
            scales = state["kv_scales"][layer, pages, 0].reshape(-1)[:P + N]
            assert torch.allclose(scales, kept[layer][1][b], rtol=1e-5, atol=0)

    if mode_stats == "counts":  # each decode row's codewords, once a read after its write
        corr, det = torch.zeros(B, dtype=torch.int64), torch.zeros(B, dtype=torch.int64)
        for layer in range(L):
            _, ok, cnt = cd.golay_decode_error(dec[layer])  # [B, N, 16]
            reads = (N - torch.arange(N))[None, :, None]
            corr += (torch.where(cnt < 4, cnt, 0) * reads).sum((1, 2))
            det += ((cnt == 4).to(torch.int64) * reads).sum((1, 2))
        assert state["ecc_corrected"].tolist() == corr.tolist()
        assert state["ecc_detected"].tolist() == det.tolist()
        if ber:
            assert corr.sum() > 0


@pytest.mark.parametrize("ctxs", [(P + N, 7), (1, P + 2)])
def test_latent_read_is_the_non_absorbed_attention(params, ctxs):
    """The plain latent read at "highest" over a cache the program wrote
    (the row at ctx - 1 written again as it stands), through W_UV, against
    the published form over the same rows decoded: every head's k_nope and
    v from the latent through kv_b_proj, k_pe shared."""
    _, _, _, state, table, _, _, _ = run_program(params, "counts", 1e-2)
    layer, lp = 2, params["layers"][2]
    r, nope, H = CFG.kv_lora_rank, CFG.qk_nope_head_dim, CFG.num_heads
    ctx = torch.tensor(ctxs, dtype=torch.int32)
    q = torch.randn((B, 1, H, nope + CFG.qk_rope_head_dim),
                    generator=torch.Generator().manual_seed(ctxs[1]))
    rows = pa.gather_pages(state["kv_cache"], table, layer, table.shape[1], state["kv_parity"])
    sc = pa.gather_scales(state["kv_scales"], table, layer, table.shape[1])
    last = (ctx.long() - 1)[:, None]
    new = rows[torch.arange(B)[:, None], last][:, :, 0]  # [B, 1, W']
    ks = sc[torch.arange(B)[:, None], last][..., 0]  # [B, 1]
    out = pa.latent_attend_plain(ds.absorb(q, lp, CFG), new, ks, state["kv_cache"].clone(),
                                 state["kv_scales"].clone(), table, ctx, layer,
                                 state["kv_parity"].clone(), sm_scale=ds.softmax_scale(CFG),
                                 pv_width=r, precision="highest")
    w_uv = lp["kv_b_proj"].view(r, H, -1)[:, :, nope:]
    got = torch.einsum("bhr,rhv->bhv", out, w_uv)
    nib = pa.decode_rows("golay", rows, swar.data_words("golay", W), W)[0][:, :, 0, :W]
    vals = (nib.float() - 8.0) * sc  # [B, T, W]
    kv = (vals[..., :r] @ lp["kv_b_proj"]).reshape(B, -1, H, nope + CFG.v_head_dim)
    k = torch.cat([kv[..., :nope], vals[:, :, None, r:].expand(-1, -1, H, -1)], -1)
    s = torch.einsum("bhd,bthd->bht", q[:, 0], k) * ds.softmax_scale(CFG)
    live = torch.arange(k.shape[1])[None, :] < ctx[:, None]
    p = torch.softmax(torch.where(live[:, None], s, -torch.inf), -1)
    want = torch.einsum("bht,bthv->bhv", p, kv[..., nope:])
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-6)


def test_latent_pairs_are_golay_rows_of_three_words():
    """A latent row of WD data and WD parity words (WD = 3h) holds h pairs
    of byte-lane groups {G, G + h}, whose six words are golay_split_pack's
    row of their 8 codewords at 24 values: what csrc/latent_attend.cu
    decodes with golay.cuh's decode_row_lanes<3, 3>."""
    for width in (W, 576):
        C = swar.padded_values("golay", width) // 3
        cw = torch.randint(0, 1 << 24, (7, C), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(width))
        row = swar.golay_split_pack(cw, width)
        WD = swar.data_words("golay", width)
        h = WD // 3
        assert swar.parity_words("golay", width) == WD and WD % 3 == 0
        for G in range(h):
            six = row[:, [G, G + h, G + 2 * h, WD + G, WD + h + G, WD + 2 * h + G]]
            pair = torch.cat([cw[:, 4 * G:4 * G + 4], cw[:, 4 * (G + h):4 * (G + h) + 4]], -1)
            assert torch.equal(six, swar.golay_split_pack(pair, 24)), (width, G)


@pytest.mark.parametrize("experts", [8, 16])
def test_expert_layer_is_the_per_token_loop(experts):
    cfg = dataclasses.replace(CFG, n_routed_experts=experts, num_experts_per_tok=3)
    lp = registry.init_params(cfg, seed=experts, device="cpu")["layers"][1]
    h = torch.randn((2, 9, cfg.hidden_size), generator=torch.Generator().manual_seed(1))
    before = grouped.grouped_mm.launches
    got = ds.moe(h, lp, cfg, "t", 1)
    assert grouped.grouped_mm.launches - before == 3  # gate, up, down: whatever the count
    x = h.reshape(-1, cfg.hidden_size)
    want = []
    for t in range(x.shape[0]):
        scores = torch.softmax(x[t] @ lp["router"], -1)
        w, idx = torch.topk(scores, 3)
        y = sum(w[j] * ds._swiglu(x[t], lp["experts_gate"][e], lp["experts_up"][e],
                                  lp["experts_down"][e]) for j, e in enumerate(idx.tolist()))
        want.append(y + ds._swiglu(x[t], lp["shared_gate"], lp["shared_up"], lp["shared_down"]))
    assert torch.allclose(got.reshape(-1, cfg.hidden_size), torch.stack(want),
                          rtol=1e-5, atol=1e-6)


def test_grouped_plain_skips_empty_groups():
    a = torch.randn(6, 4)
    b = torch.randn(3, 4, 5)
    offs = torch.tensor([2, 2, 6], dtype=torch.int32)
    out = grouped.grouped_mm_plain(a, b, offs)
    assert torch.allclose(out, torch.cat([a[:2] @ b[0], a[2:] @ b[2]]))


def test_rows_of_page_minus_one_leave_live_rows_unchanged(params):
    """A row whose block-table entries are -1 (an inactive slot) writes its
    decode rows into the trash page 0 and reads nothing of the live rows:
    the live rows' logits, counts and pages are those of a run without it."""
    pol = policy_for_mode("int12-golay", ber=1e-2, seed=7)
    L = CFG.num_layers
    ids = torch.randint(0, CFG.vocab_size, (2, P), generator=torch.Generator().manual_seed(3))
    out = {}
    for dead in (False, True):
        Bt = 3 if dead else 2
        state, _, _ = runtime.init_generation_state(CFG, pol, 3, 2 * BS, BS, device="cpu")
        table = torch.tensor([[1, 2], [3, 4], [-1, -1]][:Bt], dtype=torch.int32)
        _, state = runtime.prefill(params, ids, state, table[:2], CFG, pol,
                                   torch.Generator().manual_seed(9))
        if dead:
            state["context_len"] = torch.cat([state["context_len"],
                                              torch.zeros(1, dtype=torch.int32)])
        gen = torch.Generator().manual_seed(4)
        tok = torch.arange(Bt) + 5
        logits = []
        for _ in range(3):
            raw = cd.flip_pattern((L, 1, 3, 1, 1, NCW), 1e-2, 24, gen)[:, :, :Bt]
            step, state = runtime.decode_step(params, tok, state, table, CFG, pol, None, BS,
                                              True, hoisted_masks=raw)
            logits.append(step[:2])
        out[dead] = (torch.stack(logits), state["kv_cache"][:, 1:5], state["kv_parity"][:, 1:5],
                     state["ecc_corrected"][:2], state["ecc_detected"][:2])
    # a third row changes the products' blocking (and the experts' rows):
    # float32's rounding in the logits; the stored words and counts exact
    assert torch.allclose(out[False][0], out[True][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(out[False][1:], out[True][1:]):
        assert torch.equal(a, b)


def test_latent_graph_key_holds_every_array_and_first_call_is_eager(params):
    """runtime.LatentGraph fits a call only while every array its body reads
    or writes is the one it was made for (the three cache arrays, each
    parameter), and its first run is the eager body: the step's logits and
    counts to the bit, with no entry in the state."""
    pol = policy_for_mode("int12-golay", ber=1e-2, seed=7)
    state, table, _ = runtime.init_generation_state(CFG, pol, B, 2 * BS, BS, device="cpu")
    ids = torch.randint(0, CFG.vocab_size, (B, P), generator=torch.Generator().manual_seed(3))
    logits, state = runtime.prefill(params, ids, state, table, CFG, pol,
                                    torch.Generator().manual_seed(9))
    raw = cd.flip_pattern((CFG.num_layers, 1, B, 1, 1, NCW), 1e-2, 24,
                          torch.Generator().manual_seed(4))
    tok = torch.argmax(logits, -1)
    args = (params, CFG, pol, BS, True, False)
    inputs = (tok, state["context_len"], raw, table)
    graph = runtime.LatentGraph(state, *args, *inputs)
    assert graph.fits(state, *args, *inputs)
    for name in ("kv_cache", "kv_parity", "kv_scales"):
        assert not graph.fits({**state, name: state[name].clone()}, *args, *inputs), name
    moved = {**params, "layers": [dict(lp) for lp in params["layers"]]}
    moved["layers"][-1]["kv_b_proj"] = moved["layers"][-1]["kv_b_proj"].clone()
    assert not graph.fits(state, moved, *args[1:], *inputs)
    eager = {k: v.clone() for k, v in state.items()}
    want, eager = runtime.decode_step(params, tok, eager, table, CFG, pol, None, BS, True,
                                      hoisted_masks=raw)
    got, counts = graph.run(state, *inputs)
    assert torch.equal(got, want) and graph.graph is None and graph.calls == 1
    assert torch.equal(counts[0], eager["ecc_corrected"])
    assert torch.equal(counts[1], eager["ecc_detected"])
    assert torch.equal(state["kv_cache"], eager["kv_cache"])
    assert set(eager) == set(state) | {"ecc_corrected", "ecc_detected"}


def test_yarn_frequencies_and_scale_are_the_published_numbers():
    """DeepSeek-V2-Lite's 32 rope pairs (dim 64, theta 10^4, factor 40 over
    4096 positions, beta 32 and 1): the correction range is [10, 23], so
    pair i keeps 10^(-i/8) up to 10, is divided by 40 from 23, and blends
    linearly between; the softmax scale is 192^-0.5 (0.1 * 0.707 * ln 40 +
    1)^2."""
    from qkv_ecc_tpu_torch.models.config import DEEPSEEK_V2_LITE as LITE

    f = ds.inv_freq(LITE, "cpu").double()
    assert f.shape == (32,)
    want = {0: 1.0, 10: 0.05623413251903491, 16: 0.0055, 31: 3.3338035804083097e-06}
    for i, v in want.items():
        assert abs(f[i].item() - v) <= 1e-6 * v, (i, f[i].item(), v)
    assert abs(ds.softmax_scale(LITE) - 0.11472138679292611) < 1e-12
    assert abs(layers.yarn_mscale(40, 0.707) - 1.2608037774058533) < 1e-12
    assert ds._rope_mscale(LITE) == 1.0


def _old_causal_attention(q, k, v, num_kv_groups, *, kv_offset=0, sliding_window=None):
    """causal_attention as it stood before it took a scale and a V width."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, Hkv, num_kv_groups, D)
    s = torch.einsum("bshgd,bthd->bhgst", qg, k).to(torch.float32) / torch.sqrt(
        torch.tensor(float(D), dtype=torch.float32))
    qi = torch.arange(S, device=q.device)[:, None]
    tj = torch.arange(T, device=q.device)[None, :]
    mask = tj <= qi + kv_offset
    if sliding_window is not None:
        mask = mask & (tj > qi + kv_offset - sliding_window)
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhgst,bthd->bshgd", w, v).reshape(B, S, Hq, D)


@pytest.mark.parametrize("cfg", [TINY_GPT2, TINY_LLAMA], ids=["gpt2", "llama"])
def test_causal_attention_default_keeps_logits_to_the_bit(cfg, monkeypatch):
    params = registry.init_params(cfg, seed=1, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(2))
    pol = policy_for_mode("int4-hamming84", ber=1e-2)
    new = registry.forward(params, ids, cfg, pol)[0]
    module = registry.arch_module(cfg)
    monkeypatch.setattr(module, "causal_attention", _old_causal_attention)
    old = registry.forward(params, ids, cfg, pol)[0]
    assert torch.equal(new, old)


@pytest.mark.parametrize("mode", ["fp16", "fp8", "int4", "int4-write-inject", "int4-hamming",
                                  "int4-hamming84", "int4-hamming84-interp"])
def test_other_arms_raise(params, mode):
    with pytest.raises(NotImplementedError, match="deepseek_v2"):
        runtime.init_generation_state(CFG, policy_for_mode(mode, ber=1e-2), 1, 32, BS,
                                      device="cpu")


def test_mesh_server_and_training_raise(params):
    from qkv_ecc_tpu_torch.parallel.sharding import param_specs
    from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer
    from qkv_ecc_tpu_torch.training.trainer import train_loss

    pol = policy_for_mode("int12-golay", ber=1e-2)
    with pytest.raises(NotImplementedError, match="deepseek_v2.*server"):
        ContinuousBatchingServer(params, CFG, pol, max_batch=2, max_seq_len=64, block_size=BS,
                                 device="cpu")
    with pytest.raises(NotImplementedError, match="deepseek_v2.*tensor parallelism"):
        param_specs(CFG)
    with pytest.raises(NotImplementedError, match="deepseek_v2.*training"):
        train_loss(params, torch.zeros((1, 9), dtype=torch.long), CFG, pol)
    state, table, _ = runtime.init_generation_state(CFG, pol, 1, 32, BS, device="cpu")
    with pytest.raises(NotImplementedError, match="deepseek_v2.*mesh"):
        runtime.prefill(params, torch.zeros((1, 4), dtype=torch.long), state, table, CFG, pol,
                        torch.Generator(), mesh=object())
