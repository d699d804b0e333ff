#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qkv_ecc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one process per source,
all at once), holds every kernel branch against its plain PyTorch version at
the bench-0.9b shapes - the float codecs' read K2f (float_attend: fp16's
bfloat16 and fp8's e4m3 pages, the write+attend with bf16 and fp32 queries
at precision "fast" and "highest", a -1 page, F4, and the read alone with
an empty row, the softmax state with a sliding window, and NaN pages: a NaN
in a live K slot, a live V slot, a dead V slot of the last page and a page
past the context in the last chunk, NaN where the plain version has it),
the packed write+attend kernels (the scrubbed extract read, int4's
read-time injection, the hamming84 / hamming74 / golay correcting reads
with and without ECC statistics, the -1 page clamp, precision "highest")
and K4, the read alone (paged_attention_ecc: every branch with and without
statistics, the softmax state with a sliding window, an empty row, a -1
page, and the chunk-clamped pages of F4 on all three kernels) - and checks
the card against the CPU on tiny-llama in every mode, fp16 and fp8
included. Then it drives bench-0.9b (random bf16 weights from a seed)
through the port's entry points on four paths:
  * the decode slice: batch 8, prompt 1024, 32 greedy steps at BER 1e-2 in
    the five arms of the JAX bench.py (int12-golay, int4-hamming84,
    int4-hamming, int4-hamming84-interp, int4-write-inject), the
    unprotected read-inject arm int4 and the float arms fp16 (the default
    KVCachePolicy(), never injected) and fp8 (write injection of its
    bytes), round-robin over two rounds;
  * the stats phase: decode_loop(collect_ecc_stats=True) for 8 steps in
    int4, int12-golay, int4-hamming, int4-hamming84 and
    int4-hamming84-interp (the protected ones without scrub), whose counts
    must show corrections, detections and int4's flip rate;
  * the engine phase: ECCEngine at bench-0.9b's attention width (24 layers,
    16/8 heads), a 1024-token prompt and 32 decode steps per layer through
    K4, in hamming84, hamming74, golay and int4 with write injection and the
    UnprotectedBackend with read injection, BER 1e-2;
  * the serve phase: ContinuousBatchingServer, 8 slots, 12 requests of
    256-1024 prompt tokens and 32-64 new ones, in int4-write-inject,
    int4-hamming84, int12-golay (BER 1e-2) and fp16, and a BER-0 check that
    staggered requests give generate()'s tokens.
Each path checks that every kernel branch it calls was launched exactly as
often as it calls it. Then it times the kernels (K2f beside
scaled_dot_product_attention over the same context stored dense, fp16's
yardstick) and traces the decode step of each arm. Every phase prints one line with its seconds; any failure exits
non-zero. Without a CUDA device it fails.

Output, last lines: the kernel table as one JSON object, the card's name and
power limit from nvidia-smi, then {"ok": true, "device": {...}}.
"""

import json
import subprocess
import sys
import time

T0 = time.perf_counter()
BER = 1e-2
BATCH, PROMPT, STEPS = 8, 1024, 32
STATS_STEPS = 8
ENGINE_STEPS = 32
ROUNDS = 2
# bench.py's arms, in its order, then the unprotected read-inject arm and the
# float arms (fp16, the default KVCachePolicy(), and fp8); the fifth is the
# baseline of the ratios
MODES = ("int12-golay", "int4-hamming84", "int4-hamming", "int4-hamming84-interp",
         "int4-write-inject", "int4", "fp16", "fp8")
BASELINE = "int4-write-inject"
# the stats phase's arms (the protected ones without scrub)
STATS_MODES = ("int4", "int12-golay", "int4-hamming", "int4-hamming84", "int4-hamming84-interp")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3 rate and fp32 rate outside the
PEAK_FP32_FLOPS = 67e12     # tensor cores (NVIDIA data sheet)
# 32-bit integer operations counted from the sources: the SECDED decode of
# one data word with its parity word (decode_attend.cu: codeword rebuild 10,
# two SWAR decodes of 49, repack 4) and the interpolation of one word (10);
# hamming74's decode of one data word (parity gather 8 lanes x 3 planes x 4,
# syndromes 15, correction 14, count 5); golay's IMLD of one codeword
# (rebuild 18, two products by B of 60, two candidate loops of 72 and 84,
# selects and counts 22, repack 9); the read flips of one word (32 hashes of
# 12.5: fmix32 8, counter, compare, insert; XOR and count 5)
DECODE_OPS_PER_WORD, INTERP_OPS_PER_WORD = 112, 10
H74_OPS_PER_WORD, GOLAY_OPS_PER_CODEWORD, INJECT_OPS_PER_WORD = 130, 325, 405


def say(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.perf_counter() - self.t
        say(f"[{self.name}] {'ok' if exc_type is None else 'FAILED'} in {dt:.2f} s")
        return False


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def encoded_cache(torch, cfg, codec, ctx_before, block_size, gen, device):
    """A one-layer-per-cfg cache holding random K/V written through the
    codec's write chain at the given context lengths."""
    from qkv_ecc_tpu_torch.models.kv_policy import encode_pack_kv_scrubbed, KVCachePolicy
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state, _write_tokens

    policy = KVCachePolicy(codec=codec)
    B = len(ctx_before)
    T = max(ctx_before) + 1
    state, bt, _ = init_generation_state(cfg, policy, B, T, block_size, device=device)
    pos = torch.arange(T, device=device).expand(B, T)
    for layer in range(cfg.num_layers):
        k = torch.randn((B, T, cfg.num_kv_heads, cfg.head_dim), generator=gen, device=device)
        v = torch.randn((B, T, cfg.num_kv_heads, cfg.head_dim), generator=gen, device=device)
        kc, ks = encode_pack_kv_scrubbed(k, policy)
        vc, vs = encode_pack_kv_scrubbed(v, policy)
        _write_tokens(state, layer, bt, pos, kc, vc, ks, vs)
    return state, bt, policy


def kernel_check(torch, gen, device):
    """write_attend's clean read against write_attend_plain at bench-0.9b
    attention shapes: unequal contexts (1, partial pages, 1024, 1152), int4,
    golay and hamming74 data words, bf16 and fp32 queries, one call with a
    sliding window, one at precision "highest". Caches and scales must be
    equal; outputs within output_tolerance."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B
    from qkv_ecc_tpu_torch.models.kv_policy import encode_pack_kv_scrubbed

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    ctx_before = [0, 1023, 1151, 129, 500, 777, 64, 1000]  # after the write: 1 .. 1152
    B, Hq, Hkv, D = len(ctx_before), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = 0.0
    cases = [("int4", torch.bfloat16, None, "fast"), ("golay", torch.bfloat16, None, "fast"),
             ("golay", torch.float32, None, "fast"), ("int4", torch.bfloat16, 256, "fast"),
             ("hamming74", torch.bfloat16, None, "fast"),
             ("golay", torch.float32, None, "highest")]
    for codec, qdtype, window, precision in cases:
        state, bt, policy = encoded_cache(torch, cfg, codec, ctx_before, 128, gen, device)
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
        kn, ksn = encode_pack_kv_scrubbed(
            torch.randn((B, Hkv, D), generator=gen, device=device), policy)
        vn, vsn = encode_pack_kv_scrubbed(
            torch.randn((B, Hkv, D), generator=gen, device=device), policy)
        dw = state["k_cache"].shape[3]
        kn, vn = kn[..., :dw].contiguous(), vn[..., :dw].contiguous()
        ctx = torch.tensor(ctx_before, dtype=torch.int32, device=device) + 1
        names = ("k_cache", "v_cache", "k_scales", "v_scales")
        a = {n: state[n].clone() for n in names}
        p = {n: state[n].clone() for n in names}
        out = write_attend(q, kn, vn, ksn, vsn, *(a[n] for n in names), bt, ctx, 1,
                           codec=codec, scrub=True, sliding_window=window, precision=precision)
        torch.cuda.synchronize()
        ref = write_attend_plain(q, kn, vn, ksn, vsn, *(p[n] for n in names), bt, ctx, 1,
                                 sm_scale=D ** -0.5, sliding_window=window, precision=precision)
        worst = max(worst, check_outputs(
            f"write_attend {codec} q={str(qdtype)[6:]} window={window} precision={precision}",
            out, ref, a, p, names))
    return worst


# tokens given a double error in values 0-3 of every row, K and V: 0, the
# seam tokens of 512-token chunks (511, 1023) and the tokens after them; the
# new column at ctx-1 gets one too
SEAM_TOKENS = (0, 510, 511, 512, 1022, 1023, 1024)


def unscrubbed_cache(torch, cfg, mode, ctx_before, gen, device, ber=2e-2):
    """A cache as an unscrubbed arm writes it - raw codewords, random flips
    at BER 2e-2 from the generator (golay: about 0.17% of codewords
    uncorrectable, hamming84: 1.1% of values doubles) - and the new rows
    (data ++ parity). hamming84 gets a double error forced at SEAM_TOKENS
    and in every new row."""
    import dataclasses
    from qkv_ecc_tpu_torch.models.kv_policy import encode_kv, pack_kv, policy_for_mode
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state, _write_tokens

    policy = dataclasses.replace(policy_for_mode(mode, ber=ber), scrub=False)
    B, Hkv, D = len(ctx_before), cfg.num_kv_heads, cfg.head_dim
    T = max(ctx_before) + 1
    state, bt, _ = init_generation_state(cfg, policy, B, T, 128, device=device)
    pos = torch.arange(T, device=device).expand(B, T)
    forced = torch.zeros((T,), dtype=torch.bool, device=device)
    if policy.codec == "hamming84":
        forced[[t for t in SEAM_TOKENS if t < T]] = True

    def rows(shape, force):
        cw, scale, _ = encode_kv(torch.randn(shape, generator=gen, device=device), policy,
                                 generator=gen)
        if policy.codec == "hamming84":
            cw[..., :4] ^= torch.where(force[..., None, None], 0x11, 0).to(torch.int32)
        return pack_kv(cw, policy, D), scale

    for layer in range(cfg.num_layers):
        kc, ks = rows((B, T, Hkv, D), forced[None, :].expand(B, T))
        vc, vs = rows((B, T, Hkv, D), forced[None, :].expand(B, T))
        _write_tokens(state, layer, bt, pos, kc, vc, ks, vs)
    new = torch.ones((B, 1), dtype=torch.bool, device=device)
    kn, ksn = rows((B, 1, Hkv, D), new)
    vn, vsn = rows((B, 1, Hkv, D), new)
    return state, bt, (kn[:, 0].contiguous(), vn[:, 0].contiguous(),
                       ksn[:, 0].contiguous(), vsn[:, 0].contiguous())


def check_outputs(name, out, ref, a, p, names, stats=None, ref_stats=None):
    """Arrays after the write equal, stats equal, outputs within
    output_tolerance (per element: 2^-7 |plain| + 2^-8 max |plain| of its
    row); returns the largest |kernel - plain|."""
    import torch

    for n in names:
        if not torch.equal(a[n], p[n]):
            fail(f"{name}: {n} after the write differs from the plain version")
    if stats is not None and not torch.equal(stats, ref_stats):
        fail(f"{name}: stats {stats.tolist()} differ from the plain version's {ref_stats.tolist()}")
    diff = (out.float() - ref.float()).abs()
    tol = output_tolerance(ref)
    err = diff.max().item()
    counts = "" if stats is None else f"; stats equal, summed over the batch {stats.sum(0).tolist()}"
    say(f"  {name}: max |kernel - plain| = {err:.3e}, largest share of its tolerance "
        f"{(diff / tol.clamp(min=1e-30)).max().item():.3e}; arrays after the write equal{counts}")
    if not bool((diff <= tol).all()) or not torch.isfinite(out).all():
        fail(f"{name}: output differs beyond tolerance")
    return err


def decode_kernel_check(torch, gen, device):
    """decode_attend against write_decode_attend_plain at bench-0.9b
    attention shapes (B 8, Hkv 8, group 2, head_dim 128, contexts 1 to 1152,
    layer 1), 512-token chunks: hamming84 with and without interpolation
    (doubles forced at tokens 0, 511, 512, 1023, 1024 and ctx-1), with and
    without stats; hamming74 and golay, with and without stats; golay once
    more with one row whose page is -1 (ctx 1: written to page 0, which no
    other row reads). Caches, parity, scales and stats must be equal;
    outputs within output_tolerance. Returns the largest error of each
    codec's branch."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        h84_decode_rows, gather_pages, paged_attention_ecc_write_attend as write_attend,
        write_decode_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    ctx_before = [1151, 1023, 1024, 0, 511, 512, 777, 1100]  # after the write: 1 .. 1152
    B, Hq, D = len(ctx_before), cfg.num_heads, cfg.head_dim
    names = ("k_cache", "v_cache", "k_scales", "v_scales", "k_parity", "v_parity")
    worst = {}
    for mode in ("int4-hamming84", "int4-hamming", "int12-golay"):
        state, bt, new = unscrubbed_cache(torch, cfg, mode, ctx_before, gen, device)
        codec = {"int4-hamming84": "hamming84", "int4-hamming": "hamming74",
                 "int12-golay": "golay"}[mode]
        ctx = torch.tensor(ctx_before, dtype=torch.int32, device=device) + 1
        if codec == "hamming84":
            rows = gather_pages(state["k_cache"], bt, 1, bt.shape[1], state["k_parity"])
            _, dbl = h84_decode_rows(rows, state["k_cache"].shape[3])
            say(f"  hamming84 cache: {int(dbl.sum())} K values of layer 1 read as doubles")
        variants = [(i, st) for i in ((True, False) if codec == "hamming84" else (False,))
                    for st in (False, True)]
        if codec == "golay":
            variants.append(("-1 page", False))
        for interp, stats in variants:
            bt_c, ctx_c = bt, ctx
            if interp == "-1 page":  # row 3 (ctx 1) has no page; row 0 reads none
                bt_c, ctx_c = bt.clone(), ctx.clone()
                bt_c[3] = -1
                ctx_c[0] = 0
            q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
            a = {n: state[n].clone() for n in names}
            p = {n: state[n].clone() for n in names}
            out = write_attend(q, new[0], new[1], new[2], new[3], a["k_cache"], a["v_cache"],
                               a["k_scales"], a["v_scales"], bt_c, ctx_c, 1, a["k_parity"],
                               a["v_parity"], codec=codec, scrub=False,
                               use_interpolation=interp is True, collect_stats=stats)
            torch.cuda.synchronize()
            ref = write_decode_attend_plain(
                q, new[0], new[1], new[2], new[3], p["k_cache"], p["v_cache"], p["k_scales"],
                p["v_scales"], bt_c, ctx_c, 1, p["k_parity"], p["v_parity"], codec=codec,
                sm_scale=D ** -0.5, interpolate=interp is True, pages_per_chunk=4,
                collect_stats=stats)
            (out, st), (ref, ref_st) = (out, ref) if stats else ((out, None), (ref, None))
            name = f"decode_attend {codec} interpolate={interp} stats={stats}"
            err = check_outputs(name, out, ref, a, p, names, st, ref_st)
            if stats and not (int(st[:, 0].sum()) > 0
                              and (codec == "hamming74" or int(st[:, 1].sum()) > 0)):
                fail(f"{name}: the errors in the cache were not counted")
            if interp == "-1 page" and torch.equal(a["k_cache"][1, 0], state["k_cache"][1, 0]):
                fail(f"{name}: the row whose page is -1 did not write page 0")
            key = codec + ("-interp" if interp is True else "")
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def read_inject_check(torch, gen, device):
    """int4's read-time injection (write_attend with read_inject_ber 1e-2, a
    device seed) against write_attend_plain at bench-0.9b attention shapes,
    with and without stats: caches and scales equal (they change only in the
    new column), the flipped-bit count equal, outputs within
    output_tolerance."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    ctx_before = [0, 1023, 1151, 129, 500, 777, 64, 1000]
    B, Hq, D = len(ctx_before), cfg.num_heads, cfg.head_dim
    state, bt, new = unscrubbed_cache(torch, cfg, "int4", ctx_before, gen, device, ber=0.0)
    ctx = torch.tensor(ctx_before, dtype=torch.int32, device=device) + 1
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    worst = 0.0
    for stats in (False, True):
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
        seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen, device=device).to(torch.int32)
        a = {n: state[n].clone() for n in names}
        p = {n: state[n].clone() for n in names}
        out = write_attend(q, *new, *(a[n] for n in names), bt, ctx, 1, codec="int4",
                           read_inject_ber=BER, read_inject_seed=seed, collect_stats=stats)
        torch.cuda.synchronize()
        ref = write_attend_plain(q, *new, *(p[n] for n in names), bt, ctx, 1,
                                 sm_scale=D ** -0.5, read_threshold=int(BER * 2 ** 32),
                                 read_seed=seed, pages_per_chunk=4, collect_stats=stats)
        (out, st), (ref, ref_st) = (out, ref) if stats else ((out, None), (ref, None))
        err = check_outputs(f"write_attend int4 read-inject BER {BER} stats={stats}", out, ref,
                            a, p, names, st, ref_st)
        if stats:
            bits = int(ctx.sum()) * cfg.num_kv_heads * 2 * state["k_cache"].shape[3] * 32
            rate = int(st[:, 0].sum()) / bits
            say(f"    flipped {int(st[:, 0].sum())} of {bits} bits read: rate {rate:.6f}")
            if not 0.9 * BER < rate < 1.1 * BER or int(st[:, 1].sum()) != 0:
                fail("read-inject: the flipped-bit count is off its rate")
        worst = max(worst, err)
    return worst


# K4's contexts at the check: 1 to 1152 tokens, row 3 (ctx 1) on a page of
# -1 (it reads page 0), row 5 empty
K4_CTX = [1152, 1024, 1025, 1, 512, 0, 778, 1101]
# (cache mode, codec, options) of every K4 branch
K4_BRANCHES = {
    "read": ("int4", "int4", {}),
    "read-inject": ("int4", "int4", {"read_inject_ber": BER}),
    "extract": ("scrubbed", "golay", {"scrub": True}),
    "hamming84-interp": ("int4-hamming84", "hamming84", {"use_interpolation": True}),
    "hamming84": ("int4-hamming84", "hamming84", {}),
    "hamming74": ("int4-hamming", "hamming74", {}),
    "golay": ("int12-golay", "golay", {}),
}


def check_state(name, got, want):
    """return_softmax_state: acc within output_tolerance of the plain
    version's (weights are at most 1, so a rounding of one weight moves acc
    no more than the output), m and l within 1e-5 relative (fp32 sums and
    exp in another order); the empty row gives 0, -1e30 and 0."""
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    tol = output_tolerance(acc_p)
    err = (acc - acc_p).abs().max().item()
    ok = bool(((acc - acc_p).abs() <= tol).all())
    for a, b in ((m, m_p), (l, l_p)):
        ok = ok and bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5).all())
    empty = not acc[5].any() and bool((m[5] == -1e30).all()) and not l[5].any()
    say(f"  {name}: softmax state, max |acc kernel - plain| = {err:.3e}, max |m - m plain| = "
        f"{(m - m_p).abs().max().item():.3e}, max |l - l plain| / l = "
        f"{((l - l_p).abs() / l_p.clamp(min=1e-30)).max().item():.3e}; empty row 0, -1e30, 0: "
        f"{empty}")
    if not ok or not empty:
        fail(f"{name}: the softmax state differs from the plain version's")
    return err


def attend_check(torch, gen, device):
    """K4 (paged_attention_ecc, the read without a write) against
    attend_plain at bench-0.9b attention shapes (B 8, Hkv 8, group 2,
    head_dim 128, contexts K4_CTX: 1 to 1152 tokens, a row whose page is -1,
    an empty row; layer 1, 512-token chunks), every branch with and without
    stats (the extract read refuses them), then each with
    return_softmax_state and a sliding window of 256. Caches must be
    unchanged, stats equal, outputs (and acc) within output_tolerance, m and
    l within 1e-5 relative, the empty row 0. Then the F4 input: num_pages 5
    of a 9-page table at 512-token chunks (the kernel visits 8 pages, pages
    5-7 read page 4 again), K4, write_attend and decode_attend against their
    plain versions. Returns the largest error of each K4 branch."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        attend_plain, paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_attend_plain, write_decode_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    ctx_before = [c - 1 for c in K4_CTX]
    B, Hq, D = len(K4_CTX), cfg.num_heads, cfg.head_dim
    names = ("k_cache", "v_cache", "k_scales", "v_scales", "k_parity", "v_parity")
    ctx = torch.tensor(K4_CTX, dtype=torch.int32, device=device)
    caches, worst = {}, {}
    for mode in ("int4", "scrubbed", "int4-hamming84", "int4-hamming", "int12-golay"):
        if mode == "scrubbed":
            state, bt, _ = encoded_cache(torch, cfg, "golay", [max(c, 0) for c in ctx_before],
                                         128, gen, device)
        else:
            state, bt, _ = unscrubbed_cache(torch, cfg, mode, [max(c, 0) for c in ctx_before],
                                            gen, device, ber=0.0 if mode == "int4" else 2e-2)
        bt_k4 = bt.clone()
        bt_k4[3] = -1
        caches[mode] = (state, bt_k4, bt)

    def run(branch, stats, window=None, state_out=False, num_pages=None):
        mode, codec, kw = K4_BRANCHES[branch]
        state, bt, _ = caches[mode]
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
        before = {n: state[n].clone() for n in names if n in state}
        parity = (state.get("k_parity"), state.get("v_parity"))
        args = (q, state["k_cache"], state["v_cache"], state["k_scales"], state["v_scales"], bt,
                ctx, 1)
        kw = dict(kw)
        seed = None
        if "read_inject_ber" in kw:
            seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen, device=device).to(torch.int32)
            kw["read_inject_seed"] = seed
        out = paged_attention_ecc(*args, *parity, codec=codec, num_pages=num_pages,
                                  collect_stats=stats, sliding_window=window,
                                  return_softmax_state=state_out, **kw)
        torch.cuda.synchronize()
        extract = codec == "int4" or kw.get("scrub")
        ref = attend_plain(*args, *(() if extract else parity), codec="int4" if extract else codec,
                           sm_scale=D ** -0.5, num_pages=num_pages or bt.shape[1],
                           pages_per_chunk=4, sliding_window=window,
                           read_threshold=int(BER * 2 ** 32) if seed is not None else None,
                           read_seed=seed if seed is not None else 0,
                           interpolate=kw.get("use_interpolation", False), collect_stats=stats,
                           return_softmax_state=state_out)
        for n, a in before.items():
            if not torch.equal(a, state[n]):
                fail(f"K4 {branch}: the read changed {n}")
        (out, st), (ref, ref_st) = (out, ref) if stats else ((out, None), (ref, None))
        label = (f"paged_attention_ecc {branch} stats={stats}" + (f" window={window}" if window else "")
                 + (f" num_pages={num_pages}" if num_pages else ""))
        if state_out:
            if stats and not torch.equal(st, ref_st):
                fail(f"{label}: stats {st.tolist()} differ from the plain version's")
            return check_state(label, out, ref)
        err = check_outputs(label, out, ref, {}, {}, (), st, ref_st)
        if out[5].any():
            fail(f"{label}: the empty row did not read 0")
        return err

    for branch in K4_BRANCHES:
        for stats in (False,) if branch == "extract" else (False, True):
            worst[branch] = max(worst.get(branch, 0.0), run(branch, stats))
        worst[branch] = max(worst[branch], run(branch, branch != "extract", window=256,
                                               state_out=True))
    # F4 on the card: K4 of int4 and hamming74 with stats, num_pages 5
    for branch in ("read", "hamming74"):
        worst[branch] = max(worst[branch], run(branch, True, num_pages=5))
    # ... and the write+attend kernels on the same input, with row 3 on its
    # own page (a row of -1 would write page 0, which row 0 reads)
    for mode, codec in (("int4", "int4"), ("int4-hamming", "hamming74")):
        state, _, bt = caches[mode]
        parity = () if codec == "int4" else (state["k_parity"], state["v_parity"])
        W = state["k_cache"].shape[3] + (parity[0].shape[3] if parity else 0)
        new = [torch.randint(0, 2 ** 31, (B, cfg.num_kv_heads, W), generator=gen,
                             device=device).to(torch.int32) for _ in range(2)]
        sn = torch.rand((B, cfg.num_kv_heads), generator=gen, device=device)
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
        a = {n: state[n].clone() for n in names if n in state}
        p = {n: state[n].clone() for n in names if n in state}
        out = write_attend(q, *new, sn, sn, a["k_cache"], a["v_cache"], a["k_scales"],
                           a["v_scales"], bt, ctx, 1, *(() if codec == "int4" else
                                                        (a["k_parity"], a["v_parity"])),
                           codec=codec, num_pages=5, collect_stats=True)
        torch.cuda.synchronize()
        plain = write_attend_plain if codec == "int4" else write_decode_attend_plain
        extra = {} if codec == "int4" else dict(codec=codec)
        ref = plain(q, *new, sn, sn, p["k_cache"], p["v_cache"], p["k_scales"], p["v_scales"],
                    bt, ctx, 1, *(() if codec == "int4" else (p["k_parity"], p["v_parity"])),
                    sm_scale=D ** -0.5, num_pages=5, pages_per_chunk=4, collect_stats=True,
                    **extra)
        check_outputs(f"{'write_attend' if codec == 'int4' else 'decode_attend'} {codec} "
                      "num_pages=5 (F4)", out[0], ref[0], a, p, tuple(a), out[1], ref[1])
    return worst


# the float checks' contexts after the write: 1 to 1152 tokens
FLOAT_CTX = [1152, 1024, 1025, 1, 512, 130, 778, 1101]
NAN_BITS = {"fp16": 0x7FC0, "fp8": 0x7F}


def float_cache(torch, cfg, codec, gen, device, tokens=1152):
    """A float cache of every layer of cfg with a value in every slot (a
    recycled page keeps old values in its dead slots): normals, a tenth of
    them times 30, stored as the codec stores them; random scales arrays
    (a float read must leave them as they are); the sequential table."""
    from qkv_ecc_tpu_torch.kernels.common import to_float_storage
    from qkv_ecc_tpu_torch.models.kv_policy import KVCachePolicy
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state

    state, bt, _ = init_generation_state(cfg, KVCachePolicy(codec=codec), len(FLOAT_CTX),
                                         tokens, 128, device=device)
    for n in ("k_cache", "v_cache"):
        x = torch.randn(state[n].shape, generator=gen, device=device)
        x = torch.where(torch.rand(x.shape, generator=gen, device=device) < 0.1, 30 * x, x)
        state[n].copy_(to_float_storage(codec, x))
    for n in ("k_scales", "v_scales"):
        state[n].copy_(torch.rand(state[n].shape, generator=gen, device=device))
    return state, bt


def raw_bits(t):
    """A cache array as integers of its width (NaN compares by its bits)."""
    import torch

    return t.view({torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8}.get(
        t.dtype, t.dtype))


def check_float(name, out, ref, a=None, p=None):
    """Float reads: arrays after the write equal bit for bit (e4m3 through
    its bytes), NaN where the plain version has NaN and nowhere else, the
    rest within output_tolerance; returns the largest |kernel - plain| of
    the finite elements."""
    import torch

    for n in a or {}:
        if not torch.equal(raw_bits(a[n]), raw_bits(p[n])):
            fail(f"{name}: {n} after the write differs from the plain version")
    out, ref = out.float(), ref.float()
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan):
        fail(f"{name}: NaN at {int(torch.isnan(out).sum())} elements of the output, the plain "
             f"version at {int(nan.sum())}")
    ref0, out0 = torch.where(nan, 0.0, ref), torch.where(nan, 0.0, out)
    diff = (out0 - ref0).abs()
    tol = output_tolerance(ref0)
    err = diff.max().item()
    say(f"  {name}: max |kernel - plain| = {err:.3e}, largest share of its tolerance "
        f"{(diff / tol.clamp(min=1e-30)).max().item():.3e}; NaN at the plain version's "
        f"{int(nan.sum())} elements" + ("; arrays after the write equal" if a else ""))
    if not bool((diff <= tol).all()) or not bool(torch.isfinite(out0).all()):
        fail(f"{name}: output differs beyond tolerance")
    return err


def float_kernel_check(torch, gen, device):
    """K2f (write_attend.cu's float_attend) against its plain versions at
    bench-0.9b attention shapes (B 8, Hkv 8, group 2, head_dim 128, block
    128, 512-token chunks, layer 1, contexts FLOAT_CTX), in fp16 (bfloat16
    pages) and fp8 (e4m3): the write+attend with bf16 and fp32 queries, at
    precision "fast" and "highest"; the same with row 3 on a page of -1
    (written to page 0, which row 0, now empty, does not read); K4, the read
    alone, with an empty row (5) and a -1 page, as the output and as the
    softmax state with a sliding window of 256; F4: num_pages 5 of the
    10-page table (the kernel visits 8, reading page 4 again) for both; and
    a cache with NaN (e4m3 0x7f, bfloat16 0x7fc0) in a live K slot (row 1,
    token 100), a live V slot (row 2, token 7), a dead V slot of the last
    page (row 6, token 800) and a V slot of a page past the context in the
    last chunk (row 5, token 300): NaN where the plain version has NaN.
    Arrays after the write equal, the scales arrays unchanged. Last, the
    widening alone: one-token contexts whose V values are all 256 e4m3
    codes (every 8th bfloat16 code) read out exactly torch's conversion.
    Returns the largest error of each (codec, write or read)."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.common import to_float_storage
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        attend_plain, paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    B, Hq, Hkv, D = len(FLOAT_CTX), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    worst = {}
    for codec in ("fp16", "fp8"):
        state, bt = float_cache(torch, cfg, codec, gen, device)
        scales = {n: state[n].clone() for n in ("k_scales", "v_scales")}
        ctx = torch.tensor(FLOAT_CTX, dtype=torch.int32, device=device)

        def new():
            return [to_float_storage(codec, torch.randn((B, Hkv, D), generator=gen,
                                                        device=device)) for _ in range(2)]

        def write(label, qdtype=torch.bfloat16, precision="fast", bt=bt, ctx=ctx, num_pages=None,
                  st=state):
            q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
            kn, vn = new()
            sn = torch.ones((B, Hkv), device=device)
            a = {n: st[n].clone() for n in names}
            p = {n: st[n].clone() for n in names}
            out = write_attend(q, kn, vn, sn, sn, *(a[n] for n in names), bt, ctx, 1, codec=codec,
                               precision=precision, num_pages=num_pages)
            torch.cuda.synchronize()
            ref = write_attend_plain(q, kn, vn, sn, sn, *(p[n] for n in names), bt, ctx, 1,
                                     sm_scale=D ** -0.5, precision=precision, codec=codec,
                                     num_pages=num_pages, pages_per_chunk=4)
            for n in ("k_scales", "v_scales"):
                if not torch.equal(a[n], scales[n]):
                    fail(f"K2f {codec} {label}: the write changed {n}")
            key = (codec, "write")
            worst[key] = max(worst.get(key, 0.0),
                             check_float(f"float_attend {codec} write+attend {label}", out, ref, a, p))

        def read(label, bt=bt, ctx=ctx, num_pages=None, window=None, state_out=False, st=state):
            q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
            args = (q, *(st[n] for n in names), bt, ctx, 1)
            before = {n: st[n].clone() for n in names}
            out = paged_attention_ecc(*args, codec=codec, num_pages=num_pages,
                                      sliding_window=window, return_softmax_state=state_out,
                                      collect_stats=True)
            torch.cuda.synchronize()
            ref = attend_plain(*args, codec=codec, sm_scale=D ** -0.5,
                               num_pages=num_pages or bt.shape[1], pages_per_chunk=4,
                               sliding_window=window, return_softmax_state=state_out)
            (out, stats) = out
            if stats.any():
                fail(f"K2f {codec} read {label}: stats {stats.tolist()} are not zeros")
            for n in names:
                if not torch.equal(raw_bits(before[n]), raw_bits(st[n])):
                    fail(f"K2f {codec} read {label}: the read changed {n}")
            key = (codec, "read")
            if state_out:
                err = check_float(f"paged_attention_ecc {codec} {label} acc", out[0], ref[0])
                for x, y, what in ((out[1], ref[1], "m"), (out[2], ref[2], "l")):
                    if not bool((((x - y).abs() <= 1e-5 * y.abs() + 1e-5) | (x.isnan() & y.isnan())
                                 ).all()):
                        fail(f"K2f {codec} read {label}: {what} differs from the plain version's")
            else:
                err = check_float(f"paged_attention_ecc {codec} {label}", out, ref)
            worst[key] = max(worst.get(key, 0.0), err)
            return out

        write("q=bf16")
        write("q=fp32", qdtype=torch.float32)
        write("q=fp32 precision=highest", qdtype=torch.float32, precision="highest")
        bt_neg, ctx_neg = bt.clone(), ctx.clone()
        bt_neg[3] = -1
        ctx_neg[0] = 0
        write("row 3 on page -1, row 0 empty", bt=bt_neg, ctx=ctx_neg)
        write("num_pages=5 (F4)", num_pages=5)
        ctx_k4 = ctx.clone()
        ctx_k4[5] = 0
        out = read("empty row 5, row 3 on page -1", bt=bt_neg, ctx=ctx_k4)
        if out[5].any():
            fail(f"K2f {codec}: the empty row did not read 0")
        acc = read("softmax state, window 256", ctx=ctx_k4, window=256, state_out=True)
        if acc[0][5].any() or not bool((acc[1][5] == -1e30).all()) or acc[2][5].any():
            fail(f"K2f {codec}: the empty row's softmax state is not 0, -1e30, 0")
        read("num_pages=5 (F4)", num_pages=5)
        # NaN pages (row, token, K or V): a live K slot, a live V slot, a dead
        # V slot of the last page, a V slot of a page past the context that
        # the last 512-token chunk holds
        poisoned = {n: state[n].clone() for n in names}
        for row, tok, n in ((1, 100, "k_cache"), (2, 7, "v_cache"), (6, 800, "v_cache"),
                            (5, 300, "v_cache")):
            page = int(bt[row, tok // 128])
            raw = poisoned[n].view(torch.uint8 if codec == "fp8" else torch.int16)
            raw[1, page, 0, 5, tok % 128] = NAN_BITS[codec]
        write("NaN pages", st=poisoned)
        out = read("NaN pages", st=poisoned)
        nan = torch.isnan(out.float())
        if not (nan[2, :2, 5].all() and nan[6, :2, 5].all() and nan[5, :2, 5].all()
                and not out[1, :2].any()):
            fail(f"K2f {codec}: the NaN pages did not reach the output as on the TPU")
        read("NaN pages, softmax state", st=poisoned, state_out=True)
        # the widening, exactly: a context of one token (each row's new
        # column) at precision "highest" reads out its V values unchanged, so
        # the fp32 output holds the kernel's widening of every code written:
        # all 256 e4m3 codes, every 8th bfloat16 code (each exponent, the
        # subnormals, +-inf and NaN among them)
        bits = torch.uint8 if codec == "fp8" else torch.int16
        n = B * Hkv * D
        codes = (torch.arange(n, device=device) % 256 if codec == "fp8" else
                 torch.arange(n, device=device) * 8 - 2 ** 15).to(bits)
        vn = codes.reshape(B, Hkv, D).view(state["v_cache"].dtype)
        kn = new()[0]
        one = torch.ones_like(ctx)
        q = torch.randn((B, Hq, D), generator=gen, device=device)
        sn = torch.ones((B, Hkv), device=device)
        a = {n: state[n].clone() for n in names}
        out = write_attend(q, kn, vn, sn, sn, *(a[n] for n in names), bt, one, 1, codec=codec,
                           precision="highest")
        torch.cuda.synchronize()
        want = vn.to(torch.float32).repeat_interleave(Hq // Hkv, dim=1)
        same = torch.equal(torch.isnan(out), torch.isnan(want)) and torch.equal(
            torch.nan_to_num(out, posinf=1e38, neginf=-1e38),
            torch.nan_to_num(want, posinf=1e38, neginf=-1e38))
        say(f"  float_attend {codec} widening of {len(torch.unique(codes))} codes, against "
            f"torch's: {'equal' if same else 'DIFFERENT'}")
        if not same:
            fail(f"K2f {codec}: the kernel widens stored values otherwise than torch")
    return worst


# the engine phase's arms: the write-injected codecs, the unprotected
# read-inject arm (UnprotectedBackend) and the float codecs (their reads take
# the general path, as in the JAX engine)
ENGINE_ARMS = ("hamming84", "hamming74", "golay", "int4", "unprotected", "fp16", "fp8")


def engine_phase(torch, gen, device, smi, steps):
    """ECCEngine at bench-0.9b's attention width (24 layers, 16/8 heads,
    head_dim 128, block 128), one sequence per arm: a 1024-token prompt
    written and attended (causal, the general path) per layer, then `steps`
    decode steps of write (1 token) and attend (S = 1: K4) per layer, q, k
    and v from a seeded generator, BER 1e-2 (write injection; read
    injection for the unprotected arm). The float arms fp16 and fp8 read
    through the general path at every step, as the JAX engine does. Checks:
    K4 launched exactly steps x 24 times per arm, in the arm's branch (the
    float arms: never); at the last step the K4 output
    of layer 23 within 2e-2 of the general path on the same cache (the
    unprotected arm: a clean K4 read), as tests/test_engine.py:110 - except
    golay's, where the two paths differ by design (K4 reads an uncorrectable
    codeword as 0, the general path keeps its data) and the output is held
    to K4's plain version instead, within output_tolerance; corrections
    (hamming84, golay: and detections) counted; fp8's flipped bits counted,
    fp16's none; the unprotected arm's flipped / (BER x bits read) within
    0.98-1.02. Returns K4's launches by branch over the arms."""
    from qkv_ecc_tpu_torch.cache.engine import ECCEngine, ECCEngineConfig, _attend_general
    from qkv_ecc_tpu_torch.cache.unprotected import (
        UnprotectedBackend, UnprotectedEngineConfig, get_unprotected_stats)
    from qkv_ecc_tpu_torch.kernels.paged_attention import attend_plain, paged_attention_ecc
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B as cfg

    L, Hq, Hkv, D = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    launches = dict.fromkeys(paged_attention_ecc.launches_by, 0)
    branch = {"hamming84": "hamming84", "hamming74": "hamming74", "golay": "golay",
              "int4": "read", "unprotected": "read-inject", "fp16": None, "fp8": None}
    for arm in ENGINE_ARMS:
        kw = dict(ber=BER, inject_errors=True, seed=42, block_size=128, num_blocks=16, max_seqs=1)
        if arm == "unprotected":
            eng = UnprotectedBackend(UnprotectedEngineConfig(**kw), L, Hq, Hkv, D, device=device)
        else:
            eng = ECCEngine(ECCEngineConfig(codec=arm, **kw), L, Hq, Hkv, D, device=device)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device)

        torch.cuda.synchronize()
        t = time.perf_counter()
        for layer in range(L):
            eng.write(randn(PROMPT, Hkv, D), randn(PROMPT, Hkv, D), layer)
            out = eng.attend(randn(Hq, PROMPT, D), layer)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        # fp8's injected bytes may be NaN (0x7f, 0xff), as in the JAX engine
        nan_ok = arm == "fp8"
        if out.shape != (Hq, PROMPT, D) or not (nan_ok or torch.isfinite(out).all()):
            fail(f"engine {arm}: prefill attention not finite or of the wrong shape")
        reset_counts(paged_attention_ecc)
        t = time.perf_counter()
        for step in range(steps):
            for layer in range(L):
                eng.write(randn(1, Hkv, D), randn(1, Hkv, D), layer, start_pos=PROMPT + step)
                q1 = randn(Hq, 1, D)
                out = eng.attend(q1, layer)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / steps
        got = dict(paged_attention_ecc.launches_by)
        for k, v in got.items():
            launches[k] += v
        check_launches(f"engine {arm}", {f"K4 {k}": (v, steps * L if k == branch[arm] else 0,
                                                     f"{steps} steps x {L} layers" if
                                                     k == branch[arm] else "none")
                                         for k, v in got.items()})
        ctx = PROMPT + steps
        if arm == "golay":
            c = eng.cache
            general = attend_plain(
                q1[:, 0][None], c["k_cache"], c["v_cache"], c["k_scales"], c["v_scales"],
                eng.manager.block_table()[:1], torch.tensor([ctx], dtype=torch.int32,
                                                            device=device), L - 1,
                c["k_parity"], c["v_parity"], codec="golay", sm_scale=D ** -0.5,
                num_pages=-(-ctx // 128), pages_per_chunk=4)[0][:, None]
        else:
            general, *_ = _attend_general(q1, eng.cache, eng.manager.block_table()[0], L - 1,
                                          codec=eng.config.codec, use_interpolation=False,
                                          head_dim=D, num_ctx=ctx, causal=False)
        if arm == "unprotected":  # the read above flipped bits: compare a clean one
            out = paged_attention_ecc(
                q1[:, 0][None].contiguous(), eng.cache["k_cache"], eng.cache["v_cache"],
                eng.cache["k_scales"], eng.cache["v_scales"], eng.manager.block_table()[:1],
                torch.tensor([ctx], dtype=torch.int32, device=device), L - 1, codec="int4",
                num_pages=-(-ctx // 128))[0][:, None]
        nan = torch.isnan(general)
        diff = (torch.where(nan, 0.0, out.float()) - torch.where(nan, 0.0, general)).abs()
        err = diff.max().item()
        close = torch.equal(torch.isnan(out.float()), nan) and (
            bool((diff <= output_tolerance(torch.where(nan, 0.0, general))).all())
            if arm == "golay" else err <= 2e-2)
        stats = eng.stats
        line = (f"  engine {arm}: prefill {PROMPT} tokens x {L} layers in {prefill_s:.3f} s; "
                f"{ms:.3f} ms per decode step ({L} layers of write + "
                f"{'K4' if branch[arm] else 'general'} attend); last step "
                f"|{'K4' if branch[arm] else 'general path'} - "
                f"{'plain K4' if arm == 'golay' else 'general path'}| = {err:.3e} "
                f"({'output_tolerance' if arm == 'golay' else 'tolerance 2e-2'}"
                + (f"; NaN at the same {int(nan.sum())} elements" if nan_ok else "")
                + f"); stats {stats}")
        if arm == "unprotected":
            ratio = stats["actual_ber"] / BER
            line += f"; actual_ber / BER = {ratio:.6f} (band 0.98-1.02)"
            ok = 0.98 <= ratio <= 1.02 and get_unprotected_stats(eng)["bits_flipped"] > 0
        elif arm in ("int4", "fp8"):
            ok = stats["bits_flipped"] > 0
        elif arm == "fp16":
            ok = stats["bits_flipped"] == 0
        else:
            ok = stats["errors_corrected"] > 0 and (arm == "hamming74" or stats["errors_detected"] > 0)
        say(line + f" ({smi})")
        if not ok or not close or not (nan_ok or torch.isfinite(out).all()):
            fail(f"engine {arm}: the counts or the K4 output are off")
        del eng
    return launches


# the serve phase's arms (scripts/serving_bench.py's MODES) and fp16, the
# default KVCachePolicy()
SERVE_MODES = ("int4-write-inject", "int4-hamming84", "int12-golay", "fp16")
SERVE_REQUESTS, SERVE_BATCH = 12, 8


def serve_phase(torch, params, device, smi):
    """ContinuousBatchingServer on bench-0.9b (random bf16 weights from seed
    0): max_batch 8, block 128, max_seq_len 1280, prefill_bucket 128, BER
    1e-2, ECC statistics on (the server's default). 12 greedy requests, prompt
    lengths 256-1024 and 32-64 new tokens drawn from a seed, in each arm of
    SERVE_MODES, after a warm-up request. Checks: every request finishes
    with its length; the write+attend kernels launched decode steps x 24
    times; the arms that count have counted. Prints generated tokens/s over
    the wall clock, the median decode-step ms with all slots busy and the
    admission seconds. Returns the kernels' launches by branch."""
    import statistics

    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request

    class TimedServer(ContinuousBatchingServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.admission_s, self.decode = [], []  # decode: (active slots, s)

        def _run_prefill(self, *a):
            t = time.perf_counter()
            logits = super()._run_prefill(*a)
            torch.cuda.synchronize()
            self.admission_s.append(time.perf_counter() - t)
            return logits

        def _run_decode(self, *a):
            t = time.perf_counter()
            logits = super()._run_decode(*a)  # ends in a host read of the counts
            torch.cuda.synchronize()
            self.decode.append((self.num_active, time.perf_counter() - t))
            return logits

    g = torch.Generator().manual_seed(0)
    lens = torch.randint(256, 1025, (SERVE_REQUESTS,), generator=g).tolist()
    news = torch.randint(32, 65, (SERVE_REQUESTS,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy() for n in lens]
    launches = [dict.fromkeys(write_attend.launches_by, 0),
                dict.fromkeys(write_decode_attend.launches_by, 0)]
    for mode in SERVE_MODES:
        server = TimedServer(params, cfg, policy_for_mode(mode, ber=BER, seed=42),
                             max_batch=SERVE_BATCH, max_seq_len=1280, block_size=128,
                             prefill_bucket=128, device=device)
        server.add_request(Request(10_000, prompts[0][:128], max_new_tokens=2))  # warm-up
        server.run()
        server.finished.clear()
        server.admission_s.clear()
        server.decode.clear()
        base = server.ecc_stats
        reset_counts(write_attend, write_decode_attend)
        for rid, (p, n) in enumerate(zip(prompts, news)):
            server.add_request(Request(rid, p, max_new_tokens=n))
        t = time.perf_counter()
        outs = server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        steps = len(server.decode)
        got = write_attend.launches + write_decode_attend.launches
        for w, acc in zip((write_attend, write_decode_attend), launches):
            for k, v in w.launches_by.items():
                acc[k] += v
        by_id = {o.request_id: o for o in outs}
        if sorted(by_id) != list(range(SERVE_REQUESTS)) or any(
                len(by_id[i].token_ids) != news[i] for i in by_id):
            fail(f"serve {mode}: not every request finished with its length")
        if got != steps * cfg.num_layers:
            fail(f"serve {mode}: the write+attend kernels launched {got} times for {steps} "
                 f"decode steps x {cfg.num_layers} layers")
        counts = {k: v - base[k] for k, v in server.ecc_stats.items()}
        if mode in ("int4-hamming84", "int12-golay") and not counts["errors_corrected"] > 0:
            fail(f"serve {mode}: no correction counted at BER {BER}")
        if mode == "fp16" and any(counts.values()):
            fail(f"serve {mode}: a float read counted ECC errors {counts}")
        tokens = sum(len(o.token_ids) for o in outs)
        full = [dt for a, dt in server.decode if a == SERVE_BATCH] or [0.0]
        say(f"  serve {mode}: {SERVE_REQUESTS} requests (prompts {min(lens)}-{max(lens)}, "
            f"{sum(news)} new tokens) in {wall:.3f} s: {tokens / wall:.1f} generated tokens/s; "
            f"{steps} decode steps, the kernels launched {got} = {steps} x {cfg.num_layers}; "
            f"decode step with all {SERVE_BATCH} slots busy: median "
            f"{1e3 * statistics.median(full):.3f} ms over {len(full)} steps; admission: median "
            f"{statistics.median(server.admission_s):.3f} s, total "
            f"{sum(server.admission_s):.3f} s over {len(server.admission_s)}; ECC counts "
            f"{counts} (BER {BER}; {smi})")
        del server
    return launches


def serve_ber0_check(torch, device):
    """At BER 0 on the card, three requests admitted at different times
    return exactly the tokens generate() gives each prompt alone
    (int4-hamming84, bench-0.9b in float32 weights from seed 0, so that
    batch 8 against batch 1 only reorders float32 sums; prompts of whole
    buckets, 16 new tokens)."""
    import dataclasses

    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.models.runtime import generate
    from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request

    cfg = dataclasses.replace(BENCH_0_9B, dtype="float32")
    params = init_params(cfg, seed=0, device=device)
    pol = policy_for_mode("int4-hamming84", ber=0.0, seed=42)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g) for n in (384, 128, 256)]
    want = [generate(params, p[None].to(device), cfg, pol, max_new_tokens=16,
                     device=device)[0, len(p):].tolist() for p in prompts]
    server = ContinuousBatchingServer(params, cfg, pol, max_batch=SERVE_BATCH, max_seq_len=1280,
                                      block_size=128, prefill_bucket=128, device=device)
    server.add_request(Request(0, prompts[0].numpy(), max_new_tokens=16))
    server.add_request(Request(1, prompts[1].numpy(), max_new_tokens=16))
    for _ in range(3):
        server.step()
    server.add_request(Request(2, prompts[2].numpy(), max_new_tokens=16))
    got = {o.request_id: o.token_ids for o in server.run()}
    same = all(got[i] == want[i] for i in range(3))
    say(f"  serve BER 0: 3 staggered requests against generate() of each alone: tokens "
        f"{'identical' if same else 'DIFFER'}")
    if not same:
        fail(f"serve BER 0: {got} != {want}")


def output_tolerance(ref):
    """Per element of the [B, Hq, D] output: 2^-7 |ref| is one bf16 ulp of
    the element (the last rounding, which both sides make), and 2^-8 of the
    largest |ref| of its (sequence, head) row allows one softmax weight
    p * v_scale to round to a neighbouring bf16 value after an fp32 ulp of
    difference in exp or in the summation order. Kernel and plain version
    take the softmax online page by page alike, so neither term is needed
    in practice; a row scale rather than the batch's largest value keeps a
    token dropped or added at any context length (ctx 1 to 1152) beyond the
    tolerance."""
    r = ref.float().abs()
    return 2.0 ** -7 * r + 2.0 ** -8 * r.amax(dim=-1, keepdim=True)


TINY_MODES = MODES + ("int12-golay/scrub=False", "int4-hamming/scrub=False",
                      "int4-write-inject/scrub=False", "int12-golay/stats", "int4-hamming/stats",
                      "int4-hamming84/stats", "int4-hamming84-interp/stats", "int4/stats")


def tiny_agreement(torch, device):
    """tiny-llama prefill + 6 decode steps at BER 1e-2 in every mode (the
    arms, the float arms fp16 and fp8, the unscrubbed reads,
    collect_ecc_stats), on the card (kernels)
    and on the CPU (plain versions), same weights, write masks, prefill read
    flips and read seeds: logits within 1e-2, the same greedy tokens and the
    same ECC counts."""
    import dataclasses
    from qkv_ecc_tpu_torch.codecs.fault_injection import flip_mask
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import (
        hoisted_logical_masks, hoisted_write_deltas, policy_for_mode, write_inject)
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.models.runtime import (
        _use_scrub, decode_step, init_generation_state, prefill, write_mask_shape)

    params_cpu = init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    for mode in TINY_MODES:
        base = mode.split("/")[0]
        stats = mode.endswith("/stats")
        pol = policy_for_mode(base, ber=BER)
        if mode.endswith("/scrub=False"):
            pol = dataclasses.replace(pol, scrub=False)
        read = pol.inject_at == "read"
        pol0 = pol if read else policy_for_mode(base, ber=0.0)
        gen = torch.Generator().manual_seed(2)
        hoist = hoisted_write_deltas if _use_scrub(pol) and not stats else hoisted_logical_masks
        masks = [hoist(pol, cfg.num_layers, write_mask_shape(pol, 2, cfg), generator=gen)
                 if write_inject(pol) else None for _ in range(6)]
        read_masks = flip_mask((cfg.num_layers, 2, 2, 21, cfg.num_kv_heads, cfg.head_dim), BER,
                               4, gen) if read else None
        seeds = torch.randint(-2 ** 31, 2 ** 31, (6,), generator=gen).tolist()
        runs = {}
        for dev in ("cpu", device):
            params = {k: v.to(dev) for k, v in params_cpu.items() if k != "layers"}
            params["layers"] = [{k: v.to(dev) for k, v in lp.items()} for lp in params_cpu["layers"]]
            state, bt, _ = init_generation_state(cfg, pol, 2, 32, 16, device=dev)
            logits, state = prefill(params, ids.to(dev), state, bt, cfg, pol0,
                                    read_masks=None if read_masks is None else read_masks.to(dev))
            seq, toks = [logits.cpu()], []
            for m, seed in zip(masks, seeds):
                toks.append(torch.argmax(logits, -1).cpu())
                logits, state = decode_step(params, torch.argmax(logits, -1), state, bt, cfg, pol,
                                            hoisted_masks=None if m is None else m.to(dev),
                                            collect_ecc_stats=stats,
                                            read_inject_seed=seed if read else None)
                seq.append(logits.cpu())
            counts = [state[n].cpu() for n in ("ecc_corrected", "ecc_detected")] if stats else []
            runs[str(dev)] = (torch.stack(seq), torch.stack(toks), counts)
        (lc, tc, cc), (lg, tg, cg) = runs["cpu"], runs[str(device)]
        # fp8's injected bytes may be NaN (0x7f, 0xff): NaN logits must
        # stand at the same places on both
        nan = torch.isnan(lc)
        same_nan = torch.equal(nan, torch.isnan(lg))
        err = (torch.where(nan, 0.0, lc) - torch.where(nan, 0.0, lg)).abs().max().item()
        same_counts = all(torch.equal(x, y) for x, y in zip(cc, cg))
        say(f"  tiny-llama {mode}: max |logits card - logits cpu| = {err:.3e} (tolerance 1e-2); "
            f"NaN logits {int(nan.sum())} on the cpu, at the same places on the card: {same_nan}; "
            f"tokens {'identical' if torch.equal(tc, tg) else 'DIFFER'}"
            + (f"; ECC counts card {[c.tolist() for c in cg]}, cpu {[c.tolist() for c in cc]}"
               if stats else ""))
        if not err <= 1e-2 or not same_nan or not torch.equal(tc, tg) or not same_counts:
            fail(f"tiny-llama {mode}: the card disagrees with the CPU")


def trace_decode(torch, params, ids, gen, device, smi):
    """Device busy share of the decode step: torch.profiler over 4 steps of
    each arm, kernel time summed over the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.runtime import decode_loop, init_generation_state, prefill

    for mode in MODES:
        pol = policy_for_mode(mode, ber=BER, seed=42)
        state, bt, _ = init_generation_state(cfg, pol, BATCH, PROMPT + 8, device=device)
        logits, state = prefill(params, ids, state, bt, cfg, pol, gen)
        logits, state, _ = decode_loop(params, logits, state, bt, cfg, pol, gen, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            decode_loop(params, logits, state, bt, cfg, pol, gen, 4)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        attend = {name: sum(e.time_range.elapsed_us() for e in kernels if name in e.name)
                  for name in ("write_attend_kernel", "decode_attend_kernel",
                               "float_attend_kernel")}
        if not kernels or busy <= 0:
            say(f"  {mode}: device time not measured (the profiler recorded no device events)")
            continue
        say(f"  {mode} (profiled, 4 steps): {wall_us / 4e3:.3f} ms/step wall, "
            f"{len(kernels) / 4:.0f} device kernels/step, device busy {busy / 4e3:.3f} ms/step "
            f"({100 * busy / wall_us:.1f}% of wall, idle {100 - 100 * busy / wall_us:.1f}%), "
            f"write_attend {attend['write_attend_kernel'] / 4e3:.3f} ms/step, decode_attend "
            f"{attend['decode_attend_kernel'] / 4e3:.3f} ms/step, float_attend "
            f"{attend['float_attend_kernel'] / 4e3:.3f} ms/step ({smi})")


def device_ms(torch, fn, n, layers, wrapper):
    """Device time per call of fn over n calls run back to back on the card,
    cycling the layers, after 3 warm-up calls. The stream is first held by a
    sleep kernel while the host queues all n calls between two CUDA events,
    so the events time the device alone, without the host's time per call,
    which is longer than the kernel's (timed includes it). If the sleep ended
    before the last call was queued, the run is repeated with a longer one.
    The wrapper's counter (None: a library call, not counted) must show
    exactly n launches."""
    for i in range(3):
        fn(i % layers)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (1 << 28, 1 << 30):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        before = wrapper.launches if wrapper else 0
        for i in range(n):
            fn(i % layers)
        end.record()
        queued_in_time = not start.query()  # the device was still asleep
        torch.cuda.synchronize()
        launched = wrapper.launches - before if wrapper else n
        if launched != n:
            fail(f"{n} timed calls launched their kernel {launched} times")
        if queued_in_time:
            return start.elapsed_time(end) / n
    fail(f"the host did not queue {n} calls within a sleep of {cycles} cycles")


def timed(torch, fn, n, layers):
    """ms per call over n back-to-back calls after 3 warm-up calls, by CUDA
    events, cycling the layers (24 layers of cache, 226-453 MB, keep each
    call's pages out of the 50 MB L2, as in the decode step)."""
    for i in range(3):
        fn(i % layers)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n):
        fn(i % layers)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def reset_counts(*wrappers):
    for w in wrappers:
        w.launches = 0
        for k in w.launches_by:
            w.launches_by[k] = 0


def check_launches(path, expected):
    """Each branch's launches in a path against layers x steps x rounds x
    the arms that call it."""
    for name, (got, want, how) in expected.items():
        say(f"  {path}: {name} launches {got} (expected {how} = {want})")
        if got != want:
            fail(f"{path}: the decode path did not go through the {name} kernel on every "
                 "layer and step of its arms")


def bound(nbytes, flops, int_ops):
    """(least ms, "bytes" or "operations", bytes ms, operations ms): bytes at
    3.35 TB/s, fp32 and 32-bit integer operations at 67 T/s."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * (flops + int_ops) / PEAK_FP32_FLOPS
    return max((bytes_ms, "bytes"), (ops_ms, "operations")) + (bytes_ms, ops_ms)


def main():
    import dataclasses

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    try:
        import qkv_ecc_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is missing ({e}): run from the repository root")
    from qkv_ecc_tpu_torch.kernels import _build
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        attend_plain, paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_attend_plain, write_decode_attend, write_decode_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.models.runtime import decode_loop, init_generation_state, prefill

    device = torch.device("cuda:0")
    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = smi_name_power()
        say(f"  torch {torch.__version__} cuda {torch.version.cuda}; {kind}; "
            f"{count} device(s); nvidia-smi: {smi}")

    with Phase("build"):
        t = time.perf_counter()
        for b in _build.build_all():
            say(f"  {b.name}: built in {b.seconds:.2f} s -> {b.path.name}")
            for line in b.log.splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    say(f"    {line.strip()}")
        say(f"  all sources, in parallel: {time.perf_counter() - t:.2f} s")

    gen = torch.Generator(device=device).manual_seed(0)
    with Phase("kernel check"):
        max_err_float = float_kernel_check(torch, gen, device)
        max_err = kernel_check(torch, gen, device)
        max_err_decode = decode_kernel_check(torch, gen, device)
        max_err_inject = read_inject_check(torch, gen, device)
        max_err_k4 = attend_check(torch, gen, device)

    with Phase("tiny agreement"):
        tiny_agreement(torch, device)

    per_arm = cfg.num_layers * STEPS * ROUNDS
    with Phase("slice"):
        params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
        ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device)
        for mode in MODES:  # warm-up of every arm, before the counted run
            pol = policy_for_mode(mode, ber=BER, seed=42)
            st, bt, _ = init_generation_state(cfg, pol, BATCH, 256, device=device)
            lg, st = prefill(params, ids[:, :128], st, bt, cfg, pol, gen)
            decode_loop(params, lg, st, bt, cfg, pol, gen, 2)
        torch.cuda.synchronize()
        reset_counts(write_attend, write_decode_attend)
        runs = {mode: [] for mode in MODES}
        for rnd in range(ROUNDS):
            for mode in MODES:
                pol = policy_for_mode(mode, ber=BER, seed=42)
                g = torch.Generator(device=device).manual_seed(42 + rnd)
                state, bt, _ = init_generation_state(cfg, pol, BATCH, PROMPT + STEPS, device=device)
                t = time.perf_counter()
                logits, state = prefill(params, ids, state, bt, cfg, pol, g)
                torch.cuda.synchronize()
                t_prefill = time.perf_counter() - t
                t = time.perf_counter()
                logits, state, toks = decode_loop(params, logits, state, bt, cfg, pol, g, STEPS)
                torch.cuda.synchronize()
                t_decode = time.perf_counter() - t
                # fp8 at BER 1e-2 stores NaN wherever a flip makes a byte 0x7f or
                # 0xff, and NaN V values reach the logits, as in the JAX package
                finite_rows = int(torch.isfinite(logits).all(dim=-1).sum())
                if logits.shape != (BATCH, cfg.vocab_size) or (finite_rows < BATCH
                                                               and mode != "fp8"):
                    fail(f"{mode}: logits not finite or of the wrong shape")
                if toks.shape != (STEPS, BATCH) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                    fail(f"{mode}: tokens out of range")
                if not torch.equal(state["context_len"].cpu(), torch.full((BATCH,), PROMPT + STEPS, dtype=torch.int32)):
                    fail(f"{mode}: context lengths did not advance")
                last = rnd + 1 == ROUNDS  # the kernel timing reads the last round's caches
                runs[mode].append(dict(state=state if last else None, bt=bt, prefill_s=t_prefill,
                                       ms_step=1e3 * t_decode / STEPS,
                                       tok_s=BATCH * STEPS / t_decode, finite_rows=finite_rows))
                del state
        slice_launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
        how = f"{cfg.num_layers} layers x {STEPS} steps x {ROUNDS} rounds x"
        check_launches("slice", {
            "write_attend read": (slice_launches[0]["read"], per_arm * 4,
                                  f"{how} 4 arms (the scrubbed ones)"),
            "write_attend read-inject": (slice_launches[0]["read-inject"], per_arm,
                                         f"{how} 1 arm (int4)"),
            "write_attend fp16 (K2f)": (slice_launches[0]["fp16"], per_arm, f"{how} 1 arm (fp16)"),
            "write_attend fp8 (K2f)": (slice_launches[0]["fp8"], per_arm, f"{how} 1 arm (fp8)"),
            "decode_attend hamming84-interp": (slice_launches[1]["hamming84-interp"], per_arm,
                                               f"{how} 1 arm (int4-hamming84-interp)"),
            "decode_attend other branches": (write_decode_attend.launches
                                             - slice_launches[1]["hamming84-interp"], 0, "none"),
        })
        for mode, rs in runs.items():
            for rnd, r in enumerate(rs):
                base = runs[BASELINE][rnd]
                say(f"  round {rnd} {mode}: prefill {r['prefill_s']:.3f} s, decode "
                    f"{r['ms_step']:.3f} ms/step, {r['tok_s']:.1f} tokens/s, "
                    f"{r['tok_s'] / base['tok_s']:.4f} x int4-write-inject's tokens/s "
                    f"(batch {BATCH}, ctx {PROMPT}+{STEPS}, BER {BER}; last logits finite in "
                    f"{r['finite_rows']} of {BATCH} rows; {smi})")
        for mode, rs in runs.items():
            mean_tok = sum(r["tok_s"] for r in rs) / len(rs)
            base_tok = sum(r["tok_s"] for r in runs[BASELINE]) / ROUNDS
            say(f"  {mode}: mean over {ROUNDS} rounds "
                f"{sum(r['ms_step'] for r in rs) / len(rs):.3f} ms/step, {mean_tok:.1f} tokens/s, "
                f"ratio to int4-write-inject {mean_tok / base_tok:.4f} ({smi})")
        # a decode step reads every weight once except the embedding table
        # (one row per token): the step's least time on this card
        wbytes = sum(t.numel() * t.element_size() for n, t in params.items()
                     if n not in ("embed", "layers"))
        wbytes += sum(t.numel() * t.element_size() for lp in params["layers"] for t in lp.values())
        say(f"  weights read per decode step: {wbytes / 1e9:.3f} GB, "
            f"{1e3 * wbytes / PEAK_BYTES_PER_S:.3f} ms at 3.35 TB/s")

    with Phase("stats"):
        # decode_loop(collect_ecc_stats=True): scrub off, every read counts
        reset_counts(write_attend, write_decode_attend)
        stats_runs = {}
        for mode in STATS_MODES:
            pol = policy_for_mode(mode, ber=BER, seed=42)
            if pol.inject_at == "write":
                pol = dataclasses.replace(pol, scrub=False)
            g = torch.Generator(device=device).manual_seed(7)
            state, bt, _ = init_generation_state(cfg, pol, BATCH, PROMPT + STATS_STEPS,
                                                 device=device)
            logits, state = prefill(params, ids, state, bt, cfg, pol, g)
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, state, toks = decode_loop(params, logits, state, bt, cfg, pol, g, STATS_STEPS,
                                              collect_ecc_stats=True)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t) / STATS_STEPS
            if not torch.isfinite(logits).all():
                fail(f"stats {mode}: logits not finite")
            corr = int(state["ecc_corrected"].sum())
            det = int(state["ecc_detected"].sum())
            line = (f"  stats {mode}{'' if pol.inject_at == 'read' else ' scrub=False'}: "
                    f"{ms:.3f} ms/step over {STATS_STEPS} steps; summed over the batch: "
                    f"corrected {corr}, detected {det}")
            if pol.inject_at == "read":
                bits = sum(cfg.num_layers * 2 * BATCH * (PROMPT + s + 1) * cfg.num_kv_heads
                           * state["k_cache"].shape[3] * 32 for s in range(STATS_STEPS))
                ratio = corr / (BER * bits)
                line += (f" (flipped read bits; {bits} bits read, flipped / (BER x bits) "
                         f"= {ratio:.6f}, band 0.98-1.02)")
                ok = 0.98 <= ratio <= 1.02 and det == 0
            else:
                ok = corr > 0 and (pol.codec == "hamming74" or det > 0)
            say(line + f" ({smi})")
            if not ok:
                fail(f"stats {mode}: the counts are not what the errors in the cache make")
            stats_runs[mode] = dict(state=state, bt=bt, ms_step=ms, corrected=corr, detected=det)
        stats_launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
        per_stats_arm = cfg.num_layers * STATS_STEPS
        how = f"{cfg.num_layers} layers x {STATS_STEPS} steps x 1 arm"
        check_launches("stats", {
            f"write_attend {k}": (stats_launches[0][k], per_stats_arm if k == "read-inject" else 0,
                                  how + " (int4)" if k == "read-inject" else "none")
            for k in stats_launches[0]} | {
            f"decode_attend {k}": (v, per_stats_arm, how) for k, v in stats_launches[1].items()})

    with Phase("engine"):
        k4_launches = engine_phase(torch, gen, device, smi, ENGINE_STEPS)

    with Phase("serve"):
        serve_launches = serve_phase(torch, params, device, smi)
        serve_ber0_check(torch, device)

    with Phase("kernel timing"):
        group = cfg.num_heads // cfg.num_kv_heads
        q = torch.randn((BATCH, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=device).to(torch.bfloat16)
        names = ("k_cache", "v_cache", "k_scales", "v_scales")
        sm = cfg.head_dim ** -0.5
        sn = torch.ones((BATCH, cfg.num_kv_heads), dtype=torch.float32, device=device)
        timings = {}

        def time_kernel(key, label, call, plain, wrapper, state, bt, words_read, int_ops, row_w,
                        word_bytes=4, scale_bytes=4, library=None):
            """Device time (behind a sleep), back-to-back time, the plain
            version's time, the library call's (when one computes the same
            function) and the bound of one call on `state`'s caches; row_w
            words of a new row per (sequence, KV head) are written (0: a
            read, K4). A float cache reads values of word_bytes and no
            scales (scale_bytes 0)."""
            L = state["k_cache"].shape[0]
            ms = device_ms(torch, call, 240, L, wrapper)
            call_ms = timed(torch, call, 240, L)
            plain_ms = timed(torch, plain, 24, L)
            ms = min(ms, device_ms(torch, call, 240, L, wrapper))
            library_ms = None if library is None else device_ms(torch, library, 240, L, None)
            tokens = int(state["context_len"].sum())
            Hkv = state["k_cache"].shape[2]
            # least work of one call: read each live token's K and V words
            # and scales once, the query, block table and lengths; write the
            # new rows, scales and the output. Operations: QK and PV, one
            # multiply-add each per (token, KV head, group head, value), in
            # fp32, and the integer operations counted from the source
            nbytes = (tokens * Hkv * 2 * (words_read * word_bytes + scale_bytes)
                      + 2 * q.numel() * q.element_size()
                      + (2 * BATCH * Hkv * (row_w * word_bytes + scale_bytes) if row_w else 0)
                      + bt.numel() * 4 + BATCH * 4)
            flops = 2 * 2 * tokens * Hkv * group * cfg.head_dim
            ops = int_ops(tokens, Hkv)
            b_ms, b_by, bytes_ms, ops_ms = bound(nbytes, flops, ops)
            say(f"  {label} at ctx {tokens // BATCH}: {ms * 1e3:.2f} us/launch on the device "
                f"(CUDA events, calls queued behind a sleep; {call_ms * 1e3:.2f} us per "
                f"back-to-back call, host included); bound {b_ms * 1e3:.2f} us by {b_by} "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms * 1e3:.2f} us; "
                f"{flops / 1e6:.1f} MFLOP fp32 + {ops / 1e6:.1f} M int32 ops at 67 T/s = "
                f"{ops_ms * 1e3:.2f} us); share of bound {b_ms / ms:.3f}; plain version "
                f"{plain_ms * 1e3:.1f} us; library call: "
                + ("none" if library_ms is None else
                   f"{library_ms * 1e3:.2f} us (scaled_dot_product_attention, dense bf16 K/V)")
                + f" ({smi})")
            timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms)

        # K1 on the golay arm's cache (the column at ctx-1 is rewritten)
        state, bt = runs["int12-golay"][-1]["state"], runs["int12-golay"][-1]["bt"]
        Wd = state["k_cache"].shape[3]
        ctx = state["context_len"].clone()
        kn = torch.zeros((BATCH, cfg.num_kv_heads, Wd), dtype=torch.int32, device=device)
        time_kernel(
            "read", "write_attend (scrub-extract read)",
            lambda layer: write_attend(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                       layer, codec="golay", scrub=True),
            lambda layer: write_attend_plain(q, kn, kn, sn, sn, *(state[n] for n in names), bt,
                                             ctx, layer, sm_scale=sm),
            write_attend, state, bt, Wd, lambda tok, h: 0, Wd)

        # K2r on the stats phase's int4 cache, seed on the device
        state, bt = (stats_runs["int4"][k] for k in ("state", "bt"))
        ctx = state["context_len"].clone()
        seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen, device=device).to(torch.int32)
        time_kernel(
            "read-inject", f"write_attend int4 read-inject BER {BER}",
            lambda layer: write_attend(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                       layer, codec="int4", read_inject_ber=BER,
                                       read_inject_seed=seed),
            lambda layer: write_attend_plain(q, kn, kn, sn, sn, *(state[n] for n in names), bt,
                                             ctx, layer, sm_scale=sm,
                                             read_threshold=int(BER * 2 ** 32), read_seed=seed,
                                             pages_per_chunk=4),
            write_attend, state, bt, Wd, lambda tok, h: tok * h * 2 * Wd * INJECT_OPS_PER_WORD,
            Wd)

        # decode_attend: hamming84 on the interpolation arm's cache, hamming74
        # and golay on the stats phase's unscrubbed caches
        for key, codec, src, interp, per_row in (
                ("hamming84-interp", "hamming84", runs["int4-hamming84-interp"][-1], True,
                 lambda w, p: w * (DECODE_OPS_PER_WORD + INTERP_OPS_PER_WORD)),
                ("hamming84", "hamming84", runs["int4-hamming84-interp"][-1], False,
                 lambda w, p: w * DECODE_OPS_PER_WORD),
                ("hamming74", "hamming74", stats_runs["int4-hamming"], False,
                 lambda w, p: w * H74_OPS_PER_WORD),
                ("golay", "golay", stats_runs["int12-golay"], False,
                 lambda w, p: 4 * (w + p) // 3 * GOLAY_OPS_PER_CODEWORD)):
            state, bt = src["state"], src["bt"]
            ctx = state["context_len"].clone()
            Pw = state["k_parity"].shape[3]
            rn = torch.zeros((BATCH, cfg.num_kv_heads, Wd + Pw), dtype=torch.int32, device=device)

            def call_d(layer, state=state, bt=bt, ctx=ctx, rn=rn, codec=codec, interp=interp):
                return write_attend(q, rn, rn, sn, sn, *(state[n] for n in names), bt, ctx,
                                    layer, state["k_parity"], state["v_parity"], codec=codec,
                                    use_interpolation=interp)

            def plain_d(layer, state=state, bt=bt, ctx=ctx, rn=rn, codec=codec, interp=interp):
                return write_decode_attend_plain(
                    q, rn, rn, sn, sn, *(state[n] for n in names), bt, ctx, layer,
                    state["k_parity"], state["v_parity"], codec=codec, sm_scale=sm,
                    interpolate=interp, pages_per_chunk=4)

            time_kernel(key, f"decode_attend {key}", call_d, plain_d, write_decode_attend, state,
                        bt, Wd + Pw, lambda tok, h, f=per_row, p=Pw: tok * h * 2 * f(Wd, p), Wd + Pw)

        # K4, the read alone, on the same caches: each branch as above
        for key, codec, src, kw, per_row in (
                ("read", "golay", runs["int12-golay"][-1], dict(scrub=True), lambda w, p: 0),
                ("read-inject", "int4", stats_runs["int4"], dict(read_inject_ber=BER),
                 lambda w, p: w * INJECT_OPS_PER_WORD),
                ("hamming84-interp", "hamming84", runs["int4-hamming84-interp"][-1],
                 dict(use_interpolation=True),
                 lambda w, p: w * (DECODE_OPS_PER_WORD + INTERP_OPS_PER_WORD)),
                ("hamming84", "hamming84", runs["int4-hamming84-interp"][-1], {},
                 lambda w, p: w * DECODE_OPS_PER_WORD),
                ("hamming74", "hamming74", stats_runs["int4-hamming"], {},
                 lambda w, p: w * H74_OPS_PER_WORD),
                ("golay", "golay", stats_runs["int12-golay"], {},
                 lambda w, p: 4 * (w + p) // 3 * GOLAY_OPS_PER_CODEWORD)):
            state, bt = src["state"], src["bt"]
            ctx = state["context_len"].clone()
            extract = codec == "int4" or kw.get("scrub")
            parity = () if extract else (state["k_parity"], state["v_parity"])
            Pw = 0 if extract else state["k_parity"].shape[3]
            if "read_inject_ber" in kw:
                kw = dict(kw, read_inject_seed=seed)

            def call_k4(layer, state=state, bt=bt, ctx=ctx, parity=parity, codec=codec, kw=kw):
                return paged_attention_ecc(q, *(state[n] for n in names), bt, ctx, layer, *parity,
                                           codec=codec, **kw)

            def plain_k4(layer, state=state, bt=bt, ctx=ctx, parity=parity, codec=codec, kw=kw,
                         extract=extract):
                return attend_plain(
                    q, *(state[n] for n in names), bt, ctx, layer, *parity,
                    codec="int4" if extract else codec, sm_scale=sm,
                    num_pages=bt.shape[1], pages_per_chunk=4,
                    read_threshold=int(BER * 2 ** 32) if "read_inject_ber" in kw else None,
                    read_seed=kw.get("read_inject_seed", 0),
                    interpolate=kw.get("use_interpolation", False))

            time_kernel("k4-" + key, f"paged_attention_ecc {key} (K4)", call_k4, plain_k4,
                        paged_attention_ecc, state, bt, Wd + Pw,
                        lambda tok, h, f=per_row, p=Pw: tok * h * 2 * f(Wd, p), 0)

        # K2f on the float arms' caches of the slice, the write+attend and
        # the read; fp16's yardstick: scaled_dot_product_attention over the
        # same context stored dense ([B, Hkv, ctx, D] bf16, GQA), not paged
        from qkv_ecc_tpu_torch.kernels.paged_attention import gather_pages

        for codec in ("fp16", "fp8"):
            state, bt = runs[codec][-1]["state"], runs[codec][-1]["bt"]
            ctx = state["context_len"].clone()
            D = cfg.head_dim
            kn = torch.zeros((BATCH, cfg.num_kv_heads, D), dtype=state["k_cache"].dtype,
                             device=device)
            elem = state["k_cache"].element_size()
            library = None
            if codec == "fp16":
                T = int(ctx.max())
                dense = [[gather_pages(state[n], bt, layer, bt.shape[1])[:, :T].transpose(1, 2)
                          .contiguous() for n in ("k_cache", "v_cache")]
                         for layer in range(cfg.num_layers)]
                q4 = q[:, :, None]

                def library(layer, dense=dense, q4=q4):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q4, *dense[layer], enable_gqa=True)

            def call_w(layer, state=state, bt=bt, ctx=ctx, kn=kn, codec=codec):
                return write_attend(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                    layer, codec=codec)

            def plain_w(layer, state=state, bt=bt, ctx=ctx, kn=kn, codec=codec):
                return write_attend_plain(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                          layer, sm_scale=sm, codec=codec, pages_per_chunk=4)

            def call_r(layer, state=state, bt=bt, ctx=ctx, codec=codec):
                return paged_attention_ecc(q, *(state[n] for n in names), bt, ctx, layer,
                                           codec=codec)

            def plain_r(layer, state=state, bt=bt, ctx=ctx, codec=codec):
                return attend_plain(q, *(state[n] for n in names), bt, ctx, layer, codec=codec,
                                    sm_scale=sm, num_pages=bt.shape[1], pages_per_chunk=4)

            no_ops = lambda tok, h: 0  # noqa: E731
            time_kernel(codec, f"float_attend {codec} write+attend (K2f)", call_w, plain_w,
                        write_attend, state, bt, D, no_ops, D, word_bytes=elem, scale_bytes=0,
                        library=library)
            time_kernel("k4-" + codec, f"paged_attention_ecc {codec} (K2f read)", call_r,
                        plain_r, paged_attention_ecc, state, bt, D, no_ops, 0, word_bytes=elem,
                        scale_bytes=0, library=library)
            del library

    with Phase("trace"):
        trace_decode(torch, params, ids, gen, device, smi)

    def entry(name, key, source, replaces, launches, err):
        return dict(name=name, route="cuda", source=f"qkv_ecc_tpu_torch/csrc/{source}",
                    replaces=f"qkv_ecc_tpu/kernels/{replaces}", launches=launches,
                    max_abs_err=err, **timings[key])

    # the write+attend kernels' launches over the decode slice, the stats
    # phase and the serve phase; K4's over the engine phase
    sl, st, sv, k4 = slice_launches, stats_launches, serve_launches, k4_launches

    def wa(i, k):
        return sl[i][k] + st[i][k] + sv[i][k]

    table = {"kernels": [
        entry("write_attend", "read", "write_attend.cu", "paged_attention.py:1056",
              wa(0, "read"), max_err),
        entry("write_attend read-inject (K2r)", "read-inject", "write_attend.cu",
              "paged_attention.py:352", wa(0, "read-inject"), max_err_inject),
        entry("decode_attend", "hamming84-interp", "decode_attend.cu", "paged_attention.py:677",
              wa(1, "hamming84-interp"), max_err_decode["hamming84-interp"]),
        entry("decode_attend hamming84 (K2)", "hamming84", "decode_attend.cu",
              "paged_attention.py:135", wa(1, "hamming84"), max_err_decode["hamming84"]),
        entry("decode_attend hamming74 (K2)", "hamming74", "decode_attend.cu",
              "paged_attention.py:143", wa(1, "hamming74"), max_err_decode["hamming74"]),
        entry("decode_attend golay (K2)", "golay", "decode_attend.cu", "paged_attention.py:154",
              wa(1, "golay"), max_err_decode["golay"]),
    ] + [
        entry(f"paged_attention_ecc {k} (K4)", "k4-" + k,
              "write_attend.cu" if k in ("read", "read-inject") else "decode_attend.cu",
              "paged_attention.py:828", k4[k],
              max(max_err_k4[k], max_err_k4["extract"]) if k == "read" else max_err_k4[k])
        for k in ("read", "read-inject", "hamming84", "hamming84-interp", "hamming74", "golay")
    ] + [
        entry(f"float_attend {c} write+attend (K2f)", c, "write_attend.cu",
              "paged_attention.py:300", wa(0, c), max_err_float[(c, "write")])
        for c in ("fp16", "fp8")
    ] + [
        entry(f"paged_attention_ecc {c} (K2f read)", "k4-" + c, "write_attend.cu",
              "paged_attention.py:300", k4[c], max_err_float[(c, "read")])
        for c in ("fp16", "fp8")
    ]}
    say(f"total {time.perf_counter() - T0:.1f} s")
    say(json.dumps(table))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
