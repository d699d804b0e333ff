#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qkv_ecc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one process per source,
all at once), holds every kernel branch against its plain PyTorch version at
the bench-0.9b shapes (the scrubbed extract read, int4's read-time
injection, the hamming84 / hamming74 / golay correcting reads with and
without ECC statistics, the -1 page clamp, precision "highest"), checks the
card against the CPU on tiny-llama in every mode, then drives bench-0.9b
(random bf16 weights from a seed, batch 8, prompt 1024) through the port's
entry points on two paths: the decode slice - 32 greedy steps at BER 1e-2
in the five arms of the JAX bench.py (int12-golay, int4-hamming84,
int4-hamming, int4-hamming84-interp, int4-write-inject) and the unprotected
read-inject arm int4, round-robin over two rounds - and the stats phase,
decode_loop(collect_ecc_stats=True) for 8 steps in int4, int12-golay,
int4-hamming, int4-hamming84 and int4-hamming84-interp (the protected ones
without scrub), whose counts must show corrections, detections and int4's
flip rate. Each path checks that every kernel branch it calls was launched
exactly as often as it calls it. Then it times the kernels and traces the
decode step of each arm. Every phase prints one line with its seconds; any
failure exits non-zero. Without a CUDA device it fails.

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
ROUNDS = 2
# bench.py's arms, in its order, then the unprotected read-inject arm; the
# fifth is the baseline of the ratios
MODES = ("int12-golay", "int4-hamming84", "int4-hamming", "int4-hamming84-interp",
         "int4-write-inject", "int4")
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
    arms, the unscrubbed reads, collect_ecc_stats), on the card (kernels)
    and on the CPU (plain versions), same weights, write masks, prefill read
    flips and read seeds: logits within 1e-2, the same greedy tokens and the
    same ECC counts."""
    import dataclasses
    from qkv_ecc_tpu_torch.codecs.fault_injection import flip_mask
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import (
        hoisted_logical_masks, hoisted_write_deltas, policy_for_mode)
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
                 for _ in range(6)]
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
                                            hoisted_masks=m.to(dev), collect_ecc_stats=stats,
                                            read_inject_seed=seed if read else None)
                seq.append(logits.cpu())
            counts = [state[n].cpu() for n in ("ecc_corrected", "ecc_detected")] if stats else []
            runs[str(dev)] = (torch.stack(seq), torch.stack(toks), counts)
        (lc, tc, cc), (lg, tg, cg) = runs["cpu"], runs[str(device)]
        err = (lc - lg).abs().max().item()
        same_counts = all(torch.equal(x, y) for x, y in zip(cc, cg))
        say(f"  tiny-llama {mode}: max |logits card - logits cpu| = {err:.3e} (tolerance 1e-2); "
            f"tokens {'identical' if torch.equal(tc, tg) else 'DIFFER'}"
            + (f"; ECC counts card {[c.tolist() for c in cg]}, cpu {[c.tolist() for c in cc]}"
               if stats else ""))
        if not err <= 1e-2 or not torch.equal(tc, tg) or not same_counts:
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
                  for name in ("write_attend_kernel", "decode_attend_kernel")}
        if not kernels or busy <= 0:
            say(f"  {mode}: device time not measured (the profiler recorded no device events)")
            continue
        say(f"  {mode} (profiled, 4 steps): {wall_us / 4e3:.3f} ms/step wall, "
            f"{len(kernels) / 4:.0f} device kernels/step, device busy {busy / 4e3:.3f} ms/step "
            f"({100 * busy / wall_us:.1f}% of wall, idle {100 - 100 * busy / wall_us:.1f}%), "
            f"write_attend {attend['write_attend_kernel'] / 4e3:.3f} ms/step, decode_attend "
            f"{attend['decode_attend_kernel'] / 4e3:.3f} ms/step ({smi})")


def device_ms(torch, fn, n, layers, wrapper):
    """Device time per call of fn over n calls run back to back on the card,
    cycling the layers, after 3 warm-up calls. The stream is first held by a
    sleep kernel while the host queues all n calls between two CUDA events,
    so the events time the device alone, without the host's time per call,
    which is longer than the kernel's (timed includes it). If the sleep ended
    before the last call was queued, the run is repeated with a longer one.
    The wrapper's counter must show exactly n launches."""
    for i in range(3):
        fn(i % layers)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (1 << 28, 1 << 30):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        before = wrapper.launches
        for i in range(n):
            fn(i % layers)
        end.record()
        queued_in_time = not start.query()  # the device was still asleep
        torch.cuda.synchronize()
        launched = wrapper.launches - before
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
        paged_attention_ecc_write_attend as write_attend, write_attend_plain,
        write_decode_attend, write_decode_attend_plain)
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
        max_err = kernel_check(torch, gen, device)
        max_err_decode = decode_kernel_check(torch, gen, device)
        max_err_inject = read_inject_check(torch, gen, device)

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
                if logits.shape != (BATCH, cfg.vocab_size) or not torch.isfinite(logits).all():
                    fail(f"{mode}: logits not finite or of the wrong shape")
                if toks.shape != (STEPS, BATCH) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
                    fail(f"{mode}: tokens out of range")
                if not torch.equal(state["context_len"].cpu(), torch.full((BATCH,), PROMPT + STEPS, dtype=torch.int32)):
                    fail(f"{mode}: context lengths did not advance")
                last = rnd + 1 == ROUNDS  # the kernel timing reads the last round's caches
                runs[mode].append(dict(state=state if last else None, bt=bt, prefill_s=t_prefill,
                                       ms_step=1e3 * t_decode / STEPS,
                                       tok_s=BATCH * STEPS / t_decode))
                del state
        slice_launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
        how = f"{cfg.num_layers} layers x {STEPS} steps x {ROUNDS} rounds x"
        check_launches("slice", {
            "write_attend read": (slice_launches[0]["read"], per_arm * 4,
                                  f"{how} 4 arms (the scrubbed ones)"),
            "write_attend read-inject": (slice_launches[0]["read-inject"], per_arm,
                                         f"{how} 1 arm (int4)"),
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
                    f"(batch {BATCH}, ctx {PROMPT}+{STEPS}, BER {BER}; {smi})")
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

    with Phase("kernel timing"):
        group = cfg.num_heads // cfg.num_kv_heads
        q = torch.randn((BATCH, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=device).to(torch.bfloat16)
        names = ("k_cache", "v_cache", "k_scales", "v_scales")
        sm = cfg.head_dim ** -0.5
        sn = torch.ones((BATCH, cfg.num_kv_heads), dtype=torch.float32, device=device)
        timings = {}

        def time_kernel(key, label, call, plain, wrapper, state, bt, words_read, int_ops, row_w):
            """Device time (behind a sleep), back-to-back time, the plain
            version's time and the bound of one call on `state`'s caches."""
            L = state["k_cache"].shape[0]
            ms = device_ms(torch, call, 240, L, wrapper)
            call_ms = timed(torch, call, 240, L)
            plain_ms = timed(torch, plain, 24, L)
            ms = min(ms, device_ms(torch, call, 240, L, wrapper))
            tokens = int(state["context_len"].sum())
            Hkv = state["k_cache"].shape[2]
            # least work of one call: read each live token's K and V words
            # and scales once, the query, block table and lengths; write the
            # new rows, scales and the output. Operations: QK and PV, one
            # multiply-add each per (token, KV head, group head, value), in
            # fp32, and the integer operations counted from the source
            nbytes = (tokens * Hkv * (2 * words_read * 4 + 2 * 4) + 2 * q.numel() * q.element_size()
                      + 2 * BATCH * Hkv * (row_w * 4 + 4) + bt.numel() * 4 + BATCH * 4)
            flops = 2 * 2 * tokens * Hkv * group * cfg.head_dim
            ops = int_ops(tokens, Hkv)
            b_ms, b_by, bytes_ms, ops_ms = bound(nbytes, flops, ops)
            say(f"  {label} at ctx {tokens // BATCH}: {ms * 1e3:.2f} us/launch on the device "
                f"(CUDA events, calls queued behind a sleep; {call_ms * 1e3:.2f} us per "
                f"back-to-back call, host included); bound {b_ms * 1e3:.2f} us by {b_by} "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms * 1e3:.2f} us; "
                f"{flops / 1e6:.1f} MFLOP fp32 + {ops / 1e6:.1f} M int32 ops at 67 T/s = "
                f"{ops_ms * 1e3:.2f} us); share of bound {b_ms / ms:.3f}; plain version "
                f"{plain_ms * 1e3:.1f} us; library call: none ({smi})")
            timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

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

    with Phase("trace"):
        trace_decode(torch, params, ids, gen, device, smi)

    def entry(name, key, source, replaces, launches, err):
        return dict(name=name, route="cuda", source=f"qkv_ecc_tpu_torch/csrc/{source}",
                    replaces=f"qkv_ecc_tpu/kernels/{replaces}", launches=launches,
                    max_abs_err=err, **timings[key], library_ms=None)

    sl, st = slice_launches, stats_launches
    table = {"kernels": [
        entry("write_attend", "read", "write_attend.cu", "paged_attention.py:1056",
              sl[0]["read"] + st[0]["read"], max_err),
        entry("write_attend read-inject (K2r)", "read-inject", "write_attend.cu",
              "paged_attention.py:352", sl[0]["read-inject"] + st[0]["read-inject"],
              max_err_inject),
        entry("decode_attend", "hamming84-interp", "decode_attend.cu", "paged_attention.py:677",
              sl[1]["hamming84-interp"] + st[1]["hamming84-interp"],
              max_err_decode["hamming84-interp"]),
        entry("decode_attend hamming84 (K2)", "hamming84", "decode_attend.cu",
              "paged_attention.py:135", sl[1]["hamming84"] + st[1]["hamming84"],
              max_err_decode["hamming84"]),
        entry("decode_attend hamming74 (K2)", "hamming74", "decode_attend.cu",
              "paged_attention.py:143", sl[1]["hamming74"] + st[1]["hamming74"],
              max_err_decode["hamming74"]),
        entry("decode_attend golay (K2)", "golay", "decode_attend.cu", "paged_attention.py:154",
              sl[1]["golay"] + st[1]["golay"], max_err_decode["golay"]),
    ]}
    say(f"total {time.perf_counter() - T0:.1f} s")
    say(json.dumps(table))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
