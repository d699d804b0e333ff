#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (qkv_ecc_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ with nvcc (one process per source,
all at once), holds each against its plain PyTorch version at the bench-0.9b
shapes, drives the decode of bench-0.9b (random bf16 weights from a seed,
batch 8, prompt 1024, 32 greedy steps at BER 1e-2) in the five arms of the
JAX bench.py - int12-golay, int4-hamming84, int4-hamming,
int4-hamming84-interp and int4-write-inject, round-robin over two rounds -
through the port's entry points, checks that every kernel of that path was
launched exactly as often as the path calls it, times the kernels and
traces the decode step of each arm. Every phase prints one line with its
seconds; any failure exits non-zero. Without a CUDA device it fails.

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
ROUNDS = 2
# bench.py's arms, in its order; the last is the baseline of the ratios
MODES = ("int12-golay", "int4-hamming84", "int4-hamming", "int4-hamming84-interp",
         "int4-write-inject")
SCRUBBED = tuple(m for m in MODES if m != "int4-hamming84-interp")  # read by write_attend
BASELINE = "int4-write-inject"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM: HBM3 rate and fp32 rate outside the
PEAK_FP32_FLOPS = 67e12     # tensor cores (NVIDIA data sheet)
# SECDED decode of one data word with its parity word (decode_attend.cu:
# codeword rebuild 10, two SWAR decodes of 49, repack 4) and the
# interpolation of one word (10), in 32-bit integer operations
DECODE_OPS_PER_WORD, INTERP_OPS_PER_WORD = 112, 10


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
    """write_attend against write_attend_plain at bench-0.9b attention
    shapes: unequal contexts (1, partial pages, 1024, 1152), int4, golay and
    hamming74 data words, bf16 and fp32 queries, one call with a sliding
    window. Caches and scales must be equal; outputs within
    output_tolerance."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B
    from qkv_ecc_tpu_torch.models.kv_policy import encode_pack_kv_scrubbed

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    ctx_before = [0, 1023, 1151, 129, 500, 777, 64, 1000]  # after the write: 1 .. 1152
    B, Hq, Hkv, D = len(ctx_before), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = 0.0
    cases = [("int4", torch.bfloat16, None), ("golay", torch.bfloat16, None),
             ("golay", torch.float32, None), ("int4", torch.bfloat16, 256),
             ("hamming74", torch.bfloat16, None)]
    for codec, qdtype, window in cases:
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
                           codec=codec, sliding_window=window)
        torch.cuda.synchronize()
        ref = write_attend_plain(q, kn, vn, ksn, vsn, *(p[n] for n in names), bt, ctx, 1,
                                 sm_scale=D ** -0.5, sliding_window=window)
        for n in names:
            if not torch.equal(a[n], p[n]):
                fail(f"kernel check {codec}: {n} after the write differs from the plain version")
        diff = (out.float() - ref.float()).abs()
        tol = output_tolerance(ref)
        err = diff.max().item()
        say(f"  write_attend {codec} q={str(qdtype)[6:]} window={window}: "
            f"max |kernel - plain| = {err:.3e}, largest share of its tolerance "
            f"{(diff / tol).max().item():.3e} (tolerance per element: 2^-7 |plain| + "
            f"2^-8 max |plain| of its row); caches and scales equal")
        if not bool((diff <= tol).all()) or not torch.isfinite(out).all():
            fail(f"kernel check {codec}: output differs beyond tolerance")
        worst = max(worst, err)
    return worst


# tokens given a double error in values 0-3 of every row, K and V: 0, the
# seam tokens of 512-token chunks (511, 1023) and the tokens after them; the
# new column at ctx-1 gets one too
SEAM_TOKENS = (0, 510, 511, 512, 1022, 1023, 1024)


def unscrubbed_h84_cache(torch, cfg, ctx_before, gen, device):
    """A hamming84 cache as the interpolation arm writes it - raw codewords,
    random flips at BER 2e-2 from the generator - with a double error forced
    at SEAM_TOKENS; and the new rows (data ++ parity, double included)."""
    from qkv_ecc_tpu_torch.models.kv_policy import encode_kv, pack_kv, policy_for_mode
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state, _write_tokens

    policy = policy_for_mode("int4-hamming84-interp", ber=2e-2)
    B, Hkv, D = len(ctx_before), cfg.num_kv_heads, cfg.head_dim
    T = max(ctx_before) + 1
    state, bt, _ = init_generation_state(cfg, policy, B, T, 128, device=device)
    pos = torch.arange(T, device=device).expand(B, T)
    forced = torch.zeros((T,), dtype=torch.bool, device=device)
    forced[[t for t in SEAM_TOKENS if t < T]] = True

    def rows(shape, force):
        cw, scale, _ = encode_kv(torch.randn(shape, generator=gen, device=device), policy,
                                 generator=gen)
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


def decode_kernel_check(torch, gen, device):
    """decode_attend against write_decode_attend_plain at bench-0.9b
    attention shapes, both instances (with and without interpolation), 512-
    token chunks, doubles forced at tokens 0, 511, 512, 1023, 1024 and
    ctx-1 over unequal contexts (1 .. 1152). Caches, parity and scales must
    be equal; outputs within output_tolerance."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        h84_decode_rows, gather_pages, paged_attention_ecc_write_attend as write_attend,
        write_decode_attend_plain)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B

    cfg = dataclasses.replace(BENCH_0_9B, num_layers=2)
    ctx_before = [1151, 1023, 1024, 0, 511, 512, 777, 1100]  # after the write: 1 .. 1152
    B, Hq, D = len(ctx_before), cfg.num_heads, cfg.head_dim
    state, bt, new = unscrubbed_h84_cache(torch, cfg, ctx_before, gen, device)
    ctx = torch.tensor(ctx_before, dtype=torch.int32, device=device) + 1
    rows = gather_pages(state["k_cache"], bt, 1, bt.shape[1], state["k_parity"])
    _, dbl = h84_decode_rows(rows, state["k_cache"].shape[3])
    names = ("k_cache", "v_cache", "k_scales", "v_scales", "k_parity", "v_parity")
    worst = 0.0
    for interp in (True, False):
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
        a = {n: state[n].clone() for n in names}
        p = {n: state[n].clone() for n in names}
        out = write_attend(q, new[0], new[1], new[2], new[3], a["k_cache"], a["v_cache"],
                           a["k_scales"], a["v_scales"], bt, ctx, 1, a["k_parity"], a["v_parity"],
                           codec="hamming84", scrub=False, use_interpolation=interp)
        torch.cuda.synchronize()
        ref = write_decode_attend_plain(
            q, new[0], new[1], new[2], new[3], p["k_cache"], p["v_cache"], p["k_scales"],
            p["v_scales"], bt, ctx, 1, p["k_parity"], p["v_parity"], sm_scale=D ** -0.5,
            interpolate=interp, pages_per_chunk=4)
        for n in names:
            if not torch.equal(a[n], p[n]):
                fail(f"decode_attend check (interpolate={interp}): {n} after the write "
                     "differs from the plain version")
        diff = (out.float() - ref.float()).abs()
        tol = output_tolerance(ref)
        err = diff.max().item()
        say(f"  decode_attend interpolate={interp}: max |kernel - plain| = {err:.3e}, largest "
            f"share of its tolerance {(diff / tol).max().item():.3e}; caches, parity and scales "
            f"equal; {int(dbl.sum())} K values of layer 1 read as doubles")
        if not bool((diff <= tol).all()) or not torch.isfinite(out).all():
            fail(f"decode_attend check (interpolate={interp}): output differs beyond tolerance")
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


def tiny_agreement(torch, device):
    """tiny-llama prefill + 6 decode steps at BER 1e-2 in every arm, on the
    card (kernels) and on the CPU (plain versions), same weights and
    masks."""
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import (
        hoisted_logical_masks, hoisted_write_deltas, policy_for_mode)
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.models.runtime import (
        _use_scrub, decode_step, init_generation_state, prefill, write_mask_shape)

    params_cpu = init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    for mode in MODES:
        pol0 = policy_for_mode(mode, ber=0.0)
        pol = policy_for_mode(mode, ber=BER)
        gen = torch.Generator().manual_seed(2)
        hoist = hoisted_write_deltas if _use_scrub(pol) else hoisted_logical_masks
        masks = [hoist(pol, cfg.num_layers, write_mask_shape(pol, 2, cfg), generator=gen)
                 for _ in range(6)]
        logits_by_dev = {}
        for dev in ("cpu", device):
            params = {k: v for k, v in params_cpu.items() if k != "layers"}
            params = {k: v.to(dev) for k, v in params.items()}
            params["layers"] = [{k: v.to(dev) for k, v in lp.items()} for lp in params_cpu["layers"]]
            state, bt, _ = init_generation_state(cfg, pol, 2, 32, 16, device=dev)
            logits, state = prefill(params, ids.to(dev), state, bt, cfg, pol0)
            seq = [logits.cpu()]
            for m in masks:
                logits, state = decode_step(params, torch.argmax(logits, -1), state, bt,
                                            cfg, pol, hoisted_masks=m.to(dev))
                seq.append(logits.cpu())
            logits_by_dev[str(dev)] = torch.stack(seq)
        err = (logits_by_dev["cpu"] - logits_by_dev[str(device)]).abs().max().item()
        say(f"  tiny-llama {mode}: max |logits card - logits cpu| = {err:.3e} (tolerance 1e-2)")
        if not err <= 1e-2:
            fail(f"tiny-llama {mode}: the card's logits disagree with the CPU's")


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


def main():
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

    with Phase("tiny agreement"):
        tiny_agreement(torch, device)

    with Phase("slice"):
        params = init_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
        ids = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device)
        for mode in MODES:  # warm-up of every arm, before the counted run
            pol = policy_for_mode(mode, ber=BER, seed=42)
            st, bt, _ = init_generation_state(cfg, pol, BATCH, 256, device=device)
            lg, st = prefill(params, ids[:, :128], st, bt, cfg, pol, gen)
            decode_loop(params, lg, st, bt, cfg, pol, gen, 2)
        torch.cuda.synchronize()
        write_attend.launches = 0
        write_decode_attend.launches = 0
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
        launches = write_attend.launches
        launches_decode = write_decode_attend.launches
        per_arm = cfg.num_layers * STEPS * ROUNDS
        for name, got, arms in (("write_attend", launches, SCRUBBED),
                                ("decode_attend", launches_decode, MODES[3:4])):
            say(f"  {name} launches in the run: {got} (expected {cfg.num_layers} layers x "
                f"{STEPS} steps x {ROUNDS} rounds x {len(arms)} arm(s) {list(arms)} = "
                f"{per_arm * len(arms)})")
            if got != per_arm * len(arms):
                fail(f"the decode path did not go through the {name} kernel on every layer "
                     "and step of its arms")
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

    with Phase("kernel timing"):
        group = cfg.num_heads // cfg.num_kv_heads
        q = torch.randn((BATCH, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=device).to(torch.bfloat16)

        def bound(nbytes, flops, int_ops):
            bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
            ops_ms = 1e3 * (flops + int_ops) / PEAK_FP32_FLOPS
            return max((bytes_ms, "bytes"), (ops_ms, "operations")) + (bytes_ms, ops_ms)

        # K1 on the golay arm's cache (the column at ctx-1 is rewritten)
        state, bt = runs["int12-golay"][-1]["state"], runs["int12-golay"][-1]["bt"]
        names = ("k_cache", "v_cache", "k_scales", "v_scales")
        L, _, Hkv, Wd, bs = state["k_cache"].shape
        ctx = state["context_len"].clone()
        kn = torch.zeros((BATCH, Hkv, Wd), dtype=torch.int32, device=device)
        sn = torch.ones((BATCH, Hkv), dtype=torch.float32, device=device)

        def call(layer):
            return write_attend(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx, layer,
                                codec="golay")

        def plain(layer):
            return write_attend_plain(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                      layer, sm_scale=cfg.head_dim ** -0.5)

        ms = device_ms(torch, call, 240, L, write_attend)
        call_ms = timed(torch, call, 240, L)
        plain_ms = timed(torch, plain, 24, L)
        ms = min(ms, device_ms(torch, call, 240, L, write_attend))
        # least work of one call: read each live token's K and V data words
        # and scales once, the query, block table and lengths; write the new
        # columns, scales and the output. Operations: QK and PV, one
        # multiply-add each per (token, KV head, group head, value), in fp32.
        tokens = int(ctx.sum())
        nbytes = (tokens * Hkv * (2 * Wd * 4 + 2 * 4) + 2 * q.numel() * q.element_size()
                  + 2 * BATCH * Hkv * (Wd * 4 + 4) + bt.numel() * 4 + BATCH * 4)
        flops = 2 * 2 * tokens * Hkv * group * cfg.head_dim
        bound_ms, bound_by, bytes_ms, ops_ms = bound(nbytes, flops, 0)
        say(f"  write_attend at ctx {PROMPT + STEPS}: {ms * 1e3:.2f} us/launch on the device "
            f"(CUDA events, calls queued behind a sleep; {call_ms * 1e3:.2f} us per "
            f"back-to-back call, host included); bound {bound_ms * 1e3:.2f} us "
            f"by {bound_by} ({nbytes / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms * 1e3:.2f} us; "
            f"{flops / 1e6:.1f} MFLOP fp32 at 67 TFLOP/s = {ops_ms * 1e3:.2f} us); share of bound "
            f"{bound_ms / ms:.3f}; plain version {plain_ms * 1e3:.1f} us; library call: none ({smi})")
        k1 = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)

        # decode_attend on the interpolation arm's cache: data ++ parity rows
        state, bt = (runs["int4-hamming84-interp"][-1][k] for k in ("state", "bt"))
        pnames = ("k_cache", "v_cache", "k_scales", "v_scales")
        rn = torch.zeros((BATCH, Hkv, 2 * Wd), dtype=torch.int32, device=device)
        ctx = state["context_len"].clone()
        dec = {}
        for interp in (True, False):
            def call_d(layer):
                return write_attend(q, rn, rn, sn, sn, *(state[n] for n in pnames), bt, ctx,
                                    layer, state["k_parity"], state["v_parity"],
                                    codec="hamming84", scrub=False, use_interpolation=interp)

            def plain_d(layer):
                return write_decode_attend_plain(
                    q, rn, rn, sn, sn, *(state[n] for n in pnames), bt, ctx, layer,
                    state["k_parity"], state["v_parity"], sm_scale=cfg.head_dim ** -0.5,
                    interpolate=interp, pages_per_chunk=4)

            ms_d = device_ms(torch, call_d, 240, L, write_decode_attend)
            call_ms_d = timed(torch, call_d, 240, L)
            plain_ms_d = timed(torch, plain_d, 24, L)
            ms_d = min(ms_d, device_ms(torch, call_d, 240, L, write_decode_attend))
            # least work: each live token's K and V data and parity words and
            # scales read once, the query, table and lengths; the new rows and
            # scales written, and the output. Operations: the QK and PV
            # multiply-adds in fp32, and the SECDED decode (and interpolation)
            # of every word in 32-bit integer operations, both at 67 T/s
            nbytes_d = (tokens * Hkv * (2 * 2 * Wd * 4 + 2 * 4) + 2 * q.numel() * q.element_size()
                        + 2 * BATCH * Hkv * (2 * Wd * 4 + 4) + bt.numel() * 4 + BATCH * 4)
            int_ops = tokens * Hkv * 2 * Wd * (DECODE_OPS_PER_WORD
                                               + (INTERP_OPS_PER_WORD if interp else 0))
            b_ms, b_by, bytes_ms, ops_ms = bound(nbytes_d, flops, int_ops)
            say(f"  decode_attend interpolate={interp} at ctx {PROMPT + STEPS}: {ms_d * 1e3:.2f} "
                f"us/launch on the device (CUDA events, calls queued behind a sleep; "
                f"{call_ms_d * 1e3:.2f} us per back-to-back call, host included); bound {b_ms * 1e3:.2f} us by {b_by} "
                f"({nbytes_d / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms * 1e3:.2f} us; {flops / 1e6:.1f} MFLOP fp32 + "
                f"{int_ops / 1e6:.1f} M int32 ops at 67 T/s = {ops_ms * 1e3:.2f} us); share of "
                f"bound {b_ms / ms_d:.3f}; plain version {plain_ms_d * 1e3:.1f} us; library "
                f"call: none ({smi})")
            dec[interp] = dict(ms=ms_d, plain_ms=plain_ms_d, bound_ms=b_ms, bound_by=b_by)

    with Phase("trace"):
        trace_decode(torch, params, ids, gen, device, smi)

    table = {"kernels": [{
        "name": "write_attend",
        "route": "cuda",
        "source": "qkv_ecc_tpu_torch/csrc/write_attend.cu",
        "replaces": "qkv_ecc_tpu/kernels/paged_attention.py:1056",
        "launches": launches,
        "max_abs_err": max_err,
        **k1,
        "library_ms": None,
    }, {
        "name": "decode_attend",
        "route": "cuda",
        "source": "qkv_ecc_tpu_torch/csrc/decode_attend.cu",
        "replaces": "qkv_ecc_tpu/kernels/paged_attention.py:677",
        "launches": launches_decode,
        "max_abs_err": max_err_decode,
        **dec[True],
        "library_ms": None,
    }]}
    say(f"total {time.perf_counter() - T0:.1f} s")
    say(json.dumps(table))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
