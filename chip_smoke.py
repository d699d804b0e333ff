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
the same at tiny-llama's shapes with 16-token pages, and chunks of one page
so that blocks of a sequence's cluster hold no token; the packed
write+attend kernels (the scrubbed extract read, int4's
read-time injection, the hamming84 / hamming74 / golay correcting reads
with and without ECC statistics, the -1 page clamp, precision "highest")
and K4, the read alone (paged_attention_ecc: every branch with and without
statistics, the softmax state with a sliding window, an empty row, a -1
page, and the chunk-clamped pages of F4 on all three kernels); then the
packed kernels' split of a sequence's pages over S blocks at S = 1, the
rule's and 3 (whose blocks' pages begin inside a chunk): Golay's correcting
read, write+attend and K4, on caches whose codewords carry every error
pattern of weight 0-3 and 4000 of weight 4, at bench-0.9b's shapes and at
tiny-llama's, and int4's read-inject read, write+attend and K4, with and
without statistics, with a sliding window and with a row of context 0 -
and checks the card against the CPU on tiny-llama in every mode, fp16 and
fp8 included. The kernel instances of gpt2's shapes (group 1, head_dim 64:
12/12 heads) are held the same way: K1's extract read, K2 and K3 with and
without statistics, K2r, K2f in fp16 and fp8 with its NaN pages, and the K4
reads of every branch, at batch 8 and contexts of 1 to 1024 tokens, at the
S the split rule picks (and golay's split at 1, the rule's and 3). So are
trained-tiny's (group 1, head_dim 32: 8/8 heads) at contexts of 1 to 512
tokens (K2f at the float checks' contexts), and timed on caches of 480
tokens a row, and so are tiny-gpt2's (group 1 at head_dim 16) and
trained-100m's (group 3 at head_dim 64), against the unsplit plain
version (the row term scaled for their S of 4, SPLIT_ROW_SCALE) and their
packed reads also against the plain model of the split they take
(split_model, with a printed report of the split's rounding by S), whose
models then
decode on the card in eleven arms against the CPU (M17); a shape without
instances (group 1 at head_dim 96, which no model registers) must raise.
Then it
drives bench-0.9b (random bf16 weights from a seed) through the port's
entry points on four paths:
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
Then gpt2 (124M at full width and depth, float32, random weights from
seed 0) on its paths:
  * decode: batch 8, a 896-token prompt, 32 greedy steps at BER 1e-2 in the
    eight arms, then 8 steps collecting ECC statistics in golay, hamming74
    and hamming84 without scrub;
  * the forward/loss path: registry.loss_and_stats on batch 4 x 1024 tokens
    in fp16, int4, int4-hamming84, int4-hamming and int12-golay at BER 0
    (every int4-code mode's loss equals int4's bit for bit, counting
    nothing) and 1e-2 (flips within 5 sigma of BER x the bits, golay
    corrects, losses finite);
  * the forward against the kernel path at BER 0 in fp16 and
    int4-hamming84: loss_and_stats' logits at positions 895-926 against the
    decode steps' within GPT2_FORWARD_TOL;
  * the BER-0 serve check on gpt2, and sampled generate() deterministic per
    seed; then the new instances' device times at gpt2's decode shapes.
Then the Monte-Carlo quality path (evaluation/: run_sweep's forwards through
kv_policy.process_kv, which launch no kernel, as JAX's), on two paths:
  * quality gpt2: run_sweep on gpt2 at full width (random weights from seed
    0, load_model), 4 synthetic texts at max_length 1024, the seven cache
    modes at BER 0 and 1e-2, seed 42, KL, top-5 and the catastrophic pass
    on: at BER 0 nothing counted and the int4 codes' perplexity equal to
    int4's; at 1e-2 the flips within 4 sigma of BER x bits, the protected
    modes correcting, every perplexity finite but fp8's (NaN bytes);
  * quality trained-tiny: the Monte-Carlo CLI (main) on trained-tiny's
    checkpoint at the TPU run's config (7 modes x 4 BERs x 3 seeds, 20
    texts, max_length 256: 84 trials), its means against
    results/trained_tiny_tpu/monte_carlo_results.json: within a floor at BER
    0, and at BER > 0 within 4 sigma of the difference of the means (or the
    floor) for perplexity, KL, top-5 and the correction rate; inf where the
    TPU run has inf. Without the checkpoint in the copy it says so and is
    skipped.
Then training (training/, the train_tiny CLI) at trained-tiny's full width
(6 layers, hidden 256, float32, batch 32 x 256):
  * F12: the gradient of one batch's loss under the fp16 policy on the card
    against the CPU's from the same parameters, every leaf (and every
    c_attn's K and V columns) with a gradient;
  * one train_tiny update on the card against the CPU's;
  * the CLI for TRAIN_STEPS steps into a temporary directory (the last logged
    loss below half the first), its checkpoint loaded (QKV_TINY_CHECKPOINT)
    and evaluated: the Monte-Carlo CLI at BER 0 and 1e-2 on the held-out
    texts written beside it, and the generation demo in seven decode modes
    through trained-tiny's kernel instances, whose launches are checked;
  * trained-100m (llama, GQA 12/4, vocab 8192) through the CLI for a few
    steps from a small corpus (the word tokenizer and llama's backward).
Then every experiment CLI once (latency, quantization x ECC, architecture,
fault_tolerance_benchmark at its defaults and its grid on gpt2 at full
width, tpu_eval on gpt2 at full width), each result with the JAX package's
keys, its arms at BER 0 agreeing, no NaN; the forward-only ones launch no
kernel, the fault-tolerance decodes go through the kernels.
Then the codec kernels K5-K9 (csrc/codec_kernels.cu) are held equal to
their plain versions (every byte, every Golay data word, every error
pattern of weight 0-3 on a sample of codewords, wide masks, 16M and 4M
injected elements with the flip rate and determinism, and the kernel
benchmark's own inputs at its 8M values), K4 at GQA group 4 against its
plain version in every codec at each of the benchmark's four shapes, and
two more paths run:
  * the kernel benchmark: benchmarks.harness.run_full_benchmark() at the
    JAX defaults (8M values through K5-K7 and K9, the plain pipeline, the
    card against the CPU, K4 hamming84 at 32/8 heads against
    scaled_dot_product_attention at batch 1 and 8, context 512 and 2048),
    whose JSON is printed;
  * the scaling row: benchmarks.scaling.measure_single_device on bench-0.9b
    in int12-golay, batch 4, prompt 64, 20 steps, block 128, and beside it
    measure_tp_mesh at 1x1: one rank through NCCL (the TP = 1 overhead),
    both steps traced (the same kernels, no collective);
  * the parallel layer (M11) on two gloo ranks sharing the card (a rank
    that fails fails the run): TP at model 2 on bench-0.9b (full width, 4
    layers, batch 8, 1024 + 4 steps, BER 1e-2) in float32 in
    int4-write-inject, int4-hamming84 with stats, int12-golay and fp16,
    and in its own bfloat16 in int4-hamming84 with and without stats,
    gpt2 (its c_attn permuted) and one step of trained-100m in two arms,
    each rank against the single-device run on the same card and draws:
    the prefill's words (layer 0's equal, the rest within TP_WORD_SHARE:
    float reassociation), then two decodes from the single-device prefill
    cache: at the rank's own split rules (launches exact, logits within
    output_tolerance) and at the single-device run's (splits_at), whose
    words at the decode positions (the kernels' writes) must be equal in
    layer 0 and within TP_DECODE_WORD_SHARE after it; words elsewhere
    equal, ECC counts and every Hamming(8,4) codeword's syndrome equal;
    bfloat16 within its own bounds; CP (K4's softmax state on page shards
    of bench-0.9b's cache, merged over the ranks) in int4, hamming84 and
    golay and with one shard empty, against the single K4 read; the TP
    server (tiny-llama 8/4, 8 slots, 12 requests, int4-hamming84, BER 0)
    against the single-device server as JAX's test holds its own;
  * golay_sliced (M12, plain torch) on CUDA tensors against the CPU.
Each path checks that every kernel branch it calls was launched exactly as
often as it calls it (the quality paths: none). Then it times the kernels
(K2f beside scaled_dot_product_attention over the same context stored dense, fp16's
yardstick, and its read at 1, 2, 4 and 8 blocks per sequence and KV head
and with no token; Golay's correcting read and the read-inject read at 1,
2, 4 and 8 blocks, against their required times and targets; the codec
kernels K5-K9, the redesigned ones against their required times and
targets (REQUIRED_US), the Golay and Hamming encodes beside a gather
from the table of all codewords and the Hamming decodes beside two, from
data and flag tables; each beside its bound: the bytes at 3.35 TB/s or the
fp32 flops at 67 T/s; the integer bound of Golay's decode, of the read
hashes and of every codec kernel from their SASS instructions per pipe
(kernels/sass_count.py), the packed Hamming reads' integer operations
counted from the source printed as an estimate) and traces the decode step
of each arm. Every phase prints
one line with its seconds; any failure exits non-zero. Without a CUDA
device it fails.

Output, last lines: the kernel table as one JSON object (each kernel also
with int_bound_ms, its integer bound where counted, else null), the card's
name and power limit from nvidia-smi, then {"ok": true, "device": {...}}.
The packed kernels are also held at contexts whose last page holds 1 token
or is full, at head_dim 128, 64 and 32 (page_edge_check), and K1's extract
read, K2 hamming84 and K3 must meet their required times (REQUIRED_US).

    python3 chip_smoke.py --compare-with DIR

times the packed kernels and the redesigned codec kernels (K5, K6, K7's
decode, K8) of this tree against those of DIR (another checkout, such as
`git archive` of the parent commit) in one process (core_compare), and
nothing else.
"""

import contextlib
import itertools
import json
import math
import subprocess
import sys
import tempfile
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
PEAK_FP32_FLOPS = 67e12     # tensor cores, an FMA as two (NVIDIA data sheet)
# 32-bit integer instructions issue on 64 lanes per clock per SM (popcount on
# 16): 64 x 132 SMs x 1.98 GHz. The integer operation counts below come from
# the source, not from the instructions that run, so the time they give at
# this rate is an estimate, printed beside the bound and not part of it
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit integer operations counted from the sources: the SECDED decode of
# one data word with its parity word, 8 codewords on nibble lanes
# (decode_attend.cu h84_decode_word: 48, and its counts 4) and the
# interpolation of one word (10);
# hamming74's decode of one data word (parity gather 8 lanes x 3 planes x 4,
# syndromes 15, correction 14, count 5). Golay's syndrome-table decode and
# the read flips' hashes are counted in the built SASS instead
# (kernels/sass_count.py), which gives them an integer bound
DECODE_OPS_PER_WORD, INTERP_OPS_PER_WORD = 52, 10
H74_OPS_PER_WORD = 130
# the required times at the bench step, and the targets (us), of the
# kernels this port redesigned: Golay's correcting read and the read-inject
# read, then, on the packed core's redesign, K1's extract read, Hamming(8,4)'s
# correcting read (K2) and its interpolating read (K3), then the codec
# kernels K5, K6, K7's decode and K8 (at the kernel benchmark's 8M values
# and 8M / 3 Golay words: half of the bytes bound required, the design's
# estimate the target). A required time missed fails the run; a target is
# reported
REQUIRED_US = {"golay": 180.0, "read-inject": 200.0, "extract": 18.0, "hamming84": 33.0,
               "hamming84-interp": 42.0, "hamming74_encode": 10.0, "hamming84_encode": 10.0,
               "hamming74_decode": 15.0, "hamming84_decode": 15.0, "golay_decode_packed": 20.0,
               "golay_write_scrub": 20.0}
TARGET_US = {"golay": 60.0, "read-inject": 100.0, "extract": 8.0, "hamming84": 15.0,
             "hamming84-interp": 20.0, "hamming74_encode": 7.5, "hamming84_encode": 7.5,
             "hamming74_decode": 11.0, "hamming84_decode": 11.0, "golay_decode_packed": 14.0,
             "golay_write_scrub": 15.0}


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


def bench_attention_cfg():
    """bench-0.9b's attention shapes (two layers of cache)."""
    import dataclasses
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B

    return dataclasses.replace(BENCH_0_9B, num_layers=2)


def kernel_check(torch, gen, device, cfg=None, ctx_before=None):
    """write_attend's clean read against write_attend_plain at cfg's
    attention shapes (default bench-0.9b's): unequal contexts (default 1,
    partial pages, 1024, 1152), int4, golay, hamming74 and hamming84 data
    words, bf16 and fp32 queries, one call with a sliding window, one at
    precision "highest". Caches and scales must be equal; outputs within
    output_tolerance."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_attend_plain)
    from qkv_ecc_tpu_torch.models.kv_policy import encode_pack_kv_scrubbed

    cfg = cfg or bench_attention_cfg()
    ctx_before = ctx_before or [0, 1023, 1151, 129, 500, 777, 64, 1000]  # after: 1 .. 1152
    B, Hq, Hkv, D = len(ctx_before), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    worst = 0.0
    cases = [("int4", torch.bfloat16, None, "fast"), ("golay", torch.bfloat16, None, "fast"),
             ("golay", torch.float32, None, "fast"), ("int4", torch.bfloat16, 256, "fast"),
             ("hamming74", torch.bfloat16, None, "fast"),
             ("hamming84", torch.float32, None, "fast"),
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
            f"write_attend {codec} q={str(qdtype)[6:]} window={window} precision={precision} "
            f"[{cfg.name}]", out, ref, a, p, names))
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


def decode_kernel_check(torch, gen, device, cfg=None, ctx_before=None, qdtype=None):
    """decode_attend against write_decode_attend_plain at cfg's attention
    shapes (default bench-0.9b's: B 8, Hkv 8, group 2, head_dim 128,
    contexts 1 to 1152; queries of qdtype, default bf16), layer 1,
    512-token chunks: hamming84 with and without interpolation
    (doubles forced at tokens 0, 511, 512, 1023, 1024 and ctx-1), with and
    without stats; hamming74 and golay, with and without stats; golay once
    more with one row whose page is -1 (ctx 1: written to page 0, which no
    other row reads). Caches, parity, scales and stats must be equal;
    outputs within output_tolerance. Returns the largest error of each
    codec's branch."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        h84_decode_rows, gather_pages, paged_attention_ecc_write_attend as write_attend,
        write_decode_attend_plain)

    cfg = cfg or bench_attention_cfg()
    ctx_before = ctx_before or [1151, 1023, 1024, 0, 511, 512, 777, 1100]  # after: 1 .. 1152
    qdtype = qdtype or torch.bfloat16
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
            q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
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
            name = f"decode_attend {codec} interpolate={interp} stats={stats} [{cfg.name}]"
            err = check_outputs(name, out, ref, a, p, names, st, ref_st)
            if stats and not (int(st[:, 0].sum()) > 0
                              and (codec == "hamming74" or int(st[:, 1].sum()) > 0)):
                fail(f"{name}: the errors in the cache were not counted")
            if interp == "-1 page" and torch.equal(a["k_cache"][1, 0], state["k_cache"][1, 0]):
                fail(f"{name}: the row whose page is -1 did not write page 0")
            key = codec + ("-interp" if interp is True else "")
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def read_inject_check(torch, gen, device, cfg=None, ctx_before=None, qdtype=None):
    """int4's read-time injection (write_attend with read_inject_ber 1e-2, a
    device seed) against write_attend_plain at cfg's attention shapes
    (default bench-0.9b's; queries of qdtype, default bf16),
    with and without stats, with a sliding window of 256 (stats on: the
    flips before the window are counted, never attended) and with row 5 of
    context 0 (nothing written, attended or counted): caches and scales
    equal (they change only in the new column), the flipped-bit count
    equal, outputs within output_tolerance. Then K4's read-inject read on
    the same cache (paged_attention_ecc, no new column) with stats, a
    window and the empty row, against attend_plain. Labels name the blocks
    S per (sequence, KV head)."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        attend_plain, paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_attend_plain)

    cfg = cfg or bench_attention_cfg()
    ctx_before = ctx_before or [0, 1023, 1151, 129, 500, 777, 64, 1000]
    qdtype = qdtype or torch.bfloat16
    B, Hq, D = len(ctx_before), cfg.num_heads, cfg.head_dim
    state, bt, new = unscrubbed_cache(torch, cfg, "int4", ctx_before, gen, device, ber=0.0)
    ctx = torch.tensor(ctx_before, dtype=torch.int32, device=device) + 1
    empty = ctx.clone()
    empty[5] = 0
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    s = splits_label(torch, B, cfg.num_kv_heads, bt.shape[1], 4, state["k_cache"].shape[3])
    worst = 0.0
    thr = int(BER * 2 ** 32)
    for stats, window, c, what in ((False, None, ctx, ""), (True, None, ctx, ""),
                                   (True, 256, ctx, " window=256"),
                                   (True, None, empty, " row 5 of context 0")):
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
        seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen, device=device).to(torch.int32)
        a = {n: state[n].clone() for n in names}
        p = {n: state[n].clone() for n in names}
        out = write_attend(q, *new, *(a[n] for n in names), bt, c, 1, codec="int4",
                           read_inject_ber=BER, read_inject_seed=seed, collect_stats=stats,
                           sliding_window=window)
        torch.cuda.synchronize()
        ref = write_attend_plain(q, *new, *(p[n] for n in names), bt, c, 1,
                                 sm_scale=D ** -0.5, read_threshold=thr, read_seed=seed,
                                 pages_per_chunk=4, collect_stats=stats, sliding_window=window)
        (out, st), (ref, ref_st) = (out, ref) if stats else ((out, None), (ref, None))
        err = check_outputs(f"write_attend int4 read-inject BER {BER} stats={stats}{what} "
                            f"[{cfg.name}, {s}]",
                            out, ref, a, p, names, st, ref_st)
        if c is empty and (out[5].any() or (stats and int(st[5].abs().sum()) != 0)):
            fail("read-inject: the row of context 0 read or counted something")
        if stats and window is None and c is ctx:
            bits = int(ctx.sum()) * cfg.num_kv_heads * 2 * state["k_cache"].shape[3] * 32
            rate = int(st[:, 0].sum()) / bits
            say(f"    flipped {int(st[:, 0].sum())} of {bits} bits read: rate {rate:.6f}")
            if not 0.9 * BER < rate < 1.1 * BER or int(st[:, 1].sum()) != 0:
                fail("read-inject: the flipped-bit count is off its rate")
        worst = max(worst, err)
        # K4: the same read without a new column, on the cache as it stands
        seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen, device=device).to(torch.int32)
        args = (q, *(state[n] for n in names), bt, c, 1)
        out = paged_attention_ecc(*args, codec="int4", read_inject_ber=BER, read_inject_seed=seed,
                                  collect_stats=True, sliding_window=window)
        torch.cuda.synchronize()
        ref = attend_plain(*args, codec="int4", sm_scale=D ** -0.5, num_pages=bt.shape[1],
                           pages_per_chunk=4, read_threshold=thr, read_seed=seed,
                           collect_stats=True, sliding_window=window)
        worst = max(worst, check_outputs(
            f"paged_attention_ecc read-inject stats=True{what} [{cfg.name}, {s}]", out[0], ref[0],
            {}, {}, (),
            out[1], ref[1]))
    return worst


# the blocks per (sequence, KV head) at which the packed kernels' split is
# checked: 1, the rule's (None) and 3, whose blocks' pages begin inside the
# 4-page chunks of 512 tokens (and of tiny-llama's pages of 16)
CHECK_SPLITS = (1, None, 3)


@contextlib.contextmanager
def forced_splits(s):
    """The packed kernels' blocks per (sequence, KV head) forced to s for
    the block (None: the rule's, packed_splits)."""
    from qkv_ecc_tpu_torch.kernels import paged_attention as pa

    rule = pa.packed_splits
    if s is not None:
        pa.packed_splits = lambda *a, **kw: s
    try:
        yield
    finally:
        pa.packed_splits = rule


@contextlib.contextmanager
def split_model():
    """The packed kernels' plain versions (write_attend_plain,
    write_decode_attend_plain and attend_plain, which all read through
    paged_attention._read) taking the split that the kernel takes on the
    same shapes: S = packed_splits of the call, block r the visited pages
    r, r + S, ..., each state over its own pages and the states merged by
    merge_softmax_states - the plain model of the split, which
    tests/test_torch_paged_attention.py holds to JAX. Each weight is then
    rounded against the same maximum in both, so a check under it holds a
    kernel to its own split; the float codecs' reads (K2f splits tokens
    differently) are left as they are."""
    import torch
    from qkv_ecc_tpu_torch.kernels import paged_attention as pa

    real = pa._read

    def read(query, k_cache, *args, codec, num_pages, pages_per_chunk, page_range=None, **kw):
        kw.update(codec=codec, num_pages=num_pages, pages_per_chunk=pages_per_chunk)
        pages = pa.visited_pages(num_pages, pages_per_chunk)
        s = pa.packed_splits(query.shape[0], k_cache.shape[2], pages,
                             pa._sm_count(query.device.index), k_cache.shape[3])
        if codec in pa._FLOAT or page_range is not None or s == 1:
            return real(query, k_cache, *args, page_range=page_range, **kw)
        parts = [real(query, k_cache, *args, page_range=range(r, pages, s), **kw)
                 for r in range(s)]
        states = (torch.stack(x) for x in zip(*(state for state, _ in parts)))
        return pa.merge_softmax_states(*states), parts[0][1]

    pa._read = read
    try:
        yield
    finally:
        pa._read = real


def splits_label(torch, batch, hkv, num_pages, ppc, data_words):
    """'S n' of a packed kernel's launch on these shapes, as packed_splits
    gives it (or as forced)."""
    from qkv_ecc_tpu_torch.kernels import paged_attention as pa

    return "S %d" % pa.packed_splits(batch, hkv, pa.visited_pages(num_pages, min(ppc, num_pages)),
                                     pa._sm_count(0), data_words)


def golay_crafted_cache(torch, cfg, ctx_before, block_size, gen, device):
    """A golay cache (every layer of cfg, raw codewords, as an unscrubbed
    arm stores them) whose codewords carry the error patterns of
    golay_error_patterns - every pattern of weight 0-3, 4000 of weight 4 -
    on 30% of the codewords (the rest clean), and new rows made the same
    way. Returns the state, the table, the new rows (data ++ parity) and the
    count of each error weight 0-4 written."""
    from qkv_ecc_tpu_torch.kernels.common import popcount
    from qkv_ecc_tpu_torch.models.kv_policy import KVCachePolicy, encode_kv, pack_kv
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state, _write_tokens

    policy = KVCachePolicy(codec="golay")
    B, Hkv, D = len(ctx_before), cfg.num_kv_heads, cfg.head_dim
    T = max(ctx_before) + 1
    state, bt, _ = init_generation_state(cfg, policy, B, T, block_size, device=device)
    pos = torch.arange(T, device=device).expand(B, T)
    pats = golay_error_patterns(torch, gen, device)
    pats = pats[(pats >> 24) == 0]  # the cache keeps 24 bits a codeword
    hist = torch.zeros(5, dtype=torch.int64, device=device)

    def rows(shape):
        nonlocal hist
        cw, scale, _ = encode_kv(torch.randn(shape, generator=gen, device=device), policy)
        pick = pats[torch.randint(0, len(pats), cw.shape, generator=gen, device=device)]
        err = torch.where(torch.rand(cw.shape, generator=gen, device=device) < 0.3, pick, 0)
        hist += torch.bincount(popcount(err).reshape(-1).long(), minlength=5)[:5]
        return pack_kv(cw ^ err, policy, D), scale

    for layer in range(cfg.num_layers):
        kc, ks = rows((B, T, Hkv, D))
        vc, vs = rows((B, T, Hkv, D))
        _write_tokens(state, layer, bt, pos, kc, vc, ks, vs)
    kn, ksn = rows((B, 1, Hkv, D))
    vn, vsn = rows((B, 1, Hkv, D))
    return state, bt, (kn[:, 0].contiguous(), vn[:, 0].contiguous(), ksn[:, 0].contiguous(),
                       vsn[:, 0].contiguous()), hist.tolist()


def golay_split_check(torch, gen, device, cfg, block_size, ctx_before):
    """K2 golay (decode_attend, write+attend, with and without stats) and
    K4 golay (paged_attention_ecc with stats, row 1 empty) on
    golay_crafted_cache against their plain versions at cfg's attention
    shapes (layer 1, 512-token chunks): caches, parity and scales after the
    write equal, the counts equal, outputs within output_tolerance. Returns
    the largest error of K2 and of K4."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        attend_plain, paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_decode_attend_plain)

    B, Hq, D = len(ctx_before), cfg.num_heads, cfg.head_dim
    state, bt, new, hist = golay_crafted_cache(torch, cfg, ctx_before, block_size, gen, device)
    if any(h == 0 for h in hist):
        fail(f"golay crafted cache: error weights 0-4 written {hist} miss a weight")
    ppc = max(1, 512 // block_size)
    s = splits_label(torch, B, cfg.num_kv_heads, bt.shape[1], ppc, state["k_cache"].shape[3])
    where = f"[{cfg.name} block {block_size}, {s}; error weights 0-4 written: {hist}]"
    names = ("k_cache", "v_cache", "k_scales", "v_scales", "k_parity", "v_parity")
    ctx = torch.tensor(ctx_before, dtype=torch.int32, device=device) + 1
    worst = [0.0, 0.0]
    for stats in (False, True):
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
        a = {n: state[n].clone() for n in names}
        p = {n: state[n].clone() for n in names}
        out = write_attend(q, *new, a["k_cache"], a["v_cache"], a["k_scales"], a["v_scales"], bt,
                           ctx, 1, a["k_parity"], a["v_parity"], codec="golay",
                           block_size=block_size, collect_stats=stats)
        torch.cuda.synchronize()
        ref = write_decode_attend_plain(
            q, *new, p["k_cache"], p["v_cache"], p["k_scales"], p["v_scales"], bt, ctx, 1,
            p["k_parity"], p["v_parity"], codec="golay", sm_scale=D ** -0.5,
            pages_per_chunk=min(ppc, bt.shape[1]), collect_stats=stats)
        (out, st), (ref, ref_st) = (out, ref) if stats else ((out, None), (ref, None))
        worst[0] = max(worst[0], check_outputs(
            f"decode_attend golay crafted errors stats={stats} {where}", out, ref, a, p, names,
            st, ref_st))
        if stats and not (int(st[:, 0].sum()) > 0 and int(st[:, 1].sum()) > 0):
            fail("golay crafted errors: corrections and uncorrectable codewords not counted")
    k4_ctx = ctx.clone()
    k4_ctx[1] = 0
    q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
    args = (q, *(state[n] for n in names[:4]), bt, k4_ctx, 1, state["k_parity"],
            state["v_parity"])
    out = paged_attention_ecc(*args, codec="golay", block_size=block_size, collect_stats=True)
    torch.cuda.synchronize()
    ref = attend_plain(*args, codec="golay", sm_scale=D ** -0.5, num_pages=bt.shape[1],
                       pages_per_chunk=min(ppc, bt.shape[1]), collect_stats=True)
    worst[1] = check_outputs(f"paged_attention_ecc golay crafted errors, row 1 empty {where}",
                             out[0], ref[0], {}, {}, (), out[1], ref[1])
    if out[0][1].any():
        fail("golay crafted errors: the empty row did not read 0")
    return worst


def split_check(torch, gen, device):
    """The packed kernels' split at S = 1, the rule's and 3 (CHECK_SPLITS):
    golay_split_check at bench-0.9b's attention shapes (block 128, contexts
    1 to 1152), at gpt2's (block 128, group 1, head_dim 64, contexts 1 to
    1024), at trained-tiny's (block 128, group 1, head_dim 32, contexts 1
    to 512) and at tiny-llama's (block 16, contexts 1 to 160), and
    read_inject_check. Returns the largest errors of K2 golay, K4 golay and
    the read-inject reads."""
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA

    worst = dict(golay=0.0, k4_golay=0.0, inject=0.0)
    for s in CHECK_SPLITS:
        with forced_splits(s):
            for cfg, bs, ctx_before in (
                    (bench_attention_cfg(), 128, [1151, 1023, 1024, 0, 511, 512, 777, 1100]),
                    (gpt2_attention_cfg(), 128, GPT2_CTX_BEFORE),
                    (tiny_attention_cfg(), 128, TINY_CTX_BEFORE),
                    (TINY_LLAMA, 16, [159, 0, 15, 16, 100, 47, 128, 33])):
                k2, k4 = golay_split_check(torch, gen, device, cfg, bs, ctx_before)
                worst["golay"] = max(worst["golay"], k2)
                worst["k4_golay"] = max(worst["k4_golay"], k4)
            worst["inject"] = max(worst["inject"], read_inject_check(torch, gen, device))
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


def attend_check(torch, gen, device, cfg=None, contexts=None, qdtype=None):
    """K4 (paged_attention_ecc, the read without a write) against
    attend_plain at cfg's attention shapes (default bench-0.9b's: B 8, Hkv
    8, group 2, head_dim 128, contexts K4_CTX: 1 to 1152 tokens, a row whose
    page is -1, an empty row; queries of qdtype, default bf16; layer 1,
    512-token chunks), every branch with and without
    stats (the extract read refuses them), then each with
    return_softmax_state and a sliding window of 256. Caches must be
    unchanged, stats equal, outputs (and acc) within output_tolerance, m and
    l within 1e-5 relative, the empty row 0. Then the F4 input: num_pages 5
    of a 9-page table at 512-token chunks (the kernel visits 8 pages, pages
    5-7 read page 4 again; a table of 5 pages or fewer: all but its last
    page, in one chunk of that many pages, as the wrappers clamp a chunk to
    num_pages), K4, write_attend and decode_attend against their plain
    versions. Returns the largest error of each K4 branch."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        attend_plain, paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_attend_plain, write_decode_attend_plain)

    cfg = cfg or bench_attention_cfg()
    contexts = contexts or K4_CTX
    qdtype = qdtype or torch.bfloat16
    ctx_before = [c - 1 for c in contexts]
    B, Hq, D = len(contexts), cfg.num_heads, cfg.head_dim
    names = ("k_cache", "v_cache", "k_scales", "v_scales", "k_parity", "v_parity")
    ctx = torch.tensor(contexts, dtype=torch.int32, device=device)
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
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
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
                           pages_per_chunk=min(4, num_pages or bt.shape[1]),
                           sliding_window=window,
                           read_threshold=int(BER * 2 ** 32) if seed is not None else None,
                           read_seed=seed if seed is not None else 0,
                           interpolate=kw.get("use_interpolation", False), collect_stats=stats,
                           return_softmax_state=state_out)
        for n, a in before.items():
            if not torch.equal(a, state[n]):
                fail(f"K4 {branch}: the read changed {n}")
        (out, st), (ref, ref_st) = (out, ref) if stats else ((out, None), (ref, None))
        label = (f"paged_attention_ecc {branch} stats={stats}" + (f" window={window}" if window else "")
                 + (f" num_pages={num_pages}" if num_pages else "") + f" [{cfg.name}]")
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
    f4 = min(5, caches["int4"][2].shape[1] - 1)
    for branch in ("read", "hamming74"):
        worst[branch] = max(worst[branch], run(branch, True, num_pages=f4))
    # ... and the write+attend kernels on the same input, with row 3 on its
    # own page (a row of -1 would write page 0, which row 0 reads)
    for mode, codec in (("int4", "int4"), ("int4-hamming", "hamming74")):
        state, _, bt = caches[mode]
        parity = () if codec == "int4" else (state["k_parity"], state["v_parity"])
        W = state["k_cache"].shape[3] + (parity[0].shape[3] if parity else 0)
        new = [torch.randint(0, 2 ** 31, (B, cfg.num_kv_heads, W), generator=gen,
                             device=device).to(torch.int32) for _ in range(2)]
        sn = torch.rand((B, cfg.num_kv_heads), generator=gen, device=device)
        q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
        a = {n: state[n].clone() for n in names if n in state}
        p = {n: state[n].clone() for n in names if n in state}
        out = write_attend(q, *new, sn, sn, a["k_cache"], a["v_cache"], a["k_scales"],
                           a["v_scales"], bt, ctx, 1, *(() if codec == "int4" else
                                                        (a["k_parity"], a["v_parity"])),
                           codec=codec, num_pages=f4, collect_stats=True)
        torch.cuda.synchronize()
        plain = write_attend_plain if codec == "int4" else write_decode_attend_plain
        extra = {} if codec == "int4" else dict(codec=codec)
        ref = plain(q, *new, sn, sn, p["k_cache"], p["v_cache"], p["k_scales"], p["v_scales"],
                    bt, ctx, 1, *(() if codec == "int4" else (p["k_parity"], p["v_parity"])),
                    sm_scale=D ** -0.5, num_pages=f4, pages_per_chunk=min(4, f4),
                    collect_stats=True,
                    **extra)
        check_outputs(f"{'write_attend' if codec == 'int4' else 'decode_attend'} {codec} "
                      f"num_pages={f4} (F4) [{cfg.name}]", out[0], ref[0], a, p, tuple(a), out[1],
                      ref[1])
    return worst


# the float checks' contexts after the write: 1 to 1152 tokens
FLOAT_CTX = [1152, 1024, 1025, 1, 512, 130, 778, 1101]
NAN_BITS = {"fp16": 0x7FC0, "fp8": 0x7F}


def float_cache(torch, cfg, codec, gen, device, block_size, tokens=1152):
    """A float cache of every layer of cfg with a value in every slot (a
    recycled page keeps old values in its dead slots): normals, a tenth of
    them times 30, stored as the codec stores them; random scales arrays
    (a float read must leave them as they are); the sequential table."""
    from qkv_ecc_tpu_torch.kernels.common import to_float_storage
    from qkv_ecc_tpu_torch.models.kv_policy import KVCachePolicy
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state

    state, bt, _ = init_generation_state(cfg, KVCachePolicy(codec=codec), len(FLOAT_CTX),
                                         tokens, block_size, device=device)
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
    128) and at tiny-llama's (Hkv 2, group 2, head_dim 16, block 16), 512-
    token chunks, layer 1, contexts FLOAT_CTX, in fp16 (bfloat16 pages) and
    fp8 (e4m3): the write+attend with bf16 and fp32 queries, at precision
    "fast" and "highest"; the same with row 3 on a page of -1 (written to
    page 0, which row 0, now empty, does not read); K4, the read alone, with
    an empty row (5) and a -1 page, as the output and as the softmax state
    with a sliding window of 256; F4: num_pages 5 of the table (the kernel
    visits whole chunks of pages, reading page 4 again) for both; chunks of
    one page (pages_per_chunk 1: the row of context 1 visits one page, fewer
    tiles than the warps of its S blocks, so that blocks and warps without a
    token merge) for both; and a cache with NaN (e4m3 0x7f, bfloat16 0x7fc0)
    in a live K slot (row 1, token 100), a live V slot (row 2, token 7), a
    dead V slot of the last page (row 6, token 800) and a V slot of a page
    past the context in the last chunk (row 5, token 300): NaN where the
    plain version has NaN. Arrays after the write equal, the scales arrays
    unchanged. Last, the widening alone: one-token contexts whose V values
    are all 256 e4m3 codes (bfloat16 codes at an even stride) read out
    exactly torch's conversion. Each label names the blocks S per (sequence,
    KV head) that float_splits gave the launch. Returns the largest error
    of each (codec, write or read)."""
    import dataclasses
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B, TINY_LLAMA

    worst = {}
    for cfg, bs in ((dataclasses.replace(BENCH_0_9B, num_layers=2), 128), (TINY_LLAMA, 16)):
        for key, err in float_kernel_check_at(torch, gen, device, cfg, bs).items():
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def float_kernel_check_at(torch, gen, device, cfg, bs):
    """float_kernel_check on cfg's attention shapes with pages of bs
    tokens."""
    from qkv_ecc_tpu_torch.kernels.common import to_float_storage
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        _sm_count, attend_plain, float_splits, paged_attention_ecc,
        paged_attention_ecc_write_attend as write_attend, visited_pages, write_attend_plain)

    B, Hq, Hkv, D = len(FLOAT_CTX), cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    tpc = 512  # the default chunk: 512 tokens of pages
    worst = {}
    for codec in ("fp16", "fp8"):
        state, bt = float_cache(torch, cfg, codec, gen, device, bs)
        scales = {n: state[n].clone() for n in ("k_scales", "v_scales")}
        ctx = torch.tensor(FLOAT_CTX, dtype=torch.int32, device=device)

        def shape(num_pages, ppc):
            """The label's shapes: block size, chunk, S."""
            num_pages = num_pages or bt.shape[1]
            ppc = min(ppc or tpc // bs, num_pages)
            s = float_splits(B, Hkv, visited_pages(num_pages, ppc) * bs,
                             state["k_cache"].element_size(), _sm_count(device.index or 0))
            return f"[{cfg.name} block {bs}, {ppc}-page chunks, S {s}]", ppc

        def new():
            return [to_float_storage(codec, torch.randn((B, Hkv, D), generator=gen,
                                                        device=device)) for _ in range(2)]

        def write(label, qdtype=torch.bfloat16, precision="fast", bt=bt, ctx=ctx, num_pages=None,
                  ppc=None, st=state):
            q = torch.randn((B, Hq, D), generator=gen, device=device).to(qdtype)
            kn, vn = new()
            sn = torch.ones((B, Hkv), device=device)
            a = {n: st[n].clone() for n in names}
            p = {n: st[n].clone() for n in names}
            out = write_attend(q, kn, vn, sn, sn, *(a[n] for n in names), bt, ctx, 1, codec=codec,
                               block_size=bs, precision=precision, num_pages=num_pages,
                               pages_per_chunk=ppc)
            torch.cuda.synchronize()
            where, ppc = shape(num_pages, ppc)
            ref = write_attend_plain(q, kn, vn, sn, sn, *(p[n] for n in names), bt, ctx, 1,
                                     sm_scale=D ** -0.5, precision=precision, codec=codec,
                                     num_pages=num_pages, pages_per_chunk=ppc)
            for n in ("k_scales", "v_scales"):
                if not torch.equal(a[n], scales[n]):
                    fail(f"K2f {codec} {label} {where}: the write changed {n}")
            key = (codec, "write")
            worst[key] = max(worst.get(key, 0.0), check_float(
                f"float_attend {codec} write+attend {label} {where}", out, ref, a, p))

        def read(label, bt=bt, ctx=ctx, num_pages=None, ppc=None, window=None, state_out=False,
                 st=state):
            q = torch.randn((B, Hq, D), generator=gen, device=device).to(torch.bfloat16)
            args = (q, *(st[n] for n in names), bt, ctx, 1)
            before = {n: st[n].clone() for n in names}
            out = paged_attention_ecc(*args, codec=codec, block_size=bs, num_pages=num_pages,
                                      pages_per_chunk=ppc, sliding_window=window,
                                      return_softmax_state=state_out, collect_stats=True)
            torch.cuda.synchronize()
            where, ppc = shape(num_pages, ppc)
            label = f"{label} {where}"
            ref = attend_plain(*args, codec=codec, sm_scale=D ** -0.5,
                               num_pages=num_pages or bt.shape[1], pages_per_chunk=ppc,
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
        write("pages_per_chunk=1", ppc=1)
        read("pages_per_chunk=1", ppc=1)
        # NaN pages (row, token, K or V): a live K slot, a live V slot, a dead
        # V slot of the last page, a V slot of a page past the context that
        # the last 512-token chunk holds
        poisoned = {n: state[n].clone() for n in names}
        for row, tok, n in ((1, 100, "k_cache"), (2, 7, "v_cache"), (6, 800, "v_cache"),
                            (5, 300, "v_cache")):
            page = int(bt[row, tok // bs])
            raw = poisoned[n].view(torch.uint8 if codec == "fp8" else torch.int16)
            raw[1, page, 0, 5, tok % bs] = NAN_BITS[codec]
        write("NaN pages", st=poisoned)
        out = read("NaN pages", st=poisoned)
        nan = torch.isnan(out.float())
        G = Hq // Hkv  # the query heads of KV head 0
        if not (nan[2, :G, 5].all() and nan[6, :G, 5].all() and nan[5, :G, 5].all()
                and not out[1, :G].any()):
            fail(f"K2f {codec}: the NaN pages did not reach the output as on the TPU")
        read("NaN pages, softmax state", st=poisoned, state_out=True)
        # the widening, exactly: a context of one token (each row's new
        # column) at precision "highest" reads out its V values unchanged, so
        # the fp32 output holds the kernel's widening of every code written:
        # all 256 e4m3 codes, bfloat16 codes at a stride of 2^16 / n (8 at
        # bench-0.9b's n: each exponent, the subnormals, +-inf and NaN among
        # them)
        bits = torch.uint8 if codec == "fp8" else torch.int16
        n = B * Hkv * D
        codes = (torch.arange(n, device=device) % 256 if codec == "fp8" else
                 torch.arange(n, device=device) * (2 ** 16 // n) - 2 ** 15).to(bits)
        vn = codes.reshape(B, Hkv, D).view(state["v_cache"].dtype)
        kn = new()[0]
        one = torch.ones_like(ctx)
        q = torch.randn((B, Hq, D), generator=gen, device=device)
        sn = torch.ones((B, Hkv), device=device)
        a = {n: state[n].clone() for n in names}
        out = write_attend(q, kn, vn, sn, sn, *(a[n] for n in names), bt, one, 1, codec=codec,
                           block_size=bs, precision="highest")
        torch.cuda.synchronize()
        want = vn.to(torch.float32).repeat_interleave(Hq // Hkv, dim=1)
        same = torch.equal(torch.isnan(out), torch.isnan(want)) and torch.equal(
            torch.nan_to_num(out, posinf=1e38, neginf=-1e38),
            torch.nan_to_num(want, posinf=1e38, neginf=-1e38))
        say(f"  float_attend {codec} widening of {len(torch.unique(codes))} codes "
            f"[{cfg.name}], against torch's: {'equal' if same else 'DIFFERENT'}")
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


def serve_ber0_check(torch, device, cfg=None, params=None):
    """At BER 0 on the card, three requests admitted at different times
    return exactly the tokens generate() gives each prompt alone
    (int4-hamming84; cfg and params default to bench-0.9b in float32
    weights from seed 0, so that batch 8 against batch 1 only reorders
    float32 sums; prompts of whole buckets, 16 new tokens)."""
    import dataclasses

    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.models.runtime import generate
    from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request

    if cfg is None:
        cfg = dataclasses.replace(BENCH_0_9B, dtype="float32")
        params = init_params(cfg, seed=0, device=device)
    pol = policy_for_mode("int4-hamming84", ber=0.0, seed=42)
    g = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g) for n in (384, 128, 256)]
    want = [generate(params, p[None].to(device), cfg, pol, max_new_tokens=16,
                     device=device)[0, len(p):].tolist() for p in prompts]
    server = ContinuousBatchingServer(params, cfg, pol, max_batch=SERVE_BATCH,
                                      max_seq_len=min(1280, cfg.max_position_embeddings),
                                      block_size=128, prefill_bucket=128, device=device)
    server.add_request(Request(0, prompts[0].numpy(), max_new_tokens=16))
    server.add_request(Request(1, prompts[1].numpy(), max_new_tokens=16))
    for _ in range(3):
        server.step()
    server.add_request(Request(2, prompts[2].numpy(), max_new_tokens=16))
    got = {o.request_id: o.token_ids for o in server.run()}
    same = all(got[i] == want[i] for i in range(3))
    say(f"  serve BER 0 [{cfg.name}]: 3 staggered requests against generate() of each alone: "
        f"tokens {'identical' if same else 'DIFFER'}")
    if not same:
        fail(f"serve BER 0: {got} != {want}")


def output_tolerance(ref):
    """Per element of the [B, Hq, D] output: 2^-7 |ref| is one bf16 ulp of
    the element (the last rounding, which both sides make), and 2^-8 of the
    largest |ref| of its (sequence, head) row allows one softmax weight
    p * v_scale to round to a neighbouring bf16 value after an fp32 ulp of
    difference in exp or in the summation order. K2f (float_attend) splits
    a sequence's tokens over warps and blocks, and the packed kernels its
    pages over S blocks (packed_splits), each block rounding its weights
    against its own running maximum where the plain version rounds them
    against the row's, so both terms are needed there: a weight rounds to
    a neighbouring bf16 value (the second term), and the fp32 results then
    differ enough for a bf16 output to round to the neighbouring value (the
    first). At S = 1 a packed kernel takes the softmax page by page as the
    plain version does and needs neither in practice. A row scale rather
    than the batch's largest value keeps a token dropped or added at any
    context length (ctx 1 to 1152) beyond the tolerance."""
    r = ref.float().abs()
    return 2.0 ** -7 * r + 2.0 ** -8 * ROW_TERM_SCALE * r.amax(dim=-1, keepdim=True)


# The row term's scale: 1, but sqrt(ln 64 / ln 32) in trained-tiny's checks
# (tiny_kernel_check). Its rows hold 32 values, and the largest |ref| of a
# row of n roughly Gaussian outputs grows as sqrt(2 ln n), while the split
# read's rounding (each block's weights rounded to bf16 against its own
# maximum, the plain version's against the running one) does not depend on
# n: the factor gives a 32-value row the margin a 64-value row of gpt2's
# group-1 instances has. Measured on an H100 without it: up to 1.008 of the
# tolerance at head_dim 32 (decode_attend hamming74, F4's input; the kernel
# 3.3e-4 and the plain version 2.2e-4 from the exact answer, on opposite
# sides, at an output of -6.4e-3 in a row whose largest is 0.126), against
# at most 0.82 at head_dim 64 and 0.83 at 128.
ROW_TERM_SCALE = 1.0


TINY_MODES = MODES + ("int12-golay/scrub=False", "int4-hamming/scrub=False",
                      "int4-write-inject/scrub=False", "int12-golay/stats", "int4-hamming/stats",
                      "int4-hamming84/stats", "int4-hamming84-interp/stats", "int4/stats")
TINY_STEPS = 6  # tiny_agreement's decode steps


def tiny_agreement(torch, device, cfg=None, modes=TINY_MODES):
    """cfg's (default tiny-llama's) prefill + TINY_STEPS decode steps at BER
    1e-2 in every mode (the arms, the float arms fp16 and fp8, the
    unscrubbed reads, collect_ecc_stats), on the card (kernels)
    and on the CPU (plain versions), same weights, write masks, prefill read
    flips and read seeds: logits within 1e-2, the same greedy tokens and the
    same ECC counts."""
    import dataclasses
    from qkv_ecc_tpu_torch.codecs.fault_injection import flip_mask
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA
    from qkv_ecc_tpu_torch.models.kv_policy import (
        hoisted_logical_masks, hoisted_write_deltas, policy_for_mode, write_inject)
    from qkv_ecc_tpu_torch.models.registry import init_params, map_tree
    from qkv_ecc_tpu_torch.models.runtime import (
        _use_scrub, decode_step, init_generation_state, prefill, write_mask_shape)

    cfg = cfg or TINY_LLAMA
    params_cpu = init_params(cfg, seed=0, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    for mode in modes:
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
                 if write_inject(pol) else None for _ in range(TINY_STEPS)]
        read_masks = flip_mask((cfg.num_layers, 2, 2, 21, cfg.num_kv_heads, cfg.head_dim), BER,
                               4, gen) if read else None
        seeds = torch.randint(-2 ** 31, 2 ** 31, (TINY_STEPS,), generator=gen).tolist()
        runs = {}
        for dev in ("cpu", device):
            params = map_tree(lambda _, t, dev=dev: t.to(dev), params_cpu)
            state, bt, _ = init_generation_state(cfg, pol, 2, 32, 16, device=dev)
            logits, state = prefill(params, ids.to(dev), state, bt, cfg, pol0,
                                    read_masks=None if read_masks is None else read_masks.to(dev))
            seq, toks = [logits.cpu()], []
            for m, seed in zip(masks, seeds):
                toks.append(torch.argmax(logits, -1).cpu())
                logits, state = decode_step(params, torch.argmax(logits, -1), state, bt, cfg, pol,
                                            block_size=16,
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
        say(f"  {cfg.name} {mode}: max |logits card - logits cpu| = {err:.3e} (tolerance 1e-2); "
            f"NaN logits {int(nan.sum())} on the cpu, at the same places on the card: {same_nan}; "
            f"tokens {'identical' if torch.equal(tc, tg) else 'DIFFER'}"
            + (f"; ECC counts card {[c.tolist() for c in cg]}, cpu {[c.tolist() for c in cc]}"
               if stats else ""))
        if not err <= 1e-2 or not same_nan or not torch.equal(tc, tg) or not same_counts:
            fail(f"{cfg.name} {mode}: the card disagrees with the CPU")


# the kernel benchmark's shapes (benchmarks/harness.py run_full_benchmark's
# defaults): n values through K5, K6 and K9, n // 3 Golay words through K7;
# its time_fn_chained makes 3 warm-up and 20 timed calls of each function
HARNESS_N = 8 * 1024 * 1024
CHAINED_CALLS = 3 + 20
# the kernels/sass_count.py probe of each codec row (its integer bound)
CODEC_PROBES = {"hamming74_encode": "h74_encode", "hamming74_decode": "h74_decode",
                "hamming84_encode": "h84_encode", "hamming84_decode": "h84_decode",
                "golay_encode_packed": "golay_encode", "golay_decode_packed": "golay_decode",
                "golay_write_scrub": "golay_scrub", "inject_bit_errors": "inject"}
# (JSON name, wrapper, the TPU function it replaces) of K5-K9
CODEC_KERNELS = (
    ("hamming74_encode (K5)", "hamming74_encode", "codec_kernels.py:99"),
    ("hamming74_decode (K5)", "hamming74_decode", "codec_kernels.py:105"),
    ("hamming84_encode (K6)", "hamming84_encode", "codec_kernels.py:130"),
    ("hamming84_decode (K6)", "hamming84_decode", "codec_kernels.py:136"),
    ("golay_encode (K7)", "golay_encode_packed", "codec_kernels.py:159"),
    ("golay_decode (K7)", "golay_decode_packed", "codec_kernels.py:168"),
    ("golay_write_scrub (K8)", "golay_write_scrub", "codec_kernels.py:191"),
    ("inject_bit_errors (K9)", "inject_bit_errors", "codec_kernels.py:251"),
)


def golay_error_patterns(torch, gen, device):
    """Every 24-bit error pattern of weight 0-3 (2325), 4000 of weight 4,
    and 256 random words with bits 24-31 set, as int32 on the card."""
    from itertools import combinations

    pats = [0] + [sum(1 << b for b in bits) for w in (1, 2, 3)
                  for bits in combinations(range(24), w)]
    pats = torch.tensor(pats, dtype=torch.int64, device=device)
    w4 = torch.rand((4000, 24), generator=gen, device=device).argsort(dim=1)[:, :4]
    w4 = (torch.ones_like(w4) << w4).sum(dim=1)
    wide = torch.randint(1 << 24, 1 << 32, (256,), generator=gen, device=device,
                         dtype=torch.int64)
    pats = torch.cat([pats, w4, wide])
    return (pats - ((pats >> 31) << 32)).to(torch.int32)


def codec_kernel_check(torch, gen, device):
    """K5-K9 against their plain versions with torch.equal on the card,
    dtypes included: every byte through K5 and K6 (and random bytes in an
    odd shape, 40M random bytes: two passes and more of the grid-stride
    loop, and inputs at every byte offset 0-15 of lengths 1, 5, 15, 16, 17
    and 16k + 5: the vector path's edges and the one-byte path), all 4096
    Golay data words and random int32 words through K7's encode (also
    slices of them not 16-byte aligned or not a multiple of 4 words long),
    256 codewords under every error pattern of weight 0-3, 4000 of weight 4
    and 256 words with bits 24-31 set through its decode, then every one of
    the 2^24 received words (each error count as often as the code has it)
    and 4M random words; K7's decode and K8 at word offsets 0-3 of lengths
    1, 3, 4, 5 and 4k + 1; K8 on 8M / 3 random int32 words with random masks
    (BER 0.12 over 32 bits, and every bit random) and on every data word
    under 256 masks each (BER 0.05 over 24 bits, and every bit random), K9
    on 16M uint8 values (n_bits 8) and 4M int32 words
    (n_bits 24) at BER 1e-2: equal to the plain version, its flip rate
    within 1% of the BER, the same flips for the same seed and others for
    the next. Then the kernel benchmark's own inputs at its size (8M values;
    8M / 3 Golay words: several passes of the Golay grid-stride loop over
    at most 132 x 4 blocks of 256 threads, 4 words each), made as
    benchmarks/harness.py makes them:
    seed-0 nibbles through both Hamming encodes, their codewords through
    the decodes clean and with flips at BER 1e-2, seed-0 triplets through
    the Golay triplet wrappers (encode, decode clean and with flips), K9 on
    8M zeros, and the card-against-CPU row's 4M seed-0 bytes through K6's
    decode. Each wrapper's launches must equal the calls made. Returns the
    largest difference from the plain version measured on each kernel, by
    the wrapper names of CODEC_KERNELS (0 where the kernel is right)."""
    import numpy as np

    from qkv_ecc_tpu_torch.benchmarks import harness
    from qkv_ecc_tpu_torch.codecs.reference import golay_pack, golay_unpack
    from qkv_ecc_tpu_torch.kernels import codec_kernels as ck
    from qkv_ecc_tpu_torch.kernels.common import popcount

    reset_counts(*ck.WRAPPERS)
    calls = {w: 0 for w in ck.WRAPPERS}
    errs = {key: 0 for _, key, _ in CODEC_KERNELS}
    thr = min(int(BER * 2 ** 32), 0xFFFFFFFF)

    def diff(got, want, name):
        """The largest |got - want| over the outputs; fails unless the
        kernel's outputs equal the plain version's, dtypes and shapes too."""
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        d = 0
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name}: the kernel's dtype or shape differs from its plain version")
            d = max(d, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
            if not torch.equal(g, w):
                fail(f"{name}: the kernel differs from its plain version by up to {d}")
        return d

    def check(key, wrapper, plain, *args):
        """wrapper(*args) against plain(*args); key names the counted
        wrapper (the triplet wrappers launch through the packed ones)."""
        got = wrapper(*args)
        calls[getattr(ck, key + "_cuda")] += 1
        torch.cuda.synchronize()
        errs[key] = max(errs[key], diff(got, plain(*args), wrapper.__name__))
        return got if isinstance(got, tuple) else (got,)

    def codec(name, *args):
        return check(name, getattr(ck, name + "_cuda"), getattr(ck, name + "_plain"), *args)

    u8, i32 = torch.uint8, torch.int32
    every_byte = torch.arange(256, dtype=i32, device=device).to(u8)
    odd = torch.randint(0, 256, (3, 1001, 7), generator=gen, device=device, dtype=u8)
    hamming = ("hamming74_encode", "hamming74_decode", "hamming84_encode", "hamming84_decode")
    for name in hamming:
        for x in (every_byte, odd):
            codec(name, x)
    # the vector paths' edges: x at every byte offset of a 16-byte vector
    # (at 1-15: every byte one a thread), lengths below, at and around one
    # vector and 16k + 5
    lengths = (1, 5, 15, 16, 17, 16 * 4099 + 5)
    base = torch.randint(0, 256, (max(lengths) + 16,), generator=gen, device=device, dtype=u8)
    for name in hamming:
        for off in range(16):
            for n in lengths:
                codec(name, base[off:off + n])
    # 40M bytes: more than one pass of the grid-stride loop (132 x 16 blocks
    # of 256 threads, 16 bytes each: 8.65M bytes a pass)
    many = torch.randint(0, 256, (40 << 20,), generator=gen, device=device, dtype=u8)
    for name in hamming:
        codec(name, many)
    del many
    say(f"  K5, K6: every byte, 21021 and 40M random bytes, and inputs at byte offsets 0-15 of "
        f"lengths {lengths}, equal to the plain versions")

    words = torch.cat([torch.arange(4096, dtype=i32, device=device),
                       torch.randint(-2 ** 31, 2 ** 31, (4096,), generator=gen, device=device,
                                     dtype=torch.int64).to(i32)])
    cw = check("golay_encode_packed", ck.golay_encode_packed_cuda, ck.golay_encode_plain,
               words)[0][:4096]
    # inputs not 16-byte aligned (the encode's one-word path) and short tails
    for x in (words[1:], words[3:4102], words[:4099], words[2:5]):
        check("golay_encode_packed", ck.golay_encode_packed_cuda, ck.golay_encode_plain, x)
    pats = golay_error_patterns(torch, gen, device)
    sample = cw[torch.randperm(4096, generator=gen, device=device)[:256]]
    rx = sample[:, None] ^ pats[None, :]  # [256, 6581]
    _, count = check("golay_decode_packed", ck.golay_decode_packed_cuda, ck.golay_decode_plain,
                     rx)
    hist = torch.bincount(count.reshape(-1), minlength=5).tolist()
    if any(h == 0 for h in hist):
        fail(f"golay decode: error counts {hist} miss a weight")
    say(f"  K7: 8192 words encoded (and slices of them not 16-byte aligned or not a multiple "
        f"of 4 long), {rx.numel()} received words decoded equal to the plain version (error "
        f"counts 0-4: {hist})")
    # every 24-bit received word (bits 24-31 clear), then 4M with them set
    every_cw = torch.arange(1 << 24, dtype=i32, device=device)
    _, count = check("golay_decode_packed", ck.golay_decode_packed_cuda, ck.golay_decode_plain,
                     every_cw)
    hist = torch.bincount(count, minlength=5).tolist()
    if hist[:4] != [4096, 4096 * 24, 4096 * 276, 4096 * 2024]:
        fail(f"golay decode: error counts {hist} over every word are not the code's")
    del every_cw, count
    wide = torch.randint(-2 ** 31, 2 ** 31, (4 << 20,), generator=gen, device=device,
                         dtype=torch.int64).to(i32)
    check("golay_decode_packed", ck.golay_decode_packed_cuda, ck.golay_decode_plain, wide)
    # the vector paths' edges: x (and K8's mask) at word offsets 0-3,
    # lengths below, at and around one vector and 4k + 1
    lengths = (1, 3, 4, 5, 4 * 4099 + 1)
    n_edge = max(lengths) + 4
    base = ck.golay_encode_plain(torch.randint(0, 4096, (n_edge,), generator=gen, device=device,
                                               dtype=i32))
    base = base ^ ck.inject_bit_errors_plain(torch.zeros_like(base), int(0.1 * 2 ** 32), 32, 3)
    masks = torch.randint(-2 ** 31, 2 ** 31, (n_edge,), generator=gen, device=device,
                          dtype=torch.int64).to(i32)
    for off in range(4):
        for n in lengths:
            check("golay_decode_packed", ck.golay_decode_packed_cuda, ck.golay_decode_plain,
                  base[off:off + n])
            for moff in (0, (off + 1) % 4):
                codec("golay_write_scrub", base[off:off + n], masks[moff:moff + n])
    say(f"  K7: every one of the 2^24 received words decoded equal to the plain version "
        f"(error counts 0-4: {hist}), and 4M random words with bits 24-31 set; K7's decode and "
        f"K8 at word offsets 0-3 of lengths {lengths} (K8's mask at offset 0 or another)")

    m = HARNESS_N // 3
    data = torch.randint(-2 ** 31, 2 ** 31, (m,), generator=gen, device=device,
                         dtype=torch.int64).to(i32)
    sparse = torch.zeros((m,), dtype=torch.int64, device=device)
    for b in range(32):
        sparse |= (torch.rand((m,), generator=gen, device=device) < 0.12).to(torch.int64) << b
    sparse = (sparse - ((sparse >> 31) << 32)).to(i32)
    dense = torch.randint(-2 ** 31, 2 ** 31, (m,), generator=gen, device=device,
                          dtype=torch.int64).to(i32)
    for mask in (sparse, dense):
        codec("golay_write_scrub", data, mask)
    # every data word under 256 random masks each, at BER 0.05 over 24 bits
    # (mostly correctable) and every bit random (mostly not)
    every_d = torch.arange(4096, dtype=i32, device=device).repeat(256)
    few = torch.zeros(every_d.shape, dtype=torch.int64, device=device)
    for b in range(24):
        few |= (torch.rand(every_d.shape, generator=gen, device=device) < 0.05).to(
            torch.int64) << b
    all_bits = torch.randint(-2 ** 31, 2 ** 31, every_d.shape, generator=gen, device=device,
                             dtype=torch.int64).to(i32)
    for mask in (few.to(i32), all_bits):
        codec("golay_write_scrub", every_d, mask)
    say(f"  K8: 2 x {m} random words and 2 x every data word x 256 masks scrubbed equal to the "
        "plain version (masks over 32 bits, and over 24 bits at BER 0.05)")

    for dtype, n, n_bits in ((u8, 16 << 20, 8), (i32, 4 << 20, 24)):
        hi = 256 if dtype == u8 else 1 << 24
        x = torch.randint(0, hi, (n,), generator=gen, device=device, dtype=torch.int64).to(dtype)
        out = ck.inject_bit_errors_cuda(x, BER, n_bits, 42)
        again = ck.inject_bit_errors_cuda(x, BER, n_bits, 42)
        other = ck.inject_bit_errors_cuda(x, BER, n_bits, 43)
        calls[ck.inject_bit_errors_cuda] += 3
        torch.cuda.synchronize()
        errs["inject_bit_errors"] = max(errs["inject_bit_errors"], diff(
            out, ck.inject_bit_errors_plain(x, thr, n_bits, 42), f"inject_bit_errors {dtype}"))
        if out.dtype != dtype:
            fail(f"inject_bit_errors {dtype}: the kernel returns {out.dtype}")
        flips_diff = out.to(i32) ^ x.to(i32)
        flips = int(popcount(flips_diff).sum())
        rate = flips / (n * n_bits)
        if abs(rate - BER) > 0.01 * BER or int((flips_diff >> n_bits).abs().sum()) != 0:
            fail(f"inject_bit_errors {dtype}: flip rate {rate} not within 1% of {BER}, or "
                 "flips above n_bits")
        if not torch.equal(out, again) or torch.equal(out, other):
            fail(f"inject_bit_errors {dtype}: not deterministic per seed")
        say(f"  K9 {str(dtype)[6:]} n={n} n_bits={n_bits}: equal to the plain version; "
            f"{flips} flips, rate {rate:.6f} (BER {BER}, band 1%); seed 42 twice equal, "
            "seed 43 differs")

    # the kernel benchmark's inputs at its size
    n = HARNESS_N
    vals = harness._values(n, device)
    for code in ("hamming74", "hamming84"):
        cw = codec(code + "_encode", vals)[0]
        codec(code + "_decode", cw)
        codec(code + "_decode", ck.inject_bit_errors_plain(cw, thr, 8, 1))
    trip = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (m, 3), dtype=np.uint8)).to(
        device)

    def golay_decode_triplets(c):
        data12, count = ck.golay_decode_plain(c)
        return golay_unpack(data12), count

    cw = check("golay_encode_packed", ck.golay_encode_cuda,
               lambda t: ck.golay_encode_plain(golay_pack(t)), trip)[0]
    check("golay_decode_packed", ck.golay_decode_cuda, golay_decode_triplets, cw)
    _, count = check("golay_decode_packed", ck.golay_decode_cuda, golay_decode_triplets,
                     ck.inject_bit_errors_plain(cw, thr, 24, 1))
    hist = torch.bincount(count.reshape(-1), minlength=5).tolist()
    check("inject_bit_errors", ck.inject_bit_errors_cuda,
          lambda d, *_: ck.inject_bit_errors_plain(d, thr, 8, 42),
          torch.zeros(n, dtype=u8, device=device), BER, 8, 42)
    cpu_row = torch.from_numpy(np.random.default_rng(0).integers(0, 256, n // 2, dtype=np.uint8))
    codec("hamming84_decode", cpu_row.to(device))
    say(f"  the kernel benchmark's inputs: {n} seed-0 nibbles through K5 and K6 (encode, decode "
        f"clean and at BER {BER}), {m} seed-0 triplets through K7 (encode, decode clean and at "
        f"BER {BER}: error counts 0-4 {hist}), K9 on {n} zeros, K6's decode on {n // 2} seed-0 "
        "bytes: equal to the plain versions")

    for w, k in calls.items():
        say(f"  {w.__name__}: launches {w.launches} (expected {k}, one per call)")
        if w.launches != k:
            fail(f"{w.__name__}: {w.launches} launches for {k} calls")
    say("  largest difference from the plain version, by kernel: " + json.dumps(errs))
    return errs


def group4_check(torch, gen):
    """K4 at the kernel benchmark's GQA group 4 (32 query heads over 8 KV
    heads, head_dim 128: new instances in all three kernels) on
    harness.build_decode_attention_case's random caches at each of the
    attention suite's shapes (batch 1 and 8, context 512 and 2048, its fp32
    query; at batch 8 and context 2048 a bf16 query too) in every codec -
    hamming84 with and without interpolation, hamming74 and golay with ECC
    statistics, int4, fp16 and fp8 - against attend_plain on the same
    inputs. Returns the largest error by K4 branch (the keys of the kernel
    table: read for int4's extract read, k4-fp16 and k4-fp8 for the float
    reads)."""
    from qkv_ecc_tpu_torch.benchmarks.harness import build_decode_attention_case
    from qkv_ecc_tpu_torch.kernels.paged_attention import attend_plain, paged_attention_ecc

    worst = {}
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    for codec, interp, key in (("hamming84", False, "hamming84"),
                               ("hamming84", True, "hamming84-interp"),
                               ("hamming74", False, "hamming74"), ("golay", False, "golay"),
                               ("int4", False, "read"), ("fp16", False, "k4-fp16"),
                               ("fp8", False, "k4-fp8")):
        for batch, ctx_len in ((1, 512), (1, 2048), (8, 512), (8, 2048)):
            case, cache, bt, ctx, _ = build_decode_attention_case(batch=batch,
                                                                  context_len=ctx_len,
                                                                  codec=codec)
            parity = () if "k_parity" not in cache else (cache["k_parity"], cache["v_parity"])
            stats = bool(parity)
            qdtypes = (torch.float32, torch.bfloat16) if (batch, ctx_len) == (8, 2048) else (
                torch.float32,)
            for qdtype in qdtypes:
                q = case.to(qdtype)
                out = paged_attention_ecc(q, *(cache[n] for n in names), bt, ctx, 0, *parity,
                                          codec=codec, use_interpolation=interp,
                                          collect_stats=stats)
                torch.cuda.synchronize()
                ref = attend_plain(q, *(cache[n] for n in names), bt, ctx, 0, *parity,
                                   codec=codec, sm_scale=128 ** -0.5, num_pages=bt.shape[1],
                                   pages_per_chunk=min(4, bt.shape[1]), interpolate=interp,
                                   collect_stats=stats)
                label = (f"paged_attention_ecc group 4 {codec}{' interp' if interp else ''} "
                         f"batch {batch} ctx {ctx_len} q={str(qdtype)[6:]}")
                if codec in ("fp16", "fp8"):
                    err = check_float(label, out, ref)
                elif stats:
                    err = check_outputs(label, out[0], ref[0], {}, {}, (), out[1], ref[1])
                else:
                    err = check_outputs(label, out, ref, {}, {}, ())
                worst[key] = max(worst.get(key, 0.0), err)
    return worst


def harness_phase(torch, smi):
    """benchmarks.harness.run_full_benchmark() at the JAX defaults on the
    card (n = 8M; the attention suite: K4 hamming84 at 32 query heads over 8
    KV heads, head_dim 128, batch 1 and 8, context 512 and 2048); prints its
    JSON and checks its rows and every kernel's launches. Returns the
    launches by (wrapper, branch)."""
    from qkv_ecc_tpu_torch.benchmarks import harness
    from qkv_ecc_tpu_torch.evaluation.constants import compute_bandwidth_efficiency

    reset_counts(*kernel_wrappers())
    res = harness.run_full_benchmark()
    torch.cuda.synchronize()
    say("  run_full_benchmark(): " + json.dumps(res))
    for r in res["kernels"]:
        if not (r["time_ms"] > 0 and r["mvalues_per_sec"] > 0):
            fail(f"harness row {r['name']}: no time")
        eff = compute_bandwidth_efficiency(r["mvalues_per_sec"], r["bytes_per_value"])
        say(f"  {r['name']}: {r['time_ms'] * 1e3:.2f} us per chained call, "
            f"{r['mvalues_per_sec']:.1f} Mvalues/s, {r['gb_per_sec']:.1f} GB/s, {eff:.1f}% of "
            f"the H100's 3352 GB/s ({smi})")
    cpu = res["cpu_vs_accelerator"]
    if cpu["accel_platform"] != "cuda" or not cpu.get("speedup", 0) > 0:
        fail("harness: no card-against-CPU hamming84 decode row")
    say(f"  hamming84 decode of {cpu['n_values']} values: card {cpu['accel_ms']:.3f} ms, "
        f"CPU {cpu['cpu_ms']:.1f} ms, {cpu['speedup']:.1f}x ({smi})")
    if len(res["attention"]) != 4:
        fail("harness: the attention suite did not give 4 rows")
    for r in res["attention"]:
        if not (r["ecc_attention_ms"] > 0 and r["sdpa_baseline_ms"] > 0):
            fail("harness: an attention row has no time")
        say(f"  attention {r['codec']} batch {r['batch']} ctx {r['context_len']}: K4 "
            f"{r['ecc_attention_ms'] * 1e3:.2f} us, SDPA {r['sdpa_baseline_ms'] * 1e3:.2f} us, "
            f"overhead {r['overhead_ratio']:.2f}x, {r['decode_tokens_per_sec']:.0f} tokens/s "
            f"({smi})")
    per = CHAINED_CALLS
    expected = {
        # an encode before the decode's timing, the chained calls of each
        ("hamming84_encode_cuda", "hamming84_encode"): 1 + per,
        # and the card-against-CPU row's 3 + 10 chained decodes
        ("hamming84_decode_cuda", "hamming84_decode"): per + 3 + 10,
        ("hamming74_encode_cuda", "hamming74_encode"): 1 + per,
        ("hamming74_decode_cuda", "hamming74_decode"): per,
        ("golay_encode_packed_cuda", "golay_encode"): 1 + per,
        ("golay_decode_packed_cuda", "golay_decode"): per,
        ("golay_write_scrub_cuda", "golay_write_scrub"): 0,
        ("inject_bit_errors_cuda", "uint8"): per,
        ("inject_bit_errors_cuda", "int32"): 0,
        ("paged_attention_ecc", "hamming84"): 4 * per,
    }
    got = {}
    for w in kernel_wrappers():
        for branch, n in w.launches_by.items():
            got[(w.__name__, branch)] = n
    check_launches("harness", {
        f"{name} {branch}": (n, expected.get((name, branch), 0),
                             "calls made" if (name, branch) in expected else "none")
        for (name, branch), n in got.items()})
    return got


def scaling_phase(torch, smi):
    """benchmarks.scaling.measure_single_device on bench-0.9b in
    int12-golay (BER 1e-2): batch 4, prompt 64, 20 steps after 5 warm-up
    steps, block 128, on the card; K1's read must launch once per layer and
    step. Returns the row and the launches."""
    from qkv_ecc_tpu_torch.benchmarks.scaling import measure_single_device
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode

    reset_counts(write_attend, write_decode_attend)
    pol = policy_for_mode("int12-golay", ber=BER, seed=42)
    row = measure_single_device(cfg, pol, batch=4, prompt_len=64, steps=20, block_size=128)
    if not (row["ms_per_step"] > 0 and row["tokens_per_s"] > 0):
        fail("scaling: no time")
    say(f"  measure_single_device(bench-0.9b, int12-golay, BER {BER}, batch 4, prompt 64, 20 "
        f"steps, block 128): {json.dumps(row)} ({smi})")
    steps = cfg.num_layers * (5 + 20)
    check_launches("scaling", {
        "write_attend read": (write_attend.launches_by["read"], steps,
                              f"{cfg.num_layers} layers x (5 + 20) steps"),
        "write_attend other branches": (write_attend.launches - write_attend.launches_by["read"],
                                        0, "none"),
        "decode_attend": (write_decode_attend.launches, 0, "none")})
    return row, write_attend.launches_by["read"]


def codec_cases(torch, gen, device, ck):
    """K5-K9's inputs at the kernel benchmark's shapes (8M values, 8M / 3
    Golay words; K8, which has no caller there, on the Golay words with
    masks of BER 1e-2 over 24 bits; K9 on uint8 values, n_bits 8), 8 copies
    each (64-270 MB, beyond the 50 MB L2), for the wrappers of module ck.
    Returns {wrapper name: (inputs per copy, bytes moved, probe units,
    library call or None, its label)}: the library calls compute the same
    function with index_select from the table of all 256 (Hamming, indices
    held as int32) or 4096 (Golay) codewords, and the Hamming decodes with
    two index_selects from 256-entry data and flag tables."""
    n, m, copies = HARNESS_N, HARNESS_N // 3, 8
    u8, i32 = torch.uint8, torch.int32
    vals = [torch.randint(0, 16, (n,), generator=gen, device=device, dtype=u8)
            for _ in range(copies)]
    idx = [v.to(i32) for v in vals]
    bytes_ = [torch.randint(0, 256, (n,), generator=gen, device=device, dtype=u8)
              for _ in range(copies)]
    idx_b = [b.to(i32) for b in bytes_]
    words = [torch.randint(0, 4096, (m,), generator=gen, device=device, dtype=i32)
             for _ in range(copies)]
    zeros = torch.zeros((m,), dtype=i32, device=device)
    masks = [ck.inject_bit_errors_plain(zeros, int(BER * 2 ** 32), 24, s) for s in range(copies)]
    cws = [ck.golay_encode_plain(w) ^ k for w, k in zip(words, masks)]
    every = torch.arange(4096, dtype=i32, device=device)
    lut_g = ck.golay_encode_plain(every)
    lut = {name: getattr(ck, name + "_plain")(every[:256].to(u8))
           for name in ("hamming74_encode", "hamming84_encode", "hamming74_decode",
                        "hamming84_decode")}

    def encode_call(name):
        return lambda i: torch.index_select(lut[name], 0, idx[i])

    def decode_call(name):
        return lambda i: tuple(torch.index_select(t, 0, idx_b[i]) for t in lut[name])

    table = "index_select from the codeword table"
    two = "two index_select calls, from the 256-entry data and flag tables"
    return {
        "hamming74_encode": ([(v,) for v in vals], 2 * n, n, encode_call("hamming74_encode"),
                             table),
        "hamming74_decode": ([(b,) for b in bytes_], 3 * n, n, decode_call("hamming74_decode"),
                             two),
        "hamming84_encode": ([(v,) for v in vals], 2 * n, n, encode_call("hamming84_encode"),
                             table),
        "hamming84_decode": ([(b,) for b in bytes_], 3 * n, n, decode_call("hamming84_decode"),
                             two),
        "golay_encode_packed": ([(w,) for w in words], 8 * m, m,
                                lambda i: torch.index_select(lut_g, 0, words[i]), table),
        "golay_decode_packed": ([(c,) for c in cws], 12 * m, m, None, None),
        "golay_write_scrub": (list(zip(words, masks)), 12 * m, m, None, None),
        "inject_bit_errors": ([(v, BER, 8, 42) for v in vals], 2 * n, 8 * n, None, None),
    }


def codec_timing(torch, gen, device, smi, sass, sms, clock):
    """K5-K9 at codec_cases' shapes, each cycling its 8 copies: device time
    behind a sleep (device_ms), the plain version's time, the bound (bytes
    at 3.35 TB/s), the integer bound from the SASS of the codec's probe
    (kernels/sass_count.py: sass, the probes' counts; sms and clock, the
    card's) and the library call where one computes the same function.
    The redesigned rows (those in REQUIRED_US) must meet their required
    times.
    Returns the timings by wrapper name."""
    from qkv_ecc_tpu_torch.kernels import codec_kernels as ck
    from qkv_ecc_tpu_torch.kernels import sass_count

    thr = min(int(BER * 2 ** 32), 0xFFFFFFFF)
    plains = {"golay_encode_packed": ck.golay_encode_plain,
              "golay_decode_packed": ck.golay_decode_plain,
              "inject_bit_errors": lambda x, ber, n_bits, seed: ck.inject_bit_errors_plain(
                  x, thr, n_bits, seed)}
    timings = {}
    for name, (inputs, nbytes, units, library, lib_label) in codec_cases(
            torch, gen, device, ck).items():
        wrapper = getattr(ck, name + "_cuda")
        plain = plains.get(name) or getattr(ck, name + "_plain")
        call = lambda i, w=wrapper, a=inputs: w(*a[i])  # noqa: E731
        ms = min(device_ms(torch, call, 240, len(inputs), wrapper),
                 device_ms(torch, call, 240, len(inputs), wrapper))
        plain_ms = timed(torch, lambda i, p=plain, a=inputs: p(*a[i]), 24, len(inputs))
        library_ms = (None if library is None else
                      device_ms(torch, library, 240, len(inputs), None))
        b_ms, b_by, _, _ = bound(nbytes, 0)
        probe = CODEC_PROBES[name]
        int_ms, pipe = sass_count.int_bound_ms(sass[probe], units, sms, clock)
        unit = sass_count.PROBES[probe][3]
        say(f"  {name}: {ms * 1e3:.2f} us/launch on the device (CUDA events, calls queued "
            f"behind a sleep); bound {b_ms * 1e3:.2f} us by {b_by} ({nbytes / 1e6:.2f} MB at "
            f"3.35 TB/s; no fp32 operations); share of bound {b_ms / ms:.3f}; integer bound "
            f"{int_ms * 1e3:.2f} us by the {pipe} pipe ({units / 1e6:.2f} M {unit}s, "
            f"{sass[probe]['issue']:.2f} SASS instructions a {unit}), share {int_ms / ms:.3f}; "
            f"plain version {plain_ms * 1e3:.1f} us; library call: "
            + ("none" if library_ms is None else f"{library_ms * 1e3:.2f} us ({lib_label})")
            + f" ({smi})")
        timings[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                             library_ms=library_ms, int_bound_ms=int_ms)
        if name in REQUIRED_US:
            req, target = REQUIRED_US[name], TARGET_US[name]
            met = ms * 1e3 <= req
            say(f"  {name}: {ms * 1e3:.2f} us; required at most {req:.1f} us: "
                f"{'met' if met else 'MISSED'}; target at most {target:.1f} us: "
                f"{'met' if ms * 1e3 <= target else 'missed'} ({smi})")
            if not met:
                fail(f"{name}: {ms * 1e3:.2f} us misses the required {req:.1f} us")
    return timings


def trace_decode(torch, params, ids, gen, device, smi, cfg=None, steps=4):
    """Device busy share of the decode step of cfg (default bench-0.9b) on
    the prompt ids: torch.profiler over `steps` steps of each arm, kernel
    time summed over the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.runtime import decode_loop, init_generation_state, prefill

    cfg = cfg or BENCH_0_9B
    for mode in MODES:
        pol = policy_for_mode(mode, ber=BER, seed=42)
        state, bt, _ = init_generation_state(cfg, pol, BATCH, ids.shape[1] + 8, device=device)
        logits, state = prefill(params, ids, state, bt, cfg, pol, gen)
        logits, state, _ = decode_loop(params, logits, state, bt, cfg, pol, gen, 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            decode_loop(params, logits, state, bt, cfg, pol, gen, steps)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels)
        attend = {name: sum(e.time_range.elapsed_us() for e in kernels if name in e.name)
                  for name in ("write_attend_kernel", "decode_attend_kernel",
                               "float_attend_kernel")}
        if not kernels or busy <= 0:
            say(f"  {cfg.name} {mode}: device time not measured (the profiler recorded no device "
                "events)")
            continue
        per = 1e3 * steps  # us over the window -> ms a step
        say(f"  {cfg.name} {mode} (profiled, {steps} steps): {wall_us / per:.3f} ms/step wall, "
            f"{len(kernels) / steps:.0f} device kernels/step, device busy {busy / per:.3f} "
            f"ms/step ({100 * busy / wall_us:.1f}% of wall, idle "
            f"{100 - 100 * busy / wall_us:.1f}%), write_attend "
            f"{attend['write_attend_kernel'] / per:.3f} ms/step, decode_attend "
            f"{attend['decode_attend_kernel'] / per:.3f} ms/step, float_attend "
            f"{attend['float_attend_kernel'] / per:.3f} ms/step ({smi})")


# gpt2 (124M, qkv_ecc_tpu/models/config.py:41): 12/12 heads at head_dim 64,
# float32 as in the JAX package, random weights from seed 0; its decode runs
# the kernel instances of group 1, head_dim 64. Contexts after the write at
# its kernel checks: 1 to 1024 tokens (its position table), partial last
# pages, row 3 at 1 (a -1 page in the checks that take one)
GPT2_CTX_BEFORE = [1000, 1022, 1023, 0, 511, 512, 777, 895]
GPT2_K4_CTX = [1024, 1000, 1023, 1, 512, 0, 778, 897]  # row 5 empty
GPT2_PROMPT = 896
GPT2_STATS_STEPS = 8
# the forward/loss path's modes, batch and tokens per row
LOSS_MODES = ("fp16", "int4", "int4-hamming84", "int4-hamming", "int12-golay")
LOSS_BATCH, LOSS_TOKENS = 4, 1024
# the largest |logit| difference allowed between the forward's logits and
# the decode steps' at BER 0. Measured first on the CPU, where the plain
# versions stand in for the kernels (gpt2's widths, 2 to 6 layers, prompts
# of 128 to 512, 8 to 16 steps): 7.8e-4 to 2.5e-3 in fp16, int4-hamming84,
# int12-golay and int4-write-inject, on logits up to 3.1. The reason: the
# decode's read rounds q and every weight p * v_scale to bf16 (precision
# "fast", 2^-9 relative a weight) where the forward attends in float32;
# the card adds its split's per-block rounding and another order of the
# float32 sums. 1e-2 is 4x the largest measured
GPT2_FORWARD_TOL = 1e-2

# the kernel instances of group 1, head_dim 32 (trained-tiny: 8/8 heads,
# its position table 512). Contexts after the write at its kernel checks: 1
# to 512 tokens, partial last pages, row 3 at 1 (a -1 page in the checks
# that take one); its float read is checked at FLOAT_CTX, where the NaN
# slots are placed. The instances are timed on caches of TINY_TIME_CTX
# tokens a row (a 448-token prompt and 32 steps), every layer cycled
TINY_CTX_BEFORE = [500, 510, 511, 0, 255, 256, 377, 447]
TINY_K4_CTX = [512, 500, 511, 1, 256, 0, 378, 449]  # row 5 empty
TINY_TIME_CTX = 480

# the training path (training/, the train_tiny CLI): trained-tiny at full
# width through the CLI (40-65 s on the card), the
# tolerances of the card against the CPU (the gradient of one batch, a leaf's
# largest difference over its largest |g|; one update, a leaf's update in
# relative L2 norm), the
# generation demo's modes and new tokens, and trained-100m's few steps
TRAIN_STEPS = 1000
TRAIN_GRAD_RTOL = 2e-3  # measured on an H100: 9.3e-4 (wpe)
TRAIN_STEP_RTOL = 1e-2  # measured on an H100: 1.9e-3 (layer 0's c_attn/w)
GEN_MODES = ("int4", "int4-hamming", "int4-hamming84", "int4-hamming84-interp", "int12-golay",
             "fp16", "fp8")
GEN_TOKENS = 32
TRAIN_100M_STEPS, TRAIN_100M_CORPUS_MB = 10, 2
# the experiment CLIs' results: the JAX package's keys
LATENCY_KEYS = ("codec", "shape", "n_values", "encode_ms", "decode_ms", "total_ms_mean",
                "total_ms_std", "throughput_mvalues_sec", "transfer_overhead_pct",
                "bandwidth_efficiency_pct")
QUANT_ECC_KEYS = ("backend", "ecc", "ber", "quant_mse", "post_ecc_mse", "mse_amplification",
                  "errors_corrected", "errors_detected")
ARCH_KEYS = ("model", "arch", "kv_projection", "num_heads", "num_kv_heads", "gqa_ratio",
             "head_dim", "kv_values_per_token", "positional")
TPU_EVAL_KEYS = ("mode", "ber", "ppl_mean", "ppl_std", "n_seeds", "errors_corrected_mean")
FT_THROUGHPUT_KEYS = ("codec", "ber", "batch", "decode_tokens_per_sec", "ms_per_token",
                      "cache_bytes", "cache_gb", "overhead_vs_unprotected")
FT_PPL_KEYS = ("arm", "ber", "ppl_mean", "ppl_values")
FT_GRID_KEYS = ("codec", "ber", "batch", "decode_tokens_per_sec", "ms_per_token", "cache_bytes",
                "cache_gb", "arm", "context_len", "memory")
FT_MEMORY_KEYS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit", "live_array_bytes")


# The quality path (M7): run_sweep's forwards through kv_policy.process_kv,
# which launch no kernel, as JAX's. gpt2 at full width (random weights from
# seed 0, synthetic texts) over the seven cache modes at BER 0 and 1e-2; and
# trained-tiny through the Monte-Carlo CLI at the TPU run's config, against
# that run's JSON
QUALITY_TEXTS, QUALITY_MAX_LENGTH = 4, 1024
TINY_CHECKPOINT = "results/trained_tiny/checkpoint.npz"
TPU_RUN_JSON = "results/trained_tiny_tpu/monte_carlo_results.json"
# the floors of the trained-tiny comparison, set from the largest difference
# between the JAX package's CLI on a CPU and the TPU run at the same config,
# BER 0, seed 42 (python -m qkv_ecc_tpu.evaluation.experiments.monte_carlo
# --model trained-tiny --require-checkpoint --ber-levels 0 --seeds 42, its
# other flags at their defaults, the TPU run's): perplexity 2.06e-3 relative
# (int4: 2.194447 against 2.189945; the TPU rounds float32 matmuls through
# bfloat16 passes), KL 1.15e-4 (fp8: 0.002027 against 0.002142), top-5
# 1.18e-3 (int4: 0.930588 against 0.931765). Each floor is 2.4-4.3x that:
# relative for perplexity, absolute for KL and top-5
QUALITY_FLOORS = {"ppl": 5e-3, "kl_divergence": 5e-4, "top5_accuracy": 5e-3}
# a protected mode's correction rate: every text of one length shares its
# flips (the masks are drawn per seed, layer, K/V and shape), so a trial's
# detections come in multiples of the texts; its floor is 4 Poisson sigmas
# of the TPU run's distinct detections, sqrt(d + 1) with d its mean
# detections over the texts, as a rate
QUALITY_SIGMAS = 4


def kernel_wrappers():
    """Every kernel wrapper with a launch count."""
    from qkv_ecc_tpu_torch.kernels import codec_kernels as ck
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc, paged_attention_ecc_write_attend, write_decode_attend)

    return (*ck.WRAPPERS, paged_attention_ecc, paged_attention_ecc_write_attend,
            write_decode_attend)


def check_no_launches(path):
    """The quality path runs the forward, which launches no kernel."""
    check_launches(path, {f"{w.__name__} (all branches)": (w.launches, 0, "none: the forward "
                                                            "path runs no kernel, as JAX's")
                          for w in kernel_wrappers()})


def top5_card_check(torch, device):
    """metrics.top5_indices on the card picks what jax.lax.top_k picks: NaN
    above every number, equal values by lower index."""
    from qkv_ecc_tpu_torch.evaluation.metrics import top5_indices

    nan = float("nan")
    rows = torch.zeros((3, 16), device=device)
    rows[0] = nan
    rows[1, [9, 4]] = 2.0
    rows[2, 3], rows[2, 12], rows[2, 7] = nan, 5.0, 5.0
    got = top5_indices(rows).tolist()
    want = [[0, 1, 2, 3, 4], [4, 9, 0, 1, 2], [3, 7, 12, 0, 1]]
    if got != want:
        fail(f"top5_indices on the card: {got}, jax.lax.top_k's order is {want}")


def flip_bits(cfg, pol, total_values):
    """The bits a trial's loss pass exposed to flips: written codeword bits
    (fp8: the stored bytes), or int4's read nibble bits."""
    from qkv_ecc_tpu_torch.models.kv_policy import N_BITS, codeword_shape

    rows = total_values // cfg.head_dim
    per_row = codeword_shape(pol.codec, (cfg.head_dim,), cfg.head_dim)[0]
    return rows * per_row * (4 if pol.inject_at == "read" else N_BITS[pol.codec])


def draws_nest(torch, sizes, device):
    """Whether torch's generator on ``device`` gives each flat index of a
    draw the same value whatever the draw's size, for draws of ``sizes``
    from one seed (so the masks of two padded lengths share the shorter's
    draws)."""
    draws = [torch.rand(n, generator=torch.Generator(device=device).manual_seed(7),
                        device=device) for n in sorted(sizes)]
    return all(torch.equal(a, b[:a.numel()]) for a, b in zip(draws, draws[1:]))


def counted_flip_sigma(cfg, pol, lengths, ber, nest):
    """The std of a trial's bits_flipped over texts of padded ``lengths``:
    the texts of one length share their flips (one draw a seed, layer and
    K/V), and two lengths share the draws of the shorter where the draws
    ``nest``, else none."""
    per_token = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
    bits = {g: flip_bits(cfg, pol, g * per_token) for g in set(lengths)}
    shared = sum(min(bits[g], bits[h]) if nest or g == h else 0
                 for g in lengths for h in lengths)
    return (shared * ber * (1 - ber)) ** 0.5


@contextlib.contextmanager
def counted_forwards():
    """Counts the quality path's forwards (each a batch of texts or windows
    of one length): yields a list whose length is the count so far."""
    from qkv_ecc_tpu_torch.evaluation import metrics

    calls, real = [], metrics.forward_jit

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    metrics.forward_jit = counted
    try:
        yield calls
    finally:
        metrics.forward_jit = real


def quality_gpt2_phase(torch, device, smi):
    """run_sweep on gpt2 (124M, full width, random weights from seed 0 via
    evaluation.models.load_model) over the seven cache modes x BER {0,
    1e-2} x seed 42, on QUALITY_TEXTS synthetic texts at max_length 1024,
    KL, top-5 and the catastrophic pass on. Checks: every trial's
    total_values is the K/V of its padded texts; at BER 0 nothing is
    counted and the four int4 codes give int4's perplexity exactly; at
    1e-2 each mode's bits_flipped is within 4 sigma of BER x the bits (the
    sigma of texts that share their flips: counted_flip_sigma), the protected modes
    correct; every perplexity is finite but fp8's at 1e-2, whose NaN bytes
    may leave no finite loss (inf, as in JAX)."""
    from qkv_ecc_tpu_torch.evaluation.constants import CACHE_MODE_ORDER
    from qkv_ecc_tpu_torch.evaluation.data import load_wikitext2_test, pad_to_bucket, tokenize
    from qkv_ecc_tpu_torch.evaluation.metrics import generate_clean_logits
    from qkv_ecc_tpu_torch.evaluation.models import load_model
    from qkv_ecc_tpu_torch.evaluation.sweep import SweepConfig, run_sweep
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode

    top5_card_check(torch, device)
    params, cfg, tok = load_model("gpt2", device=device)
    texts = load_wikitext2_test(QUALITY_TEXTS)
    ids = [tokenize(tok, t, QUALITY_MAX_LENGTH) for t in texts]
    padded = [pad_to_bucket(i)[0].shape[1] for i in ids]
    t = time.perf_counter()
    clean = generate_clean_logits(params, cfg, tok, texts, max_length=QUALITY_MAX_LENGTH)
    torch.cuda.synchronize()
    say(f"  quality gpt2: {len(texts)} synthetic texts of {[i.shape[1] for i in ids]} tokens "
        f"(padded {padded}); clean logits [L, {cfg.vocab_size}] float32 kept on the card, "
        f"{sum(c.numel() * 4 for c in clean) / 1e9:.3f} GB, in {time.perf_counter() - t:.3f} s")
    stamps, counts = [], []
    sc = SweepConfig(cache_modes=list(CACHE_MODE_ORDER), ber_levels=[0, BER], seeds=[42],
                     max_length=QUALITY_MAX_LENGTH, clean_logits=clean)
    with counted_forwards() as calls:
        def progress(desc, cur, total):
            stamps.append(time.perf_counter())
            counts.append(len(calls))

        t0 = time.perf_counter()
        res = run_sweep(params, cfg, tok, texts, sc, progress)
        stamps.append(time.perf_counter())
        counts.append(len(calls))
    per_token = cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim
    values = sum(padded) * per_token
    # the draws of one (layer, K/V) at the shortest and longest padded length
    nest = draws_nest(torch, [8 * min(padded) * cfg.num_kv_heads * cfg.head_dim,
                              8 * max(padded) * cfg.num_kv_heads * cfg.head_dim], device)
    say(f"  quality gpt2: the card's draws of two padded lengths from one seed "
        f"{'share the shorter one' if nest else 'share nothing'} (the flips' sigma counts "
        f"that)")
    by = {(tr.cache_mode, tr.ber): tr for tr in res.trials}
    for i, tr in enumerate(res.trials):
        dt, n = stamps[i + 1] - stamps[i], counts[i + 1] - counts[i]
        pol = policy_for_mode(tr.cache_mode, ber=tr.ber, seed=tr.seed)
        line = (f"  quality gpt2 {tr.cache_mode} BER {tr.ber}: ppl {tr.perplexity:.6f}, KL "
                f"{tr.kl_divergence:.6f}, top-5 {tr.top5_accuracy:.6f}, catastrophic "
                f"{tr.catastrophic_rate}, corrected {tr.errors_corrected}, detected "
                f"{tr.errors_detected}, flipped {tr.bits_flipped}")
        nan_bytes = tr.cache_mode == "fp8" and tr.ber > 0
        if not math.isfinite(tr.perplexity) and not nan_bytes:
            fail(f"quality gpt2 {tr.cache_mode} BER {tr.ber}: perplexity {tr.perplexity}")
        if tr.total_values != values and not nan_bytes:
            fail(f"quality gpt2 {tr.cache_mode} BER {tr.ber}: total_values {tr.total_values}, "
                 f"the padded texts' K/V hold {values}")
        if tr.ber == 0 and (tr.errors_corrected or tr.errors_detected or tr.bits_flipped):
            fail(f"quality gpt2 {tr.cache_mode} BER 0: something was counted")
        if tr.ber and pol.codec != "fp16" and tr.total_values == 0:
            line += " (no text had a finite loss: nothing counted, as in JAX)"
        elif tr.ber and pol.codec != "fp16":
            # the texts counted: all, or (fp8) those whose loss is finite
            counted = next((c for r in range(len(padded), 0, -1)
                            for c in itertools.combinations(padded, r)
                            if sum(c) * per_token == tr.total_values), None)
            if counted is None:
                fail(f"quality gpt2 {tr.cache_mode} BER {tr.ber}: total_values "
                     f"{tr.total_values} is the K/V of no subset of the texts")
            bits = flip_bits(cfg, pol, tr.total_values)
            sigma = counted_flip_sigma(cfg, pol, counted, tr.ber, nest)
            z = (tr.bits_flipped - tr.ber * bits) / sigma
            line += f" of {bits} bits ({z:+.2f} sigma over texts of padded {list(counted)})"
            if abs(z) > 4:
                fail(f"quality gpt2 {tr.cache_mode}: bits_flipped {z:+.2f} sigma from BER x bits")
            if pol.codec in ("hamming74", "hamming84", "golay") and not tr.errors_corrected > 0:
                fail(f"quality gpt2 {tr.cache_mode} BER {tr.ber}: nothing corrected")
        say(line + f"; {dt:.3f} s, {n} forwards, {1e3 * dt / n:.2f} ms a forward ({smi})")
    int4 = by[("int4", 0)].perplexity
    for mode in ("int4-hamming", "int4-hamming84", "int4-hamming84-interp", "int12-golay"):
        if by[(mode, 0)].perplexity != int4:
            fail(f"quality gpt2 {mode} BER 0: ppl {by[(mode, 0)].perplexity!r} against int4's "
                 f"{int4!r}")
    total, n = stamps[-1] - t0, counts[-1]
    say(f"  quality gpt2: {len(res.trials)} trials in {total:.3f} s, {total / len(res.trials):.3f} "
        f"s a trial, {n} forwards (batches of the texts of one length), {1e3 * total / n:.2f} ms "
        f"a forward; the int4 codes' ppl at BER 0 equal int4's {int4!r} ({smi})")
    del params, clean


def quality_band(metric, tpu, port, ber, n_texts):
    """(allowed |port - TPU| of a mean, the floor) for one metric of one
    (mode, BER) cell: 4 sigma of the difference of two means of n trials,
    never below the metric's floor."""
    tm, ts, ps = tpu[f"{metric}_mean"], tpu[f"{metric}_std"], port[f"{metric}_std"]
    if metric == "ppl":
        floor = QUALITY_FLOORS["ppl"] * abs(tm)
    elif metric == "correction_rate":
        c, d = tpu["errors_corrected_mean"], tpu["errors_detected_mean"]
        floor = (QUALITY_SIGMAS * n_texts * (d / n_texts + 1) ** 0.5 / (c + d)) if c + d else 0.0
    else:
        floor = QUALITY_FLOORS[metric]
    if not ber:
        return floor, floor
    n = tpu["n_trials"]
    return max(QUALITY_SIGMAS * ((ts ** 2 + ps ** 2) / n) ** 0.5, floor), floor


def quality_tiny_phase(torch, smi):
    """The Monte-Carlo CLI (evaluation/experiments/monte_carlo.py main) on
    trained-tiny at the TPU run's config (results/trained_tiny_tpu: the
    seven modes x BER {0, 1e-4, 1e-3, 1e-2} x seeds {42, 101, 997}, 20
    texts, max_length 256, stride 128, KL, top-5 and the catastrophic pass
    on) into a temporary directory, on the card, and its means against the
    TPU run's: at BER 0 perplexity, KL and top-5 within their floors
    (QUALITY_FLOORS); at BER > 0 perplexity, KL, top-5 and the correction
    rate within 4 sigma of the difference of the two means of 3 seeds,
    never below the floor; inf where the TPU has inf and only there.
    Without the checkpoint or the TPU run's JSON in this copy it prints
    that and returns None."""
    import io
    import os
    import tempfile

    for path in (TINY_CHECKPOINT, TPU_RUN_JSON):
        if not os.path.exists(path):
            say(f"  quality trained-tiny: not run: {path} is absent from this copy")
            return None
    from qkv_ecc_tpu_torch.evaluation.constants import BER_LEVELS, DEFAULT_CONFIG
    from qkv_ecc_tpu_torch.evaluation.experiments.monte_carlo import main as monte_carlo

    with open(TPU_RUN_JSON) as fh:
        tpu = json.load(fh)
    cfg = tpu["config"]
    if cfg["ber_levels"] != BER_LEVELS or cfg["stride"] != DEFAULT_CONFIG["stride"]:
        fail(f"quality trained-tiny: the TPU run's config {cfg} is not the CLI's defaults")
    with tempfile.TemporaryDirectory() as out:
        # no --ber-levels: the default BER_LEVELS is the TPU run's, keyed as
        # its JSON keys them ("0" for the int 0)
        argv = ["--model", "trained-tiny", "--require-checkpoint", "--output-dir", out,
                "--seeds", *map(str, cfg["seeds"]), "--max-samples", str(cfg["max_samples"]),
                "--max-length", str(cfg["max_length"]), "--cache-modes", *cfg["cache_modes"]]
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), counted_forwards() as calls:
            monte_carlo(argv)
        wall = time.perf_counter() - t
        with open(os.path.join(out, "monte_carlo_results.json")) as fh:
            port = json.load(fh)
        files = sorted(os.path.relpath(os.path.join(d, f), out)
                       for d, _, fs in os.walk(out) for f in fs)
    n_trials, texts = len(port["trials"]), cfg["max_samples"]
    rows = sum(shape[0] for shape in calls)
    say(f"  quality trained-tiny: the CLI ran {n_trials} trials in {wall:.1f} s (loading and the "
        f"clean logits included): {wall / n_trials:.3f} s a trial; {len(calls)} forwards of "
        f"{rows} texts or windows of <= {cfg['max_length']} tokens, {1e3 * wall / len(calls):.2f} "
        f"ms a forward; it wrote {files} ({smi})")
    if port.keys() != tpu.keys() or port["config"] != cfg or \
            port["trials"][0].keys() != tpu["trials"][0].keys():
        fail("quality trained-tiny: the JSON's keys or config differ from the TPU run's")
    worst, failures, near = {}, [], []

    def seeds(run, mode, ber, field):
        return [round(t[field], 6) for t in run["trials"]
                if t["cache_mode"] == mode and t["ber"] == ber]

    say(f"  quality trained-tiny by mode and BER: port (this card)|TPU run, mean +-std over "
        f"{len(cfg['seeds'])} seeds, d = |port - TPU| <= the allowed difference (f: its floor)")
    for mode in cfg["cache_modes"]:
        for key, t_agg in tpu["aggregated"][mode].items():
            p_agg = port["aggregated"][mode].get(key)
            if p_agg is None:
                fail(f"quality trained-tiny: no {mode} BER {key} in the port's JSON")
            ber = t_agg["ber"]
            cells = []
            for metric in ("ppl", "kl_divergence", "top5_accuracy", "correction_rate"):
                if not ber and metric == "correction_rate":
                    continue
                tm, pm = t_agg[f"{metric}_mean"], p_agg[f"{metric}_mean"]
                ps = p_agg[f"{metric}_std"]
                allowed, floor = quality_band(metric, t_agg, p_agg, ber, texts)
                if math.isinf(tm) or math.isinf(pm):
                    ok, d = tm == pm, 0.0
                else:
                    d = abs(pm - tm)
                    ok = d <= allowed
                    worst[metric] = max(worst.get(metric, 0.0), d / allowed if allowed else 0.0)
                cells.append(f"{metric.split('_')[0]} {pm:.4f}|{tm:.4f} "
                             f"+-{ps:.4f}|{t_agg[f'{metric}_std']:.4f} d {d:.1e}<="
                             f"{allowed:.1e}{'f' if allowed == floor else ''}"
                             f"{'' if ok else ' FAILED'}")
                if not ok:
                    failures.append(f"{mode} BER {key} {metric}")
                if not ok or (allowed and d / allowed > 0.5):
                    field = "perplexity" if metric == "ppl" else metric
                    near.append(f"{mode} BER {key} {metric} by seed: port "
                                f"{seeds(port, mode, ber, field)}, TPU {seeds(tpu, mode, ber, field)}")
            say(f"    {mode:<21} {key:<6} " + "; ".join(cells)
                + f"; corr/det {p_agg['errors_corrected_mean']:.0f}/"
                f"{p_agg['errors_detected_mean']:.0f}|{t_agg['errors_corrected_mean']:.0f}/"
                f"{t_agg['errors_detected_mean']:.0f}; cat {p_agg['catastrophic_rate_mean']:.3f}|"
                f"{t_agg['catastrophic_rate_mean']:.3f}")
    for line in near:
        say(f"    {line} (over half its allowed difference)")
    say("  quality trained-tiny: largest share of the allowed difference: "
        + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()) + f" ({smi})")
    if failures:
        fail(f"quality trained-tiny: {len(failures)} means outside their band against the TPU "
             f"run: " + ", ".join(failures[:8]))
    return wall


def gpt2_attention_cfg():
    """gpt2's attention shapes (two layers of cache)."""
    import dataclasses
    from qkv_ecc_tpu_torch.models.config import GPT2_124M

    return dataclasses.replace(GPT2_124M, num_layers=2)


def unbuilt_shape_check(torch, device):
    """A shape without kernel instances raises on the card rather than
    running the plain version: group 1 at head_dim 96, which no registered
    model has (tiny-gpt2's head_dim 16, this check's shape before, has its
    instances), in the extract read, the correcting read and the float
    read."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc_write_attend
    from qkv_ecc_tpu_torch.models.config import MODEL_CONFIGS, TINY_GPT2
    from qkv_ecc_tpu_torch.models.kv_policy import KVCachePolicy
    from qkv_ecc_tpu_torch.models.runtime import init_generation_state

    cfg = dataclasses.replace(TINY_GPT2, name="unregistered", head_dim=96, hidden_size=384)
    if any((c.num_kv_groups, c.head_dim) == (1, 96) for c in MODEL_CONFIGS.values()):
        fail("unbuilt_shape_check: a registered model has group 1 at head_dim 96")
    B, H, D = 2, cfg.num_kv_heads, cfg.head_dim
    for codec, scrub in (("int4", True), ("hamming84", False), ("fp16", False)):
        state, bt, _ = init_generation_state(cfg, KVCachePolicy(codec=codec), B, 32, 16,
                                             device=device)
        q = torch.zeros((B, cfg.num_heads, D), device=device)
        dw = state["k_cache"].shape[3] + (0 if scrub or codec == "fp16"
                                          else state["k_parity"].shape[3])
        new = torch.zeros((B, H, dw), dtype=state["k_cache"].dtype, device=device)
        ones = torch.ones((B, H), device=device)
        parity = () if scrub or codec == "fp16" else (state["k_parity"], state["v_parity"])
        try:
            paged_attention_ecc_write_attend(
                q, new, new, ones, ones, state["k_cache"], state["v_cache"], state["k_scales"],
                state["v_scales"], bt, torch.ones((B,), dtype=torch.int32, device=device), 0,
                *parity, codec=codec, scrub=scrub, block_size=16)
        except ValueError as e:
            if "has no kernel instance" not in str(e):
                raise
            say(f"  group 1 at head_dim 96 (no registered model) {codec} on the card raises: "
                f"{str(e)[:160]}...")
            continue
        fail(f"{cfg.name} {codec}: a shape without kernel instances did not raise")


def tiny_attention_cfg():
    """trained-tiny's attention shapes (two layers of cache)."""
    import dataclasses
    from qkv_ecc_tpu_torch.models.config import TRAINED_TINY

    return dataclasses.replace(TRAINED_TINY, num_layers=2)


def group1_kernel_check(torch, gen, device, cfg, ctx_before, k4_ctx):
    """The kernel instances of cfg's attention shape (group 1) against
    their plain versions (B 8, block 128, float32 queries as the decode
    passes them, contexts ctx_before + 1 with partial last pages), at the S
    the split rule picks: K1's extract read (kernel_check), K2 hamming84,
    hamming74 and golay and K3 with and without stats
    (decode_kernel_check), K2r (read_inject_check), K2f fp16 and fp8
    (float_kernel_check_at) and the K4 reads of every branch at k4_ctx
    (attend_check). Returns the largest error of each branch, keyed as the
    kernels' table."""
    f32 = torch.float32
    worst = {"read": kernel_check(torch, gen, device, cfg, ctx_before)}
    worst.update(decode_kernel_check(torch, gen, device, cfg, ctx_before, f32))
    worst["read-inject"] = read_inject_check(torch, gen, device, cfg, ctx_before, f32)
    for (codec, kind), err in float_kernel_check_at(torch, gen, device, cfg, 128).items():
        worst[codec if kind == "write" else "k4-" + codec] = err
    for branch, err in attend_check(torch, gen, device, cfg, k4_ctx, f32).items():
        key = "k4-" + ("read" if branch == "extract" else branch)
        worst[key] = max(worst.get(key, 0.0), err)
    return worst


def gpt2_kernel_check(torch, gen, device):
    """The kernel instances of group 1, head_dim 64 at gpt2's attention
    shapes (12/12 heads, contexts GPT2_CTX_BEFORE + 1: 1 to 1024 tokens;
    group1_kernel_check)."""
    return group1_kernel_check(torch, gen, device, gpt2_attention_cfg(), GPT2_CTX_BEFORE,
                               GPT2_K4_CTX)


def tiny_kernel_check(torch, gen, device):
    """The kernel instances of group 1, head_dim 32 at trained-tiny's
    attention shapes (8/8 heads, contexts TINY_CTX_BEFORE + 1: 1 to 512
    tokens; group1_kernel_check), output_tolerance's row term scaled to a
    64-value row (ROW_TERM_SCALE). Its golay split at S = 1, the rule's and
    3 runs in split_check."""
    global ROW_TERM_SCALE
    ROW_TERM_SCALE = math.sqrt(math.log(64) / math.log(32))
    try:
        return group1_kernel_check(torch, gen, device, tiny_attention_cfg(), TINY_CTX_BEFORE,
                                   TINY_K4_CTX)
    finally:
        ROW_TERM_SCALE = 1.0


# contexts after the write: rows 0-3 end on a page holding 1 token (129,
# 513, 1025, 1), rows 4-7 on a full page (128, 512, 1024, 256)
EDGE_CTX_BEFORE = [128, 512, 1024, 0, 127, 511, 1023, 255]
# K4's: the same kinds, row 3 (ctx 1) on a page of -1 and row 5 empty
EDGE_K4_CTX = [129, 513, 1025, 1, 128, 0, 512, 1024]


def page_edge_check(torch, gen, device):
    """The packed kernels at contexts whose last page holds 1 token and at
    contexts that fill their last page exactly, at head_dim 128 (bench-0.9b,
    bf16 queries), 64 (gpt2) and 32 (trained-tiny, ROW_TERM_SCALE as in
    tiny_kernel_check), float32 queries for group 1 as its decode passes
    them: K1's extract read in every codec (kernel_check), K2 and K3 with
    and without stats and a -1 page (decode_kernel_check), K2r with its
    window and empty row (read_inject_check) and every K4 branch with the
    softmax state and F4 (attend_check), each against its plain version."""
    global ROW_TERM_SCALE
    for cfg, scale, qdtype in ((bench_attention_cfg(), 1.0, torch.bfloat16),
                               (gpt2_attention_cfg(), 1.0, torch.float32),
                               (tiny_attention_cfg(), math.sqrt(math.log(64) / math.log(32)),
                                torch.float32)):
        ROW_TERM_SCALE = scale
        try:
            kernel_check(torch, gen, device, cfg, EDGE_CTX_BEFORE)
            decode_kernel_check(torch, gen, device, cfg, EDGE_CTX_BEFORE, qdtype)
            read_inject_check(torch, gen, device, cfg, EDGE_CTX_BEFORE, qdtype)
            attend_check(torch, gen, device, cfg, EDGE_K4_CTX, qdtype)
        finally:
            ROW_TERM_SCALE = 1.0


def gpt2_decode_phase(torch, params, ids, device, smi):
    """gpt2's decode: batch 8, a 896-token prompt, 32 greedy steps at BER
    1e-2 in the eight arms (MODES), one round after a warm-up of each; then
    decode_loop(collect_ecc_stats=True) for 8 steps in golay, hamming74 and
    hamming84 without scrub (K2 at the new instances), whose counts must
    show corrections (and detections, but for hamming74). Each branch's
    launches are checked: layers x steps x its arms. Returns (the runs, the
    stats runs, the launches by branch of both)."""
    import dataclasses

    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.models.config import GPT2_124M as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.runtime import decode_loop, init_generation_state, prefill

    for mode in MODES:  # warm-up of every arm, before the counted run
        pol = policy_for_mode(mode, ber=BER, seed=42)
        st, bt, _ = init_generation_state(cfg, pol, BATCH, 256, device=device)
        g = torch.Generator(device=device).manual_seed(1)
        lg, st = prefill(params, ids[:, :128], st, bt, cfg, pol, g)
        decode_loop(params, lg, st, bt, cfg, pol, g, 2)
    torch.cuda.synchronize()
    reset_counts(write_attend, write_decode_attend)
    runs = {}
    for mode in MODES:
        pol = policy_for_mode(mode, ber=BER, seed=42)
        g = torch.Generator(device=device).manual_seed(42)
        state, bt, _ = init_generation_state(cfg, pol, BATCH, GPT2_PROMPT + STEPS, device=device)
        t = time.perf_counter()
        logits, state = prefill(params, ids, state, bt, cfg, pol, g)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t
        t = time.perf_counter()
        logits, state, toks = decode_loop(params, logits, state, bt, cfg, pol, g, STEPS)
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t
        finite_rows = int(torch.isfinite(logits).all(dim=-1).sum())
        if logits.shape != (BATCH, cfg.vocab_size) or (finite_rows < BATCH and mode != "fp8"):
            fail(f"gpt2 {mode}: logits not finite or of the wrong shape")
        if toks.shape != (STEPS, BATCH) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"gpt2 {mode}: tokens out of range")
        if state["context_len"].tolist() != [GPT2_PROMPT + STEPS] * BATCH:
            fail(f"gpt2 {mode}: context lengths did not advance")
        runs[mode] = dict(state=state, bt=bt, prefill_s=t_prefill, ms_step=1e3 * t_decode / STEPS,
                          tok_s=BATCH * STEPS / t_decode, finite_rows=finite_rows)
    launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
    per_arm = cfg.num_layers * STEPS
    how = f"{cfg.num_layers} layers x {STEPS} steps x"
    check_launches("gpt2 decode", {
        "write_attend read": (launches[0]["read"], per_arm * 4,
                              f"{how} 4 arms (the scrubbed ones)"),
        "write_attend read-inject": (launches[0]["read-inject"], per_arm, f"{how} 1 arm (int4)"),
        "write_attend fp16 (K2f)": (launches[0]["fp16"], per_arm, f"{how} 1 arm (fp16)"),
        "write_attend fp8 (K2f)": (launches[0]["fp8"], per_arm, f"{how} 1 arm (fp8)"),
        "decode_attend hamming84-interp": (launches[1]["hamming84-interp"], per_arm,
                                           f"{how} 1 arm (int4-hamming84-interp)"),
        "decode_attend other branches": (write_decode_attend.launches
                                         - launches[1]["hamming84-interp"], 0, "none"),
    })
    base = runs[BASELINE]["tok_s"]
    for mode, r in runs.items():
        say(f"  gpt2 {mode}: prefill {r['prefill_s']:.3f} s, decode {r['ms_step']:.3f} ms/step, "
            f"{r['tok_s']:.1f} tokens/s, {r['tok_s'] / base:.4f} x int4-write-inject's tokens/s "
            f"(batch {BATCH}, ctx {GPT2_PROMPT}+{STEPS}, BER {BER}; last logits finite in "
            f"{r['finite_rows']} of {BATCH} rows; {smi})")
    # a step reads every weight once (the tied head all of wte) except wpe,
    # of which it reads one row a token
    wbytes = sum(t.numel() * t.element_size()
                 for d in [{"wte": params["wte"]}, params["ln_f"]]
                 + [d for lp in params["layers"] for d in lp.values()] for t in d.values())
    say(f"  gpt2 weights read per decode step: {wbytes / 1e9:.3f} GB, "
        f"{1e3 * wbytes / PEAK_BYTES_PER_S:.3f} ms at 3.35 TB/s")

    reset_counts(write_attend, write_decode_attend)
    stats_runs = {}
    for mode in ("int12-golay", "int4-hamming", "int4-hamming84"):
        pol = dataclasses.replace(policy_for_mode(mode, ber=BER, seed=42), scrub=False)
        g = torch.Generator(device=device).manual_seed(7)
        state, bt, _ = init_generation_state(cfg, pol, BATCH, GPT2_PROMPT + GPT2_STATS_STEPS,
                                             device=device)
        logits, state = prefill(params, ids, state, bt, cfg, pol, g)
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, state, _ = decode_loop(params, logits, state, bt, cfg, pol, g, GPT2_STATS_STEPS,
                                       collect_ecc_stats=True)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / GPT2_STATS_STEPS
        corr, det = int(state["ecc_corrected"].sum()), int(state["ecc_detected"].sum())
        say(f"  gpt2 stats {mode} scrub=False: {ms:.3f} ms/step over {GPT2_STATS_STEPS} steps; "
            f"summed over the batch: corrected {corr}, detected {det} ({smi})")
        if not torch.isfinite(logits).all() or not (corr > 0 and (pol.codec == "hamming74"
                                                                  or det > 0)):
            fail(f"gpt2 stats {mode}: logits not finite or counts not what the cache's errors make")
        stats_runs[mode] = dict(state=state, bt=bt)
    stats_launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
    per_stats_arm = cfg.num_layers * GPT2_STATS_STEPS
    check_launches("gpt2 stats", {
        f"decode_attend {k}": (v, per_stats_arm if k in ("golay", "hamming74", "hamming84") else 0,
                               f"{cfg.num_layers} layers x {GPT2_STATS_STEPS} steps x 1 arm"
                               if k in ("golay", "hamming74", "hamming84") else "none")
        for k, v in stats_launches[1].items()} | {
        f"write_attend {k}": (v, 0, "none") for k, v in stats_launches[0].items()})
    both = tuple({k: a[k] + b[k] for k in a} for a, b in zip(launches, stats_launches))
    return runs, stats_runs, both


def gpt2_loss_phase(torch, params, device, smi):
    """registry.loss_and_stats on batch 4 x 1024 tokens (labels = ids) in
    LOSS_MODES at BER 0 and 1e-2. At BER 0 every int4-code mode's loss
    equals int4's bit for bit and counts nothing; at BER 1e-2 each mode's
    bits_flipped is within 5 sigma of BER x the bits written (int4: read),
    golay corrects, and every loss is finite."""
    from qkv_ecc_tpu_torch.models.config import GPT2_124M as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import loss_and_stats

    g = torch.Generator(device=device).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (LOSS_BATCH, LOSS_TOKENS), generator=g, device=device)
    res = {}
    for ber in (0.0, BER):
        for mode in LOSS_MODES:
            pol = policy_for_mode(mode, ber=ber, seed=42)
            t = time.perf_counter()
            mean, count, logits, stats = loss_and_stats(params, ids, ids, cfg, pol)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            counts = {k: int(v) for k, v in stats.items()}
            res[(mode, ber)] = (mean.item(), int(count), counts)
            del logits
            line = (f"  gpt2 loss {mode} BER {ber}: loss {mean.item():.6f} over {int(count)} "
                    f"targets; counts {counts}; {dt:.3f} s (batch {LOSS_BATCH} x {LOSS_TOKENS} "
                    f"tokens")
            if ber and pol.codec != "fp16":
                # the bits of the batch it was given, not the program's count
                values = LOSS_BATCH * LOSS_TOKENS * cfg.num_layers * 2 * cfg.num_kv_heads \
                    * cfg.head_dim
                if counts["total_values"] != values:
                    fail(f"gpt2 loss {mode}: total_values {counts['total_values']}, the batch's "
                         f"K/V hold {values}")
                bits = flip_bits(cfg, pol, values)
                sigma = (bits * ber * (1 - ber)) ** 0.5
                z = (counts["bits_flipped"] - ber * bits) / sigma
                line += f"; {bits} bits {'read' if pol.inject_at == 'read' else 'written'}, " \
                        f"flipped {counts['bits_flipped']}: {z:+.2f} sigma from BER x bits"
                if abs(z) > 5:
                    fail(f"gpt2 loss {mode}: bits_flipped {z:+.2f} sigma from BER x bits")
            say(line + f"; {smi})")
            if not torch.isfinite(mean):
                fail(f"gpt2 loss {mode} BER {ber}: the loss is not finite")
    int4_loss = res[("int4", 0.0)][0]
    for mode in LOSS_MODES[1:]:
        loss, _, counts = res[(mode, 0.0)]
        if loss != int4_loss or any(counts[k] for k in ("errors_corrected", "errors_detected",
                                                         "bits_flipped")):
            fail(f"gpt2 loss {mode} at BER 0: {loss!r} against int4's {int4_loss!r}, counts "
                 f"{counts}")
    if not res[("int12-golay", BER)][2]["errors_corrected"] > 0:
        fail("gpt2 loss int12-golay at BER 1e-2: nothing corrected")
    say(f"  gpt2 loss at BER 0: int4-hamming84, int4-hamming and int12-golay equal int4's "
        f"{int4_loss!r} bit for bit, with zero counts")


def gpt2_forward_check(torch, params, ids, device, smi):
    """The forward against the kernel path at BER 0, in fp16 and
    int4-hamming84: the decode steps' logits (prefill's at position 895,
    then 31 steps') against loss_and_stats' logits on the prompt plus the
    32 generated tokens at positions 895-926, within GPT2_FORWARD_TOL."""
    from qkv_ecc_tpu_torch.models.config import GPT2_124M as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import loss_and_stats
    from qkv_ecc_tpu_torch.models.runtime import decode_step, init_generation_state, prefill

    for mode in ("fp16", "int4-hamming84"):
        pol = policy_for_mode(mode, ber=0.0, seed=42)
        state, bt, _ = init_generation_state(cfg, pol, BATCH, GPT2_PROMPT + STEPS, device=device)
        logits, state = prefill(params, ids, state, bt, cfg, pol)
        seq, toks = [logits], []
        for step in range(STEPS):
            toks.append(torch.argmax(logits, dim=-1))
            if step < STEPS - 1:
                logits, state = decode_step(params, toks[-1], state, bt, cfg, pol)
                seq.append(logits)
        full = torch.cat([ids, torch.stack(toks, dim=1)], dim=1)
        _, _, flog, _ = loss_and_stats(params, full, full, cfg, pol)
        ref = flog[:, GPT2_PROMPT - 1:GPT2_PROMPT - 1 + STEPS]
        err = (torch.stack(seq, dim=1) - ref).abs().max().item()
        del flog, ref
        say(f"  gpt2 forward against the decode steps, {mode} BER 0: max |logit difference| "
            f"{err:.3e} over positions {GPT2_PROMPT - 1}-{GPT2_PROMPT + STEPS - 2} (tolerance "
            f"{GPT2_FORWARD_TOL}; {smi})")
        if not err <= GPT2_FORWARD_TOL:
            fail(f"gpt2 forward {mode}: the forward's logits differ from the decode's by {err}")


def gpt2_serve_and_sample(torch, params, device):
    """serve_ber0_check on gpt2, and generate() at temperature 0.8: the
    same tokens twice for one seed, others for another."""
    from qkv_ecc_tpu_torch.models.config import GPT2_124M as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.runtime import generate

    serve_ber0_check(torch, device, cfg, params)
    pol = policy_for_mode("int4-hamming84", ber=BER, seed=42)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(5))
    a, b, c = (generate(params, ids, cfg, pol, 8, 128, 0.8, seed, device=device)
               for seed in (1, 1, 2))
    same, other = torch.equal(a, b), not torch.equal(a, c)
    say(f"  gpt2 generate at temperature 0.8: seed 1 twice {'identical' if same else 'DIFFER'}; "
        f"seed 2 {'differs' if other else 'IDENTICAL'}")
    if not (same and other):
        fail("gpt2 sampled generate: not deterministic per seed, or blind to it")


def gpt2_kernel_times(torch, runs, stats_runs, device, smi, cfg=None):
    """Device time of each group-1 instance's write+attend at cfg's decode
    shapes (default gpt2's: batch 8, 12/12 heads at head_dim 64, ctx 928 or
    904 of the decode and stats runs' caches; float32 queries, every layer
    cycled), beside its plain version's, its bytes bound at 3.35 TB/s (each
    live token's K and V words and scales once, the query, the new rows and
    the output) and, for fp16, scaled_dot_product_attention over the same
    context stored dense (bf16 query). Returns each branch's times keyed as
    the kernels' table."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        gather_pages, paged_attention_ecc_write_attend as write_attend, write_attend_plain,
        write_decode_attend, write_decode_attend_plain)
    from qkv_ecc_tpu_torch.models.config import GPT2_124M

    cfg = cfg or GPT2_124M
    times = {}

    Hkv, D, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    q = torch.randn((BATCH, cfg.num_heads, D), generator=torch.Generator(device=device)
                    .manual_seed(9), device=device)
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    sn = torch.ones((BATCH, Hkv), device=device)
    for key, codec, src, kw in (
            ("read", "golay", runs["int12-golay"], dict(scrub=True)),
            ("read-inject", "int4", runs["int4"], dict(read_inject_ber=BER, read_inject_seed=5)),
            ("hamming84-interp", "hamming84", runs["int4-hamming84-interp"],
             dict(use_interpolation=True)),
            ("hamming84", "hamming84", stats_runs["int4-hamming84"], {}),
            ("hamming74", "hamming74", stats_runs["int4-hamming"], {}),
            ("golay", "golay", stats_runs["int12-golay"], {}),
            ("fp16", "fp16", runs["fp16"], {}), ("fp8", "fp8", runs["fp8"], {})):
        state, bt = src["state"], src["bt"]
        ctx = state["context_len"].clone()
        extract = codec in ("int4", "fp16", "fp8") or kw.get("scrub")
        parity = () if extract else (state["k_parity"], state["v_parity"])
        words = state["k_cache"].shape[3] + (0 if extract else parity[0].shape[3])
        elem = 4 if codec not in ("fp16", "fp8") else state["k_cache"].element_size()
        new = torch.zeros((BATCH, Hkv, words), dtype=state["k_cache"].dtype, device=device)
        wrapper = write_attend if extract else write_decode_attend

        def call(layer, state=state, bt=bt, ctx=ctx, parity=parity, new=new, codec=codec, kw=kw):
            return write_attend(q, new, new, sn, sn, *(state[n] for n in names), bt, ctx, layer,
                                *parity, codec=codec, **kw)

        def plain(layer, state=state, bt=bt, ctx=ctx, parity=parity, new=new, codec=codec, kw=kw,
                  extract=extract):
            args = (q, new, new, sn, sn, *(state[n] for n in names), bt, ctx, layer, *parity)
            if extract:
                return write_attend_plain(
                    *args, sm_scale=D ** -0.5, pages_per_chunk=4,
                    codec=codec if codec in ("fp16", "fp8") else "int4",
                    read_threshold=int(BER * 2 ** 32) if "read_inject_ber" in kw else None,
                    read_seed=kw.get("read_inject_seed", 0))
            return write_decode_attend_plain(*args, codec=codec, sm_scale=D ** -0.5,
                                             interpolate=kw.get("use_interpolation", False),
                                             pages_per_chunk=4)

        ms = min(device_ms(torch, call, 240, L, wrapper), device_ms(torch, call, 240, L, wrapper))
        plain_ms = timed(torch, plain, 12, L)
        library_ms = None
        if codec == "fp16":
            T = int(ctx.max())
            dense = [[gather_pages(state[n], bt, layer, bt.shape[1])[:, :T].transpose(1, 2)
                      .contiguous() for n in ("k_cache", "v_cache")] for layer in range(L)]
            qb = q.to(torch.bfloat16)[:, :, None]

            def library(layer, dense=dense, qb=qb):
                return torch.nn.functional.scaled_dot_product_attention(
                    qb, *dense[layer], enable_gqa=cfg.num_kv_groups > 1)

            library_ms = device_ms(torch, library, 240, L, None)
            del dense
        tokens = int(ctx.sum())
        scale_bytes = 0 if codec in ("fp16", "fp8") else 4
        nbytes = (tokens * Hkv * 2 * (words * elem + scale_bytes) + 2 * q.numel() * 4
                  + 2 * BATCH * Hkv * (words * elem + scale_bytes) + bt.numel() * 4 + BATCH * 4)
        flops = 2 * 2 * tokens * Hkv * cfg.num_kv_groups * D
        b_ms, b_by, bytes_ms, ops_ms = bound(nbytes, flops)
        times[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          library_ms=library_ms)
        say(f"  {cfg.name} write+attend {key} at ctx {tokens // BATCH} (group "
            f"{cfg.num_kv_groups}, head_dim {D}, "
            f"{splits_label(torch, BATCH, Hkv, bt.shape[1], 4, state['k_cache'].shape[3])}): "
            f"{ms * 1e3:.2f} us/launch on the device; bound {b_ms * 1e3:.2f} us by {b_by} "
            f"({nbytes / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms * 1e3:.2f} us; {flops / 1e6:.1f} "
            f"MFLOP fp32 at 67 T/s = {ops_ms * 1e3:.2f} us); share of bound {b_ms / ms:.3f}; "
            f"plain version {plain_ms * 1e3:.1f} us; library call: "
            + ("none" if library_ms is None else
               f"{library_ms * 1e3:.2f} us (scaled_dot_product_attention, dense bf16 K/V)")
            + f" ({smi})")
    return times


def tiny_kernel_times(torch, gen, device, smi, cfg=None):
    """gpt2_kernel_times at cfg's decode shapes (default trained-tiny's:
    batch 8, 8/8 heads at head_dim 32, 6 layers; also tiny-gpt2's and
    trained-100m's, M17) on caches of TINY_TIME_CTX tokens a row, as its
    decode leaves them: the extract read on a golay cache and the
    read-inject read on an int4 one (encoded_cache), the correcting reads
    on unscrubbed caches (unscrubbed_cache, BER 2e-2), the float reads on
    float caches. The whole cache of a layer (0.1-0.9 MB) stays in the 50
    MB L2, so the bytes bound at 3.35 TB/s is not what holds these."""
    from qkv_ecc_tpu_torch.models.config import TRAINED_TINY

    cfg = cfg or TRAINED_TINY

    ctx_before = [TINY_TIME_CTX - 1] * BATCH
    ctx = torch.full((BATCH,), TINY_TIME_CTX, dtype=torch.int32, device=device)

    def run(state, bt):
        state["context_len"] = ctx.clone()
        return dict(state=state, bt=bt)

    runs = {"int12-golay": run(*encoded_cache(torch, cfg, "golay", ctx_before, 128, gen,
                                              device)[:2]),
            "int4": run(*encoded_cache(torch, cfg, "int4", ctx_before, 128, gen, device)[:2])}
    stats_runs = {mode: run(*unscrubbed_cache(torch, cfg, mode, ctx_before, gen, device)[:2])
                  for mode in ("int4-hamming84", "int4-hamming", "int12-golay")}
    runs["int4-hamming84-interp"] = stats_runs["int4-hamming84"]
    for codec in ("fp16", "fp8"):
        runs[codec] = run(*float_cache(torch, cfg, codec, gen, device, 128, TINY_TIME_CTX))
    return gpt2_kernel_times(torch, runs, stats_runs, device, smi, cfg)


def quiet(fn, *args, **kwargs):
    """fn's result with its stdout and stderr kept (returned as text)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = fn(*args, **kwargs)
    return result, out.getvalue(), err.getvalue()


def f12_check(torch, device, smi):
    """F12 on the card: the gradient of one batch's training loss (the fp16
    policy, JAX's loss) at trained-tiny's full width (batch 32 x 256 random
    bytes from numpy's default_rng(0), parameters init_params(seed 0)) on
    the card against the CPU's from the same parameters: every leaf has a
    gradient, the K and V columns of every c_attn too, and each leaf's
    largest difference is within TRAIN_GRAD_RTOL of its largest |g| on the
    CPU. Returns the parameters (on the CPU) and the batch."""
    import numpy as np
    from qkv_ecc_tpu_torch.models.config import TRAINED_TINY as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import KVCachePolicy
    from qkv_ecc_tpu_torch.models.registry import init_params, map_tree, tree_leaves
    from qkv_ecc_tpu_torch.training import TrainConfig
    from qkv_ecc_tpu_torch.training.trainer import train_loss

    tcfg = TrainConfig()
    rng = np.random.default_rng(0)
    chunk = torch.from_numpy(rng.integers(0, 256, (tcfg.batch, tcfg.seq_len + 1), dtype=np.int32))
    params = init_params(cfg, 0, device="cpu")
    grads, losses = {}, {}
    for dev in ("cpu", device):
        p = map_tree(lambda _, t: t.to(dev).clone().requires_grad_(True), params)
        t = time.perf_counter()
        loss = train_loss(p, chunk.to(dev), cfg, KVCachePolicy(codec="fp16"))
        loss.backward()
        if dev != "cpu":
            torch.cuda.synchronize()
        losses[str(dev)] = (float(loss.detach()), time.perf_counter() - t)
        grads[str(dev)] = {k: None if leaf.grad is None else leaf.grad.cpu()
                           for k, leaf in tree_leaves(p).items()}
    card, cpu = grads[str(device)], grads["cpu"]
    missing = [k for k, g in card.items() if g is None or cpu[k] is None]
    if missing:
        fail(f"F12: no gradient on {missing}")
    E = cfg.hidden_size
    dead = [k for k, g in card.items() if k.endswith("c_attn/w")
            and not (g[:, E:2 * E].abs().max() > 0 and g[:, 2 * E:].abs().max() > 0)]
    if dead:
        fail(f"F12: the K or V columns of {dead} have no gradient")
    shares = {k: float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max().clamp(min=1e-30))
              for k in card}
    worst = max(shares, key=shares.get)
    say(f"  F12 on the card: trained-tiny (6 layers, hidden 256, float32) batch {tcfg.batch} x "
        f"{tcfg.seq_len}, fp16 policy: loss card {losses[str(device)][0]:.6f} "
        f"({losses[str(device)][1]:.3f} s forward+backward), CPU {losses['cpu'][0]:.6f} "
        f"({losses['cpu'][1]:.3f} s); every one of {len(card)} leaves has a gradient, every "
        f"c_attn's K and V columns too; largest |g card - g CPU| / max |g CPU| of a leaf "
        f"{shares[worst]:.3e} ({worst}; tolerance {TRAIN_GRAD_RTOL})")
    if shares[worst] > TRAIN_GRAD_RTOL:
        fail("F12: the card's gradient differs from the CPU's")
    return params, chunk


def train_step_check(torch, params, device, smi):
    """One train_tiny update on the card against the same on the CPU, from
    the same given parameters (trained-tiny at full width, batch 32 x 256
    from a corpus of 64 KiB of random bytes): TrainConfig(steps=2), whose
    first update's rate is 0 (optax's schedule at count 0: the moments
    advance) and whose second is the peak 3e-4. Both logged losses agree
    within 1e-5 relative. Adam divides each element's step by its own
    gradient's size, so an element whose gradient sits in the rounding
    noise (the K third of each c_attn bias, whose gradient is 0 in exact
    arithmetic since softmax ignores a shift of every key; elements whose
    terms cancel) can move by up to lr either way on each device: every
    parameter's difference is held within 2 lr, and each leaf's update
    (its change from the given parameters; the c_attn biases without their
    K third) within TRAIN_STEP_RTOL of the CPU's in relative L2 norm."""
    import numpy as np
    from qkv_ecc_tpu_torch.models.config import TRAINED_TINY as cfg
    from qkv_ecc_tpu_torch.models.registry import tree_leaves
    from qkv_ecc_tpu_torch.training import TrainConfig, train_tiny

    corpus = np.random.default_rng(1).integers(0, 256, 1 << 16, dtype=np.uint8).tobytes()
    tcfg = TrainConfig(steps=2, log_every=1)
    out, logs = {}, {}
    for dev in ("cpu", device):
        log = []
        t = time.perf_counter()
        out[str(dev)] = train_tiny(cfg, corpus, tcfg, lambda s, l, e, log=log: log.append(l),
                                   params=params, device=dev)[0]
        logs[str(dev)] = (log, time.perf_counter() - t)
    card, cpu = tree_leaves(out[str(device)]), tree_leaves(out["cpu"])
    start = tree_leaves(params)
    E = cfg.hidden_size
    worst, worst_rel, n_off, n = (0.0, ""), (0.0, ""), 0, 0
    for k, t in card.items():
        diff, step = t.cpu() - cpu[k], cpu[k] - start[k]
        worst = max(worst, (float(diff.abs().max()), k))
        n_off += int((diff.abs() > 1e-6).sum())
        n += diff.numel()
        if k.endswith("c_attn/b"):
            diff, step = (torch.cat([x[:E], x[2 * E:]]) for x in (diff, step))
        rel = float(torch.linalg.vector_norm(diff)
                    / torch.linalg.vector_norm(step).clamp(min=1e-30))
        worst_rel = max(worst_rel, (rel, k))
    lc, lp = logs[str(device)][0], logs["cpu"][0]
    say(f"  one train_tiny update (steps=2: lr 0 then 3e-4) at trained-tiny's full width: "
        f"losses card {lc}, CPU {lp}; largest parameter difference {worst[0]:.3e} ({worst[1]}; "
        f"tolerance 2 lr = {2 * tcfg.lr:.1e}), {n_off} of {n} parameters apart by more than "
        f"1e-6; largest relative L2 difference of a leaf's update {worst_rel[0]:.3e} "
        f"({worst_rel[1]}; tolerance {TRAIN_STEP_RTOL}); {logs[str(device)][1]:.2f} s on the "
        f"card, {logs['cpu'][1]:.2f} s on the CPU ({smi})")
    if (any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(lc, lp)) or worst[0] > 2 * tcfg.lr
            or worst_rel[0] > TRAIN_STEP_RTOL):
        fail("the card's train step differs from the CPU's")


def train_phase(torch, device, smi, work):
    """The training path (training/, the train_tiny CLI) on the card: F12
    (f12_check), one update against the CPU's (train_step_check), then the
    CLI at trained-tiny's full width (6 layers, hidden 256, vocab 256,
    float32; JAX's batch 32 x 256) for TRAIN_STEPS steps into the
    directory `work`, which fails unless the last logged loss is below
    half the first; its checkpoint loaded through load_params
    (QKV_TINY_CHECKPOINT) and evaluated: the Monte-Carlo CLI at BER {0,
    1e-2} in fp16, int4 and int12-golay, seed 42, on the held-out texts the
    training CLI wrote beside it, and the generation demo (greedy, BER 0.05)
    in the seven decode modes through trained-tiny's kernel instances,
    whose launches are checked; then trained-100m (llama, 14 layers, GQA
    12/4, vocab 8192) through the CLI for TRAIN_100M_STEPS steps from a
    TRAIN_100M_CORPUS_MB MB corpus. Returns the generation demo's launches
    by branch."""
    import os

    from qkv_ecc_tpu_torch.evaluation.experiments.generation import (
        format_report, run_generation_demo)
    from qkv_ecc_tpu_torch.evaluation.experiments.monte_carlo import main as monte_carlo
    from qkv_ecc_tpu_torch.evaluation.experiments.train_tiny import main as train_cli
    from qkv_ecc_tpu_torch.evaluation.models import load_model
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc, paged_attention_ecc_write_attend as write_attend,
        write_decode_attend)
    from qkv_ecc_tpu_torch.models.registry import tree_leaves

    params, _ = f12_check(torch, device, smi)
    train_step_check(torch, params, device, smi)
    del params

    def cli(argv, what):
        res, _, err = quiet(train_cli, argv)
        for line in err.splitlines():
            say(f"  {what}: {line.strip()}")
        return res

    out = os.path.join(work, "trained_tiny", "checkpoint.npz")
    t = time.perf_counter()
    res = cli(["--model", "trained-tiny", "--steps", str(TRAIN_STEPS), "--output", out],
              "train_tiny CLI trained-tiny")
    first, last = res["log"][0][1], res["log"][-1][1]
    say(f"  trained-tiny: {TRAIN_STEPS} steps, corpus {res['corpus_tokens']} bytes, "
        f"{res['train_seconds'] / TRAIN_STEPS:.4f} s a step, "
        f"{TRAIN_STEPS * 32 * 256 / res['train_seconds']:.0f} tokens/s, peak memory the "
        f"training allocated {res['peak_memory_bytes'] / 1e9:.3f} GB; loss by logged step "
        + ", ".join(f"{s}: {l:.4f}" for s, l, _ in res["log"])
        + f"; the CLI in {time.perf_counter() - t:.1f} s ({smi})")
    if not last < first / 2:
        fail(f"trained-tiny: the last logged loss {last:.4f} is not below half the first "
             f"{first:.4f}")

    os.environ["QKV_TINY_CHECKPOINT"] = out
    try:
        loaded, cfg, _ = load_model("trained-tiny", allow_random_init=False, device=device)
        say(f"  load_params of {out}: {sum(t.numel() for t in tree_leaves(loaded).values())} "
            f"parameters on {loaded['wte'].device}, {loaded['wte'].dtype}")
        del loaded
        reset_counts(*kernel_wrappers())
        mc_dir = os.path.join(work, "monte_carlo")
        t = time.perf_counter()
        quiet(monte_carlo, ["--model", "trained-tiny", "--require-checkpoint", "--output-dir",
                            mc_dir, "--seeds", "42", "--ber-levels", "0", "1e-2",
                            "--cache-modes", "fp16", "int4", "int12-golay",
                            "--max-length", "256"])
        check_no_launches("train: Monte-Carlo CLI on the trained checkpoint")
        with open(os.path.join(mc_dir, "monte_carlo_results.json")) as fh:
            mc = json.load(fh)
        say(f"  Monte-Carlo CLI on the card-trained checkpoint, {len(mc['trials'])} trials in "
            f"{time.perf_counter() - t:.1f} s, 20 held-out texts, max_length 256 (mode, BER: "
            "perplexity, KL, top-5, corrected):")
        for tr in mc["trials"]:
            say(f"    {tr['cache_mode']:<14} {tr['ber']:<6} {tr['perplexity']:.4f} "
                f"{tr['kl_divergence']:.4f} {tr['top5_accuracy']:.4f} {tr['errors_corrected']}")

        reset_counts(write_attend, write_decode_attend, paged_attention_ecc)
        t = time.perf_counter()
        demo, _, _ = quiet(run_generation_demo, "trained-tiny", cache_modes=list(GEN_MODES),
                           ber=0.05, max_new_tokens=GEN_TOKENS, device=device)
        torch.cuda.synchronize()
        launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
        say(f"  generation demo on the card-trained checkpoint in {time.perf_counter() - t:.1f} "
            f"s (greedy, BER 0.05, prompt 'The future of machine learning is', {GEN_TOKENS} "
            "new bytes; agreement with a clean golay run):")
        for line in format_report(demo).splitlines():
            say(f"    {line}")
    finally:
        del os.environ["QKV_TINY_CHECKPOINT"]
    per_arm = cfg.num_layers * (GEN_TOKENS - 1)
    how = f"{cfg.num_layers} layers x {GEN_TOKENS - 1} decode steps x"
    check_launches("generation demo (trained-tiny)", {
        "write_attend read": (launches[0]["read"], per_arm * 4,
                              f"{how} 4 runs (int4-hamming, int4-hamming84, int12-golay and "
                              "the clean golay run)"),
        "write_attend read-inject": (launches[0]["read-inject"], per_arm, f"{how} 1 arm (int4)"),
        "write_attend fp16 (K2f)": (launches[0]["fp16"], per_arm, f"{how} 1 arm (fp16)"),
        "write_attend fp8 (K2f)": (launches[0]["fp8"], per_arm, f"{how} 1 arm (fp8)"),
        "decode_attend hamming84-interp": (launches[1]["hamming84-interp"], per_arm,
                                           f"{how} 1 arm (int4-hamming84-interp)"),
        "decode_attend other branches": (write_decode_attend.launches
                                         - launches[1]["hamming84-interp"], 0, "none"),
        "paged_attention_ecc (K4)": (paged_attention_ecc.launches, 0, "none"),
    })

    t = time.perf_counter()
    res = cli(["--model", "trained-100m", "--steps", str(TRAIN_100M_STEPS),
               "--max-corpus-mb", str(TRAIN_100M_CORPUS_MB),
               "--output", os.path.join(work, "trained_100m", "checkpoint.npz")],
              "train_tiny CLI trained-100m")
    n_files = len(os.listdir(os.path.join(work, "trained_100m")))
    say(f"  trained-100m: {TRAIN_100M_STEPS} steps from a {TRAIN_100M_CORPUS_MB} MB corpus of "
        f"{res['corpus_tokens']} word tokens, {res['train_seconds'] / TRAIN_100M_STEPS:.4f} s "
        f"a step, {TRAIN_100M_STEPS * 32 * 256 / res['train_seconds']:.0f} tokens/s, peak "
        f"memory the training allocated {res['peak_memory_bytes'] / 1e9:.3f} GB; losses "
        + ", ".join(f"{s}: {l:.4f}" for s, l, _ in res["log"])
        + f"; {n_files} files written; the CLI in {time.perf_counter() - t:.1f} s ({smi})")
    if not all(math.isfinite(l) for _, l, _ in res["log"]):
        fail("trained-100m: a logged loss is not finite")
    return launches


def experiments_phase(torch, device, smi, work):
    """Each ported experiment CLI once on the card, its JSON into the
    directory `work`: latency (its defaults), quantization x ECC
    (--trials 1 of 3), architecture (tiny-gpt2 and tiny-llama, its
    defaults), fault_tolerance_benchmark at its defaults (tiny-llama) and
    with its grid on gpt2 at full width (--grid-batches 1 8 of 1 4 8,
    --decode-tokens 16 of 32), and tpu_eval on gpt2 at full width (seed 42,
    BER {0, 1e-2}). Each result has the JAX package's keys, its arms at BER
    0 agree (the int4 codes' perplexities equal, the codecs' MSE the
    quantizer's), nothing is NaN. The forward-only ones launch no kernel;
    the fault-tolerance runs decode through the kernels (their launches
    are returned)."""
    import os

    from qkv_ecc_tpu_torch.evaluation.experiments import (
        architecture, fault_tolerance_benchmark as ft, latency,
        quantization_ecc_comparison as qe)
    from qkv_ecc_tpu_torch.evaluation.runners import tpu_eval
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)

    def path(name):
        return os.path.join(work, name)

    def keys(what, got, want):
        if set(got) != set(want):
            fail(f"{what}: keys {sorted(got)}, the JAX package's {sorted(want)}")

    reset_counts(*kernel_wrappers())
    t = time.perf_counter()
    lat, _, _ = quiet(latency.main, ["--output", path("latency.json")])
    for r in lat:
        keys("latency", r, LATENCY_KEYS)
        if not (r["throughput_mvalues_sec"] > 0 and all(
                math.isfinite(v) for v in r.values() if isinstance(v, float))):
            fail(f"latency {r['codec']} {r['shape']}: no throughput or a value not finite")
    say(f"  latency (defaults: 3 codecs x 3 shapes x 5 trials) in {time.perf_counter() - t:.1f} "
        "s: " + "; ".join(f"{r['codec']} {r['n_values']} values enc {r['encode_ms']:.3f} ms dec "
                          f"{r['decode_ms']:.3f} ms {r['throughput_mvalues_sec']:.0f} Mvalues/s "
                          f"{r['bandwidth_efficiency_pct']:.2f}% of the H100's rate"
                          for r in lat) + f" ({smi})")

    t = time.perf_counter()
    qres, _, _ = quiet(qe.main, ["--trials", "1", "--output", path("quant_ecc.json")])
    for r in qres:
        keys("quantization_ecc_comparison", r, QUANT_ECC_KEYS)
        if any(isinstance(v, float) and math.isnan(v) for v in r.values()):
            fail(f"quantization_ecc_comparison {r}: NaN")
        if r["ber"] == 0.0 and abs(r["post_ecc_mse"] - r["quant_mse"]) > 1e-6 * r["quant_mse"]:
            fail(f"quantization_ecc_comparison {r['backend']} {r['ecc']}: at BER 0 the codec "
                 "roundtrip is not lossless")
    amp = {(r["ecc"], r["ber"]): r["mse_amplification"] for r in qres
           if r["backend"] == "kivi_symmetric"}
    say(f"  quantization_ecc_comparison (--trials 1 of 3: 6 backends x 4 arms x 4 BERs) in "
        f"{time.perf_counter() - t:.1f} s; at BER 0 every arm's MSE is its quantizer's; "
        "kivi_symmetric's MSE amplification at BER 1e-2 / 5e-2: "
        + ", ".join(f"{e} {amp[(e, 1e-2)]:.2f} / {amp[(e, 5e-2)]:.2f}"
                    for e in ("none", "hamming74", "hamming84", "golay")))

    t = time.perf_counter()
    comp, _, _ = quiet(architecture.main, ["--output", path("architecture.json")])
    for name, entry in comp.items():
        keys("architecture", entry["architecture"], ARCH_KEYS)
        agg = entry["results"].aggregated
        at0 = {m: by[0].ppl_mean for m, by in agg.items()}
        if len(set(at0.values())) != 1 or not all(
                math.isfinite(a.ppl_mean) for by in agg.values() for a in by.values()):
            fail(f"architecture {name}: at BER 0 the int4 codes' perplexities differ ({at0}) "
                 "or one is not finite")
        say(f"  architecture {name} ({entry['architecture']['kv_projection']}): "
            + ", ".join(f"{m} BER {b}: ppl {a.ppl_mean:.3f} corrected "
                        f"{a.errors_corrected_mean:.0f}" for m, by in agg.items()
                        for b, a in sorted(by.items())))
    say(f"  architecture (defaults) in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    agg, _, _ = quiet(tpu_eval.main, ["--model", "gpt2", "--seeds", "42", "--ber-levels", "0",
                                      "1e-2", "--output", path("tpu_eval.json")])
    for r in agg:
        keys("tpu_eval", r, TPU_EVAL_KEYS)
    at0 = {r["mode"]: r["ppl_mean"] for r in agg if r["ber"] == 0}
    int4_codes = {m: v for m, v in at0.items() if m not in ("fp16", "fp8")}
    if len(set(int4_codes.values())) != 1 or not all(math.isfinite(r["ppl_mean"]) for r in agg):
        fail(f"tpu_eval: at BER 0 the int4 codes' perplexities differ ({at0}) or one is not "
             "finite")
    if not all(r["errors_corrected_mean"] > 0 for r in agg
               if r["ber"] > 0 and r["mode"] not in ("fp16", "int4")):
        fail("tpu_eval: a protected mode corrected nothing at BER 1e-2")
    say(f"  tpu_eval on gpt2 (full width, random weights; seed 42, BER 0 and 1e-2, the six "
        f"default modes, 20 texts at 512) in {time.perf_counter() - t:.1f} s: "
        + "; ".join(f"{r['mode']} {r['ber']}: {r['ppl_mean']:.4f} corrected "
                    f"{r['errors_corrected_mean']:.0f}" for r in agg) + f" ({smi})")
    check_no_launches("experiments: latency, quantization x ECC, architecture, tpu_eval")

    reset_counts(write_attend, write_decode_attend)
    runs = {}
    for name, argv in (("tiny-llama", []),
                       ("gpt2", ["--model", "gpt2", "--grid", "--grid-batches", "1", "8",
                                 "--decode-tokens", "16"])):
        t = time.perf_counter()
        res, _, _ = quiet(ft.main, argv + ["--output", path(f"fault_tolerance_{name}.json")])
        runs[name] = res
        for r in res["throughput"]:
            keys("fault_tolerance throughput", r, FT_THROUGHPUT_KEYS)
        for r in res["ppl_vs_ber"]:
            keys("fault_tolerance ppl_vs_ber", r, FT_PPL_KEYS)
        at0 = {r["arm"]: r["ppl_mean"] for r in res["ppl_vs_ber"] if r["ber"] == 0}
        if len(set(at0.values())) != 1 or not all(
                math.isfinite(r["ppl_mean"]) for r in res["ppl_vs_ber"]):
            fail(f"fault_tolerance {name}: at BER 0 the arms' perplexities differ ({at0}) or "
                 "one is not finite")
        say(f"  fault_tolerance_benchmark {name} in {time.perf_counter() - t:.1f} s: "
            + "; ".join(f"{r['codec']} {r['decode_tokens_per_sec']:.1f} tokens/s "
                        f"{r['ms_per_token']:.3f} ms/token {r['overhead_vs_unprotected']:.3f}x "
                        "int4's time" for r in res["throughput"])
            + "; PPL " + ", ".join(f"{r['arm']} BER {r['ber']}: {r['ppl_mean']:.3f}"
                                  for r in res["ppl_vs_ber"]) + f" ({smi})")
        for r in res.get("grid", []):
            keys("fault_tolerance grid", r, FT_GRID_KEYS)
            keys("fault_tolerance grid memory", r["memory"], FT_MEMORY_KEYS)
            say(f"    grid {r['arm']} batch {r['batch']} ctx {r['context_len']}: "
                f"{r['decode_tokens_per_sec']:.1f} tokens/s, {r['ms_per_token']:.3f} ms/token, "
                f"cache {r['cache_gb'] * 1e3:.1f} MB, peak {r['memory']['peak_bytes_in_use'] / 1e9:.3f}"
                f" GB of {r['memory']['bytes_limit'] / 1e9:.1f} GB ({smi})")
    launches = (dict(write_attend.launches_by), dict(write_decode_attend.launches_by))
    say(f"  fault_tolerance_benchmark launches: write_attend {launches[0]}, decode_attend "
        f"{launches[1]}")
    if not launches[0]["read"] > 0:
        fail("fault_tolerance_benchmark: the decode did not go through the kernels")
    return launches


# -- the parallel layer on one card (ROADMAP M11) ---------------------------
#
# The H100 machine has one card, and NCCL puts no two ranks of one
# communicator on the same device: so the parallel paths run as PAR_RANKS
# gloo ranks sharing cuda:0 (gloo's all_reduce takes CUDA tensors), and as
# one NCCL rank (measure_tp_mesh at 1x1). Both check correctness; ranks that
# share a card give no scaling figure.

PAR_RANKS = 2
# bench-0.9b at full width and a cut depth, float32 (the row-parallel sums
# reassociate additions, and float32 keeps the quantization ties they move
# rare), batch 8, a 1024-token prompt and TP_STEPS decode steps, BER 1e-2
TP_LAYERS, TP_PROMPT, TP_STEPS = 4, 1024, 4
TP_ARMS = ("int4-write-inject", "int4-hamming84/stats", "int12-golay", "fp16")
# and in bench-0.9b's own bfloat16 (the kernels' bfloat16-query variants):
# the scrubbed extract read with its parity scatter, and the correcting read
TP_BF16_ARMS = ("int4-hamming84", "int4-hamming84/stats")
# gpt2 (full depth, 12/12 heads: 6 a rank, its c_attn permuted) and one step
# of trained-100m (12/4 heads: 6/2 a rank, GQA group 3, M17's instances)
TP_GPT2_PROMPT, TP_100M_PROMPT = 512, 256
CP_CTX = [1024, 900, 1, 513, 129, 1000, 640, 777]
CP_EMPTY_CTX = [100, 1, 128, 0, 50, 127, 3, 64]  # one page each: rank 1's shard is empty
SERVE_TP_REQUESTS = 12


def tolerance_share(torch, got, ref):
    """The largest |got - ref| as a share of output_tolerance(ref); where
    the tolerance is 0 (an empty row, whose ref is 0) any difference is
    infinite."""
    d = (got.float() - ref.float()).abs()
    tol = output_tolerance(ref)
    share = torch.where(tol > 0, d / torch.where(tol > 0, tol, 1.0),
                        torch.where(d > 0, math.inf, 0.0))
    return float(share.max())


@contextlib.contextmanager
def splits_at(num_kv_heads):
    """The kernels' split rules (packed_splits, float_splits) taken at
    num_kv_heads KV heads whatever a call's own: a TP rank's kernels then
    split each (sequence, KV head) into as many blocks as the single-device
    run's do, and round its softmax weights alike."""
    from qkv_ecc_tpu_torch.kernels import paged_attention as pa

    rules = pa.packed_splits, pa.float_splits
    pa.packed_splits = lambda batch, hkv, *a: rules[0](batch, num_kv_heads, *a)
    pa.float_splits = lambda batch, hkv, *a: rules[1](batch, num_kv_heads, *a)
    try:
        yield
    finally:
        pa.packed_splits, pa.float_splits = rules


def tp_path(torch, mesh, cfg, mode, prompt, steps, seed=0):
    """One arm of the tensor-parallel decode on this rank against the
    single-device runtime on the same card: weights from ``seed`` in cfg's
    dtype, the same generator draws (full-shape masks sliced by the TP
    run). The TP prefill (which runs no kernel) is compared with the
    single-device prefill. The TP decode then starts from the rank's head
    slice of the single-device prefill cache, fed the single-device run's
    greedy tokens, twice: as the path runs it (the kernels' split rules at
    the rank's KV heads: launches and logits), and with the kernels split
    as the single-device run's (splits_at), so that the words they write
    at the decode positions differ only by the row-parallel sums' order.
    Returns the words differing from the single-device slice by layer
    (after the prefill, and after each decode at the decode positions and
    elsewhere), the logits' largest share of output_tolerance in each
    decode, the ECC counts of the second and the first decode's launches
    by kernel branch."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.kernels import swar
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.models import runtime as rt
    from qkv_ecc_tpu_torch.parallel.sharding import shard_params
    from qkv_ecc_tpu_torch.parallel.tp_runtime import make_tp_functions

    device = mesh.device
    stats = mode.endswith("/stats")
    pol = policy_for_mode(mode.split("/")[0], ber=BER, seed=42)
    if stats:
        pol = dataclasses.replace(pol, scrub=False)
    params = init_params(cfg, seed=seed, device=device, dtype=cfg.torch_dtype)
    ids = torch.randint(0, cfg.vocab_size, (BATCH, prompt), device=device,
                        generator=torch.Generator(device=device).manual_seed(seed + 1))
    T = prompt + steps + 1
    hl = cfg.num_kv_heads // mesh.model
    heads = slice(mesh.model_index * hl, (mesh.model_index + 1) * hl)
    names = ("k_cache", "v_cache", "k_parity", "v_parity", "k_scales", "v_scales")
    # the single-device run
    g = torch.Generator(device=device).manual_seed(7)
    state, bt, _ = rt.init_generation_state(cfg, pol, BATCH, T, device=device)
    logits, state = rt.prefill(params, ids, state, bt, cfg, pol, g)
    names = [n for n in names if n in state]
    prefilled = {n: state[n][:, :, heads].clone() for n in names}
    ref_logits, toks = [], []
    for _ in range(steps):
        toks.append(torch.argmax(logits, -1))
        logits, state = rt.decode_step(params, toks[-1], state, bt, cfg, pol, g,
                                       collect_ecc_stats=stats)
        ref_logits.append(logits)
    final = {n: state[n][:, :, heads] for n in names}
    # the TP run on the same draws
    local = shard_params(params, cfg, mesh)
    init_state, prefill, decode_step = make_tp_functions(cfg, pol, mesh,
                                                         collect_ecc_stats=stats)
    g = torch.Generator(device=device).manual_seed(7)
    tstate, tbt = init_state(BATCH, T)
    _, tstate = prefill(local, ids, tstate, tbt, g)
    after_prefill = g.get_state()

    # a word's token: sequence b owns pages [b P, (b + 1) P) of the table
    bs = state["k_cache"].shape[4]
    pages = torch.arange(state["k_cache"].shape[1], device=device) % bt.shape[1]
    token = pages[:, None] * bs + torch.arange(bs, device=device)[None, :]  # [NB, bs]
    at_decode = (token >= prompt) & (token < prompt + steps)

    def differing(got, want):
        """Words differing, [L, NB, bs], summed over the cache arrays (the
        scales excepted), and the words a token holds in all of them."""
        diff, per_token = 0, 0
        for n in names:
            if "scales" in n:
                continue
            a, b = raw_bits(got[n]), raw_bits(want[n])
            diff = diff + (a != b).sum(dim=(2, 3))
            per_token += a.shape[2] * a.shape[3]
        return diff, per_token

    diff, per_token = differing(tstate, prefilled)
    out = dict(cfg=cfg.name, layers=cfg.num_layers, dtype=cfg.dtype, mode=mode, steps=steps,
               prompt=prompt, prefill_by_layer=diff.sum(dim=(1, 2)).tolist(),
               prompt_total=int((token < prompt).sum()) * per_token * cfg.num_layers,
               decode_total=int(at_decode.sum()) * per_token * cfg.num_layers)
    for run in ("own", "same"):  # the rank's split rules, then the single-device run's
        for n in names:
            tstate[n].copy_(prefilled[n])
        tstate["context_len"].fill_(prompt)
        tstate.pop("ecc_corrected", None)
        tstate.pop("ecc_detected", None)
        g.set_state(after_prefill)
        torch.cuda.synchronize()
        reset_counts(write_attend, write_decode_attend)
        worst = 0.0
        with splits_at(cfg.num_kv_heads) if run == "same" else contextlib.nullcontext():
            for tok, ref in zip(toks, ref_logits):
                logits, tstate = decode_step(local, tok, tstate, tbt, g)
                worst = max(worst, tolerance_share(torch, logits, ref))
        torch.cuda.synchronize()
        diff, _ = differing(tstate, final)
        out[run] = dict(decode_by_layer=(diff * at_decode).sum(dim=(1, 2)).tolist(),
                        outside_decode=int((diff * ~at_decode).sum()), worst=worst)
        if run == "own":
            out["launches"] = {
                **{f"write_attend {k}": v for k, v in write_attend.launches_by.items() if v},
                **{f"decode_attend {k}": v for k, v in write_decode_attend.launches_by.items()
                   if v}}
    if stats:
        out["counts"] = [tstate[n].tolist() for n in ("ecc_corrected", "ecc_detected")]
        out["ref_counts"] = [state[n].tolist() for n in ("ecc_corrected", "ecc_detected")]
    if pol.codec == "hamming84":
        # the syndrome of every stored codeword depends on its flips alone
        # (a linear code, and a scrub that decides by the syndrome): equal
        # syndromes mean the same injection, codeword by codeword, whatever
        # values the two runs quantized
        maps = []
        for st in (tstate, final):
            words = [swar.h84_rebuild_cw_words(st[f"{kv}_cache"], st[f"{kv}_parity"])
                     for kv in "kv"]
            maps.append(torch.stack([torch.stack(swar.h84_swar_syndromes(x))
                                     for pair in words for x in pair]))
        out["syndromes_equal"] = bool(torch.equal(*maps))
        a, b, c, _ = maps[1].unbind(1)
        out["errors"] = int(swar.C.popcount(a | b | c).sum())
    return out


def cp_path(torch, mesh):
    """K4 with its softmax state on the page shards of bench-0.9b's cache
    (2 layers, B 8, 16/8 heads), rank r reading pages [r p, (r+1) p) of
    each row (p: half its pages, rounded up, as shard_context splits its
    tokens), merged over the ranks (make_cp_attention over the model
    group), against the single K4 read of the whole cache, in int4,
    hamming84 and golay (with parity), and with rank 1's shard empty.
    Returns the largest error over output_tolerance and the CP launches."""
    from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc
    from qkv_ecc_tpu_torch.parallel.context_parallel import make_cp_attention, shard_context

    device = mesh.device
    cfg = bench_attention_cfg()
    names = ("k_cache", "v_cache", "k_scales", "v_scales")
    out = {"cases": [], "launches": {}}
    for codec, ctx_list in (("int4", CP_CTX), ("hamming84", CP_CTX), ("golay", CP_CTX),
                            ("hamming84", CP_EMPTY_CTX)):
        gen = torch.Generator(device=device).manual_seed(11)  # the same cache on every rank
        state, bt, _ = (unscrubbed_cache(torch, cfg, f"int4-{codec}" if codec == "hamming84"
                                         else "int12-golay", [c - 1 for c in ctx_list], gen,
                                         device)
                        if codec != "int4" else
                        encoded_cache(torch, cfg, "int4", [c - 1 for c in ctx_list], 128, gen,
                                      device))
        ctx = torch.tensor(ctx_list, dtype=torch.int32, device=device)
        n = mesh.model
        local = torch.from_numpy(shard_context(ctx_list, n, 128)).to(device)
        # shard s of row b: its pages [s pps, (s + 1) pps), pps = ceil(pages / n),
        # as shard_context splits the tokens
        pages = [-(-c // 128) for c in ctx_list]
        pps = [-(-p // n) for p in pages]
        bt_sh = torch.full((n, BATCH, max(max(pps), 1)), -1, dtype=torch.int32)
        for sh in range(n):
            for b, (p, q) in enumerate(zip(pages, pps)):
                lo, hi = sh * q, min((sh + 1) * q, p)
                if hi > lo:
                    bt_sh[sh, b, :hi - lo] = bt[b, lo:hi].cpu()
        bt_sh = bt_sh.to(device)
        q = torch.randn((BATCH, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=device).to(torch.bfloat16)
        parity = () if codec == "int4" else (state["k_parity"], state["v_parity"])
        fn = make_cp_attention(mesh, "model", with_parity=bool(parity), codec=codec)
        torch.cuda.synchronize()
        before = dict(paged_attention_ecc.launches_by)
        got = fn(q, *(state[n] for n in names), bt_sh, local, 1, *parity)
        torch.cuda.synchronize()
        for k, v in paged_attention_ecc.launches_by.items():
            if v - before[k]:
                out["launches"][k] = out["launches"].get(k, 0) + v - before[k]
        ref = paged_attention_ecc(q, *(state[n] for n in names), bt, ctx, 1, *parity,
                                  codec=codec)
        err = tolerance_share(torch, got, ref)
        out["cases"].append(dict(codec=codec, empty=ctx_list is CP_EMPTY_CTX, err=err,
                                 finite=bool(torch.isfinite(got).all()),
                                 local=local[mesh.model_index].tolist()))
    return out


def tp_server_path(torch, mesh):
    """TPContinuousBatchingServer on this rank against the single-device
    server on the same card: JAX's test_tp_server_mesh_2x4_end_to_end
    (tests/test_serving.py:250-306) on its model, tiny-llama at 8/4 heads
    (head_dim 16, float32, seed 3; 16-token pages): the admitted caches
    equal within 1e-6, one decode step's logits within 1e-4, then
    SERVE_TP_REQUESTS requests through 8 slots in int4-hamming84 at BER 0,
    staggered, the share of stream tokens that agree (JAX asks for more
    than 0.7). Returns the numbers and the TP server's launches."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.models.config import TINY_LLAMA
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request
    from qkv_ecc_tpu_torch.serving import TPContinuousBatchingServer

    device = mesh.device
    cfg = dataclasses.replace(TINY_LLAMA, num_heads=8, num_kv_heads=4, name="tp-serve")
    params = init_params(cfg, seed=3, device=device)
    pol = policy_for_mode("int4-hamming84", ber=0.0, seed=42)
    rng = torch.Generator().manual_seed(5)
    lens = torch.randint(5, 40, (SERVE_TP_REQUESTS,), generator=rng).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).numpy() for n in lens]
    kw = dict(max_batch=8, max_seq_len=96, block_size=16)
    hl = cfg.num_kv_heads // mesh.model
    heads = slice(mesh.model_index * hl, (mesh.model_index + 1) * hl)

    def servers():
        return (ContinuousBatchingServer(params, cfg, pol, device=device, **kw),
                TPContinuousBatchingServer(params, cfg, pol, mesh, **kw))

    base, tp = servers()
    for s in (base, tp):
        s.add_request(Request(0, prompts[0], max_new_tokens=6))
        s.add_request(Request(1, prompts[1], max_new_tokens=6))
        s._try_admit()
    state_err = max(float((tp.state[n].double() - base.state[n][:, :, heads].double()).abs().max())
                    for n in ("k_cache", "v_cache", "k_parity", "v_parity", "k_scales",
                              "v_scales"))
    toks = torch.tensor([base.slots[0].next_token, base.slots[1].next_token] + [0] * 6,
                        device=device)
    logit_err = float((tp._run_decode(toks, tp._block_table())
                       - base._run_decode(toks, base._block_table())).abs().max())
    base, tp = servers()
    reset_counts(write_attend, write_decode_attend)
    streams = []
    for s in (tp, base):
        for i, p in enumerate(prompts[:8]):
            s.add_request(Request(i, p, max_new_tokens=16))
        s.step()
        for i, p in enumerate(prompts[8:], start=8):
            s.add_request(Request(i, p, max_new_tokens=16))
        streams.append({o.request_id: list(o.token_ids) for o in s.run()})
        if s is tp:
            torch.cuda.synchronize()
            launches = {**{f"write_attend {k}": v for k, v in write_attend.launches_by.items()
                           if v},
                        **{f"decode_attend {k}": v
                           for k, v in write_decode_attend.launches_by.items() if v}}
            steps = s._step_counter
    match = sum(a == b for rid, t in streams[0].items() for a, b in zip(t, streams[1][rid]))
    total = sum(len(t) for t in streams[1].values())
    return dict(state_err=state_err, logit_err=logit_err, match=match, total=total,
                finished=len(streams[0]), launches=launches, steps=steps,
                layers=cfg.num_layers)


def par_rank():
    """A spawned rank of the parallel phase (parallel/launch.spawn): the
    TP arms, the CP reads and the TP server on a 1 x PAR_RANKS mesh."""
    import dataclasses
    import torch
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B, GPT2_124M, TRAINED_100M
    from qkv_ecc_tpu_torch.parallel.launch import rank_device_from_env
    from qkv_ecc_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(1, PAR_RANKS, device=rank_device_from_env())
    bench = dataclasses.replace(BENCH_0_9B, num_layers=TP_LAYERS)  # bfloat16, as configured
    f32 = dict(dtype="float32")
    t = time.perf_counter()
    tp = [tp_path(torch, mesh, dataclasses.replace(bench, **f32), mode, TP_PROMPT, TP_STEPS)
          for mode in TP_ARMS]
    tp += [tp_path(torch, mesh, bench, mode, TP_PROMPT, TP_STEPS) for mode in TP_BF16_ARMS]
    tp.append(tp_path(torch, mesh, dataclasses.replace(GPT2_124M, **f32), "int4-hamming84",
                      TP_GPT2_PROMPT, 2))
    tp += [tp_path(torch, mesh, dataclasses.replace(TRAINED_100M, **f32), mode, TP_100M_PROMPT, 1)
           for mode in ("int12-golay", "int4-hamming84/stats")]
    seconds = {"tp": time.perf_counter() - t}
    t = time.perf_counter()
    cp = cp_path(torch, mesh)
    seconds["cp"] = time.perf_counter() - t
    t = time.perf_counter()
    server = tp_server_path(torch, mesh)
    seconds["server"] = time.perf_counter() - t
    return dict(rank=mesh.rank, tp=tp, cp=cp, server=server, seconds=seconds)


# How far a TP shard's stored words may differ from the single-device
# slice on the card (readings: PERF.md §6, an H100 at 700 W). The
# row-parallel sums add the same terms in another order (and cuBLAS may
# order a column shard's sums otherwise), so a K/V value on a quantization
# boundary can store the neighbouring code.
#   * After the prefill (which runs no kernel) every later position of the
#     prompt attends such a value, so the words of the next layers differ
#     more, layer by layer: float32, none of layer 0's int4 words (its K/V
#     depend on the embedding and one column shard alone), 0 to 9 of 8.4M
#     bfloat16 values in fp16's (TP_LAYER0_BF16_SHARE), and 1.5e-3 to
#     7.8e-3 of the prompt's words at 4 to 14 layers (TP_WORD_SHARE).
#   * The decode starts from the single-device prefill cache. At the
#     rank's own split rules the kernels split a sequence into other
#     blocks than the single-device run's, whose softmax weights round
#     otherwise (2.2e-2 to 2.9e-2 of the decode positions' int4 words
#     differ at bench-0.9b, 0.32 of fp16's values): printed, and the
#     logits held to output_tolerance. With the single-device run's splits
#     (splits_at) only the sums' order is left: layer 0's words must be
#     equal (fp16: within TP_LAYER0_FP16_DECODE_SHARE, 9 of 32768 values),
#     the others within TP_DECODE_WORD_SHARE (read: 0 to 5.6e-4) or
#     TP_DECODE_FP16_SHARE (4.75e-3), and every word outside the decode
#     positions equal after either decode.
#   * In bfloat16 (bench-0.9b's own dtype) each row-parallel sum rounds its
#     partials and then their sum, against one rounding on a single device,
#     so the residual stream differs by an ulp in many elements from layer
#     0's sums on: 0.140 of the prompt's words and 0.117 of the decode
#     positions' (layer 0's equal), the logits within 3.67 to 3.85 of
#     output_tolerance (the _BF16 bounds).
# A wrong mask slice or head mapping differs in about a third of the words
# from layer 0 on, and wrong words at the decode positions in nearly all of
# theirs; the ECC counts and every Hamming(8,4) codeword's syndrome must
# be equal anyway.
TP_WORD_SHARE = 2e-2
TP_LAYER0_BF16_SHARE = 1e-5
TP_DECODE_WORD_SHARE = 3e-3
TP_DECODE_FP16_SHARE = 2e-2
TP_LAYER0_FP16_DECODE_SHARE = 1e-3
TP_WORD_SHARE_BF16 = 3e-1
TP_DECODE_WORD_SHARE_BF16 = 3e-1
TP_LOGITS_BF16 = 8.0


def parallel_phase(torch, smi):
    """The parallel layer on PAR_RANKS gloo ranks sharing the card (one
    spawn; a rank that fails fails the run): tp_path's arms, cp_path and
    tp_server_path, each rank's results checked here. Returns the launches
    of the TP arms, the TP server and CP (K4 by branch), summed over the
    ranks."""
    from qkv_ecc_tpu_torch.parallel.launch import spawn

    try:
        ranks = spawn("chip_smoke:par_rank", PAR_RANKS, backend="gloo", device="cuda:0",
                      timeout=600)
    except RuntimeError as e:
        fail(f"parallel: {e}")
    tp_l, serve_l, cp_l = {}, {}, {}
    for r in ranks:
        say(f"  rank {r['rank']} of {PAR_RANKS} (gloo, sharing cuda:0): "
            + ", ".join(f"{k} {v:.1f} s" for k, v in r["seconds"].items()))
        for a in r["tp"]:
            bf16 = a["dtype"] == "bfloat16"
            pre = sum(a["prefill_by_layer"]) / a["prompt_total"]
            dec = {run: sum(a[run]["decode_by_layer"]) / a["decode_total"]
                   for run in ("own", "same")}
            say(f"  rank {r['rank']} TP {a['cfg']} ({a['layers']} layers, {a['dtype']}) "
                f"{a['mode']} at model {PAR_RANKS}, batch {BATCH}, prompt {a['prompt']} + "
                f"{a['steps']} steps, BER {BER}: stored words differing from the single-device "
                f"slice after the prefill {sum(a['prefill_by_layer'])} of {a['prompt_total']} "
                f"({pre:.2e}; by layer {a['prefill_by_layer']}); after the decode from the "
                f"single-device prefill cache, at the decode positions, "
                + "; ".join(f"{how} {sum(a[run]['decode_by_layer'])} of {a['decode_total']} "
                            f"({dec[run]:.2e}; by layer {a[run]['decode_by_layer']}), "
                            f"elsewhere {a[run]['outside_decode']}, logits within "
                            f"{a[run]['worst']:.3f} of output_tolerance"
                            for run, how in (("own", "the rank's splits"),
                                             ("same", "the single-device run's splits")))
                + f"; launches {a['launches']}"
                + (f"; ECC counts {a['counts']} (single device {a['ref_counts']})"
                   if "counts" in a else "")
                + (f"; syndromes of every codeword equal ({a['errors']} corrupted): "
                   f"{a['syndromes_equal']}" if "syndromes_equal" in a else "") + f" ({smi})")
            layer_words = (a["prompt_total"] / a["layers"], a["decode_total"] / a["layers"])
            fp16 = a["mode"] == "fp16"
            same = a["same"]
            ok = (pre <= (TP_WORD_SHARE_BF16 if bf16 else TP_WORD_SHARE)
                  and dec["same"] <= (TP_DECODE_WORD_SHARE_BF16 if bf16 else
                                      TP_DECODE_FP16_SHARE if fp16 else TP_DECODE_WORD_SHARE)
                  and a["own"]["outside_decode"] == same["outside_decode"] == 0
                  and a["prefill_by_layer"][0] <= (TP_LAYER0_BF16_SHARE if fp16 else 0)
                  * layer_words[0]
                  and same["decode_by_layer"][0] <= (TP_LAYER0_FP16_DECODE_SHARE if fp16 else 0)
                  * layer_words[1]
                  and max(a["own"]["worst"], same["worst"]) <= (TP_LOGITS_BF16 if bf16 else 1.0))
            if "counts" in a:
                ok = ok and a["counts"] == a["ref_counts"]
            if "syndromes_equal" in a:
                ok = ok and a["syndromes_equal"]
            if not ok:
                fail(f"TP {a['cfg']} {a['dtype']} {a['mode']}: rank {r['rank']} disagrees with "
                     "the single-device run")
            want = a["layers"] * a["steps"]
            branch = ("decode_attend hamming84" if "counts" in a else
                      "write_attend fp16" if a["mode"] == "fp16" else "write_attend read")
            if a["launches"] != {branch: want}:
                fail(f"TP {a['cfg']} {a['mode']}: launches {a['launches']}, expected "
                     f"{{{branch}: {want}}} ({a['layers']} layers x {a['steps']} steps)")
            tp_l[branch] = tp_l.get(branch, 0) + want
        for c in r["cp"]["cases"]:
            say(f"  rank {r['rank']} CP {c['codec']} (K4 softmax state, local contexts "
                f"{c['local']}): merged read within {c['err']:.3f} of output_tolerance of the "
                f"single K4 read; finite {c['finite']}" + (" (rank 1's shard empty)"
                                                          if c["empty"] else ""))
            if not (c["err"] <= 1.0 and c["finite"]):
                fail(f"CP {c['codec']}: rank {r['rank']} disagrees with the single K4 read")
        cp_want = {"read": 1, "hamming84": 2, "golay": 1}  # one read a case
        if r["cp"]["launches"] != cp_want:
            fail(f"CP: rank {r['rank']} launched K4 {r['cp']['launches']}, not {cp_want}")
        for k, v in r["cp"]["launches"].items():
            cp_l[k] = cp_l.get(k, 0) + v
        s = r["server"]
        say(f"  rank {r['rank']} TP server (tiny-llama 8/4 heads, 8 slots, {SERVE_TP_REQUESTS} "
            f"requests, int4-hamming84, BER 0): admitted caches within {s['state_err']:.2e} "
            f"(JAX asks < 1e-6), one step's logits within {s['logit_err']:.2e} (< 1e-4); "
            f"{s['finished']} finished; stream tokens agreeing with the single-device server "
            f"{s['match']} of {s['total']} ({s['match'] / s['total']:.3f}; JAX asks > 0.7); "
            f"launches {s['launches']} over {s['steps']} steps")
        if not (s["state_err"] < 1e-6 and s["logit_err"] < 1e-4 and s["finished"] ==
                SERVE_TP_REQUESTS and s["match"] / s["total"] > 0.7):
            fail(f"TP server: rank {r['rank']} disagrees with the single-device server")
        # the server collects ECC statistics: the correcting read, K2
        want = {"decode_attend hamming84": s["layers"] * s["steps"]}
        if s["launches"] != want:
            fail(f"TP server: launches {s['launches']}, expected {want} ({s['layers']} layers "
                 f"x {s['steps']} steps)")
        serve_l["hamming84"] = serve_l.get("hamming84", 0) + want["decode_attend hamming84"]
    return tp_l, serve_l, cp_l


SCALING_ORDER = ("single", "1x1", "1x1", "single")


def scaling_rank():
    """A spawned rank of the scaling 1x1 phase: measure_tp_mesh on a 1x1
    mesh (world size 1, NCCL) and measure_single_device in the same
    process, in SCALING_ORDER (the scaling phase's arm and shapes)."""
    import torch
    from qkv_ecc_tpu_torch.benchmarks.scaling import measure_single_device, measure_tp_mesh
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B as cfg
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
    from qkv_ecc_tpu_torch.parallel.launch import rank_device_from_env
    from qkv_ecc_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(1, 1, device=rank_device_from_env())
    pol = policy_for_mode("int12-golay", ber=BER, seed=42)
    shapes = dict(prompt_len=64, steps=20, block_size=128)
    rows = [measure_tp_mesh(cfg, pol, batch_per_data=4, mesh=mesh, **shapes) if tier == "1x1"
            else measure_single_device(cfg, pol, batch=4, device=mesh.device, **shapes)
            for tier in SCALING_ORDER]
    assert torch.distributed.get_backend() == "nccl"
    return rows, {tier: step_trace(torch, mesh, cfg, pol, tier) for tier in ("single", "1x1")}


def step_trace(torch, mesh, cfg, pol, tier, steps=3):
    """torch.profiler over ``steps`` decode steps of bench-0.9b (batch 4,
    prompt 64) through the runtime (tier "single") or the TP functions on
    ``mesh`` ("1x1"): CUDA kernels, device ms and host operations a step,
    and the collectives' events."""
    from torch.profiler import ProfilerActivity, profile
    from qkv_ecc_tpu_torch.models import runtime as rt
    from qkv_ecc_tpu_torch.models.registry import init_params
    from qkv_ecc_tpu_torch.parallel.sharding import shard_params
    from qkv_ecc_tpu_torch.parallel.tp_runtime import make_tp_functions

    dev = mesh.device
    params = init_params(cfg, 0, device=dev, dtype=cfg.torch_dtype)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    g = torch.Generator(device=dev).manual_seed(42)
    if tier == "single":
        state, bt, _ = rt.init_generation_state(cfg, pol, 4, 128, device=dev)
        logits, state = rt.prefill(params, ids, state, bt, cfg, pol, g)

        def step(tok, state):
            return rt.decode_step(params, tok, state, bt, cfg, pol, g)
    else:
        init_state, prefill, decode_step = make_tp_functions(cfg, pol, mesh)
        params = shard_params(params, cfg, mesh)
        state, bt = init_state(4, 128)
        logits, state = prefill(params, ids, state, bt, g)

        def step(tok, state):
            return decode_step(params, tok, state, bt, g)
    for _ in range(steps):  # warm-up
        logits, state = step(torch.argmax(logits, -1), state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state = step(torch.argmax(logits, -1), state)
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [e for e in events if e.device_type.name == "CUDA"]
    return dict(kernels=sum(e.count for e in cuda) / steps,
                device_ms=sum(e.self_device_time_total for e in cuda) / steps / 1e3,
                host_ops=sum(e.count for e in events if e.device_type.name == "CPU") / steps,
                collectives=sum(e.count for e in events
                                if any(w in e.key.lower() for w in ("nccl", "all_reduce",
                                                                   "allreduce", "all_gather"))))


def scaling_tp_phase(torch, smi, single_row):
    """benchmarks.scaling.measure_tp_mesh at 1x1 on the card: one rank
    through NCCL (spawned; its failure fails the run), measured beside
    measure_single_device in the same process (SCALING_ORDER), and printed
    beside this process's single-device row. The gap is the tensor-parallel
    step's overhead at TP = 1; one card gives no scaling figure. Both steps
    are traced (step_trace): the 1x1 step must launch the single-device
    step's kernels and no collective."""
    from qkv_ecc_tpu_torch.parallel.launch import spawn

    try:
        rows, traces = spawn("chip_smoke:scaling_rank", 1, backend="nccl", timeout=600)[0]
    except RuntimeError as e:
        fail(f"scaling 1x1: {e}")
    if not all(r["ms_per_step"] > 0 for r in rows) or rows[1]["mesh"] != "1x1":
        fail("scaling 1x1: no time")
    ms = {t: [r["ms_per_step"] for r, k in zip(rows, SCALING_ORDER) if k == t]
          for t in ("single", "1x1")}
    say(f"  scaling 1x1 (bench-0.9b, int12-golay, BER {BER}, batch 4, prompt 64, 20 steps, "
        f"block 128; one spawned process, NCCL world size 1), in order "
        + ", ".join(f"{t} {r['ms_per_step']:.3f}" for t, r in zip(SCALING_ORDER, rows))
        + f" ms/step: measure_tp_mesh 1x1 {json.dumps(rows[1])}; TP = 1 costs "
        f"{sum(ms['1x1']) / sum(ms['single']):.4f} x the same process's single-device step "
        f"(this process's single-device row: {single_row['ms_per_step']:.3f} ms/step; no "
        f"scaling figure: one card) ({smi})")
    say("  the same process traced (torch.profiler, 3 decode steps each), a step: "
        + "; ".join(f"{t} {x['kernels']:.1f} CUDA kernels, {x['device_ms']:.3f} device ms, "
                    f"{x['host_ops']:.0f} host operations, {x['collectives']} collective events"
                    for t, x in traces.items()) + f" ({smi})")
    # a 1x1 mesh has no process group: its step is the single-device step's
    # work and runs no collective
    single, tp = traces["single"], traces["1x1"]
    if tp["collectives"] or abs(tp["kernels"] - single["kernels"]) > 0.01 * single["kernels"]:
        fail("scaling 1x1: the TP = 1 step does other device work than the single-device step")
    return rows


def instance_checks(torch, gen, device):
    """M17: the kernel instances of tiny-gpt2 (group 1 at head_dim 16: 4/4
    heads) and trained-100m (group 3 at head_dim 64: 12/4 heads) against
    their plain versions (group1_kernel_check's checks at B 8, contexts 1
    to 512), twice: against the unsplit plain version, with the row term
    of output_tolerance scaled by SPLIT_ROW_SCALE for their S of 4 (and,
    at head_dim 16, to a 64-value row, as trained-tiny's at 32), and then
    the packed reads against the plain model of the split they take
    (split_model), at the unscaled row term. Then a shape no model
    registers raises (unbuilt_shape_check). Returns the largest error of
    each branch."""
    import dataclasses
    from qkv_ecc_tpu_torch.models.config import TINY_GPT2, TRAINED_100M

    global ROW_TERM_SCALE
    worst = {}
    for cfg, scale in ((dataclasses.replace(TINY_GPT2, num_layers=2), math.sqrt(
            math.log(64) / math.log(16))), (dataclasses.replace(TRAINED_100M, num_layers=2), 1.0)):
        for split, s in ((False, scale * SPLIT_ROW_SCALE), (True, scale)):
            ROW_TERM_SCALE = s
            try:
                with split_model() if split else contextlib.nullcontext():
                    checked = group1_kernel_check(torch, gen, device, cfg, TINY_CTX_BEFORE,
                                                  TINY_K4_CTX)
            finally:
                ROW_TERM_SCALE = 1.0
            for k, v in checked.items():
                worst[k] = max(worst.get(k, 0.0), v)
    unbuilt_shape_check(torch, device)
    return worst


# The M17 instances run at S = 4 blocks a (sequence, KV head), where gpt2's
# group-1 checks, on which output_tolerance's row term was set, run at 2.
# Each block rounds its weights to bfloat16 against its own maximum, so the
# split read's difference from the unsplit plain version is a sum of
# independent roundings of the weights that the blocks without the row's
# maximum read: (S - 1) / S of them, 1/2 at S = 2 and 3/4 at S = 4. Its
# spread grows as the square root of that share, sqrt(3/2) from S 2 to 4
# (and no more than sqrt(7/4) at S 8). Measured on an H100 without it
# (split_rounding_report): 1.0045 of the tolerance on a trained-100m K4
# hamming74 read at S 4 in one run, 0.612 in another (0.427 at S 2).
# trained-tiny's instances, at S 4 too, stayed within their head_dim scale
# alone (tiny_kernel_check).
SPLIT_ROW_SCALE = math.sqrt(1.5)


def split_rounding_report(torch, gen, device, cfg, smi):
    """How the split's rounding grows with S (SPLIT_ROW_SCALE): K4's
    hamming74 read at cfg's attention shapes (B 8, contexts TINY_K4_CTX) at
    S 1, 2, 4 and 8 blocks a (sequence, KV head), its largest |kernel -
    plain| as a share of the unscaled output_tolerance against the unsplit
    plain version and against the plain model of its split. Printed, not
    asserted: the asserted checks are instance_checks'."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import attend_plain, paged_attention_ecc

    cfg = dataclasses.replace(cfg, num_layers=2)
    ctx_list = TINY_K4_CTX
    state, bt, _ = unscrubbed_cache(torch, cfg, "int4-hamming", [max(c - 1, 0) for c in ctx_list],
                                    gen, device)
    ctx = torch.tensor(ctx_list, dtype=torch.int32, device=device)
    q = torch.randn((len(ctx_list), cfg.num_heads, cfg.head_dim), generator=gen, device=device)
    args = (q, *(state[n] for n in ("k_cache", "v_cache", "k_scales", "v_scales")), bt, ctx, 1,
            state["k_parity"], state["v_parity"])
    ppc = min(4, bt.shape[1])
    shares = {}
    for s in (1, 2, 4, 8):
        with forced_splits(s):
            out = paged_attention_ecc(*args, codec="hamming74")
            torch.cuda.synchronize()
            plain = attend_plain(*args, codec="hamming74", sm_scale=cfg.head_dim ** -0.5,
                                 num_pages=bt.shape[1], pages_per_chunk=ppc)
            with split_model():
                model = attend_plain(*args, codec="hamming74", sm_scale=cfg.head_dim ** -0.5,
                                     num_pages=bt.shape[1], pages_per_chunk=ppc)
        shares[s] = (tolerance_share(torch, out, plain), tolerance_share(torch, out, model))
    say(f"  {cfg.name} K4 hamming74, largest share of output_tolerance against the unsplit "
        "plain version / the plain model of the split, by blocks a (sequence, KV head): "
        + ", ".join(f"S {s} {a:.3f} / {b:.4f}" for s, (a, b) in shares.items()) + f" ({smi})")


def instance_times(torch, gen, device, smi):
    """M17's instances timed at their models' decode shapes
    (tiny_kernel_times): tiny-gpt2 (2 layers, 4/4 heads at head_dim 16)
    and trained-100m (14 layers, 12/4 heads at head_dim 64)."""
    from qkv_ecc_tpu_torch.models.config import TINY_GPT2, TRAINED_100M

    return {cfg.name: tiny_kernel_times(torch, gen, device, smi, cfg)
            for cfg in (TINY_GPT2, TRAINED_100M)}


# the arms of the M17 decode phase and the kernel branch each launches:
# (0: write_attend, 1: decode_attend, branch) - every instance of a
# configuration, the extract read, K2r, K3, K2f and each correcting read
M17_MODES = {"int12-golay": (0, "read"), "int4-hamming84": (0, "read"),
             "int4-hamming": (0, "read"), "int4-write-inject": (0, "read"),
             "int4": (0, "read-inject"), "int4-hamming84-interp": (1, "hamming84-interp"),
             "fp16": (0, "fp16"), "fp8": (0, "fp8"), "int12-golay/stats": (1, "golay"),
             "int4-hamming/stats": (1, "hamming74"), "int4-hamming84/stats": (1, "hamming84")}
def m17_decode_phase(torch, device, smi):
    """tiny-gpt2 and trained-100m (2 layers, random weights) decode on the
    card through their own instances: tiny_agreement in M17_MODES (prefill
    and TINY_STEPS decode steps at BER 1e-2, the card against the CPU on
    the same weights and draws: logits, tokens and ECC counts), each
    branch's launches exact. Returns the launches by branch."""
    import dataclasses
    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        paged_attention_ecc_write_attend as write_attend, write_decode_attend)
    from qkv_ecc_tpu_torch.models.config import TINY_GPT2, TRAINED_100M

    launches = ({}, {})
    for cfg in (TINY_GPT2, dataclasses.replace(TRAINED_100M, num_layers=2)):
        reset_counts(write_attend, write_decode_attend)
        tiny_agreement(torch, device, cfg, tuple(M17_MODES))
        torch.cuda.synchronize()
        want = ({}, {})
        for i, branch in M17_MODES.values():
            want[i][branch] = want[i].get(branch, 0) + cfg.num_layers * TINY_STEPS
        how = f"{cfg.num_layers} layers x {TINY_STEPS} steps x the arms that call it"
        check_launches(f"M17 decode {cfg.name}", {
            f"{name} {k}": (w.launches_by[k], want[i].get(k, 0), how)
            for i, (name, w) in enumerate((("write_attend", write_attend),
                                           ("decode_attend", write_decode_attend)))
            for k in w.launches_by})
        for i, w in enumerate((write_attend, write_decode_attend)):
            for k, v in w.launches_by.items():
                launches[i][k] = launches[i].get(k, 0) + v
    return launches


def golay_sliced_check(torch, device):
    """M12: kernels/golay_sliced.py (plain torch, no kernel) on CUDA
    tensors equals its CPU result: the bit-sliced pack, the IMLD network
    with its error planes, the nibble words and the error counts, on 3072
    codewords a column with 0-5 flips each."""
    from qkv_ecc_tpu_torch.kernels import common as C
    from qkv_ecc_tpu_torch.kernels import golay_sliced as gs
    from qkv_ecc_tpu_torch.kernels.swar import _B_MASKS

    G, bs = 12, 128
    g = torch.Generator().manual_seed(9)
    data = torch.randint(0, 4096, (32 * G, bs), generator=g, dtype=torch.int32)
    cw = C.golay_encode_i32(data, _B_MASKS)
    for _ in range(5):
        flip = torch.randint(0, 2, cw.shape, generator=g, dtype=torch.int32)
        cw = cw ^ (flip << torch.randint(0, 24, cw.shape, generator=g, dtype=torch.int32))
    outs = []
    for dev in ("cpu", device):
        w = gs.golay_slice_pack(cw.to(dev), G, axis=0)
        dec, corr, (ed, ep) = gs.golay_sliced_correct_planes(w, G, full_errors=True)
        valid = gs.valid_row_masks(G, 32 * G).to(dev)[:, None].expand(G, bs).contiguous()
        counts = torch.stack(gs.sliced_error_count(ed, ep, corr, valid, G))
        outs.append([x.cpu() for x in (w, dec, corr, ed, ep, counts,
                                       *gs.sliced_nibble_words(dec, G),
                                       gs.golay_slice_unpack(w, G, axis=0))])
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    say(f"  golay_sliced on cuda equals the CPU: {same} (G {G}, {32 * G} x {bs} codewords; "
        f"corrected bits {int(outs[0][5][0])}, uncorrectable {int(outs[0][5][1])})")
    if not same:
        fail("golay_sliced: the card's result differs from the CPU's")


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


def bound(nbytes, flops):
    """(least ms, "bytes" or "operations", bytes ms, operations ms): bytes at
    3.35 TB/s, fp32 flops at 67 T/s. Integer operations have no rate in the
    data sheet and their count from the source is not the instructions that
    run (int_estimate): they are left out of the bound."""
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * flops / PEAK_FP32_FLOPS
    return max((bytes_ms, "bytes"), (ops_ms, "operations")) + (bytes_ms, ops_ms)


def int_estimate(int_ops):
    """The integer operations counted from the source as a time at Hopper's
    32-bit integer rate, in words for a printed line: an estimate, not a
    bound (LOP3 and IADD3 fuse several operations into one instruction,
    popcounts issue at a quarter of the rate, and a branch may skip some)."""
    return (f"integer operations counted from the source {int_ops / 1e6:.1f} M, "
            f"{1e6 * int_ops / INT32_OPS_PER_S:.2f} us at 16.7 T/s (an estimate, not a bound)")


# the packed kernels' rows that core_compare times at each shape: (key,
# cache, codec, options, K4 read)
COMPARE_ROWS = (
    ("read", "scrubbed", "golay", dict(scrub=True), False),
    ("read-inject", "int4", "int4", dict(read_inject_ber=BER), False),
    ("hamming84-interp", "int4-hamming84", "hamming84", dict(use_interpolation=True), False),
    ("hamming84", "int4-hamming84", "hamming84", {}, False),
    ("hamming74", "int4-hamming", "hamming74", {}, False),
    ("golay", "int12-golay", "golay", {}, False),
    ("k4-read", "scrubbed", "golay", dict(scrub=True), True),
    ("k4-read-inject", "int4", "int4", dict(read_inject_ber=BER), True),
    ("k4-hamming84-interp", "int4-hamming84", "hamming84", dict(use_interpolation=True), True),
    ("k4-hamming84", "int4-hamming84", "hamming84", {}, True),
    ("k4-hamming74", "int4-hamming", "hamming74", {}, True),
    ("k4-golay", "int12-golay", "golay", {}, True),
)


# the codec rows that core_compare times (the kernels of
# csrc/codec_kernels.cu on packed Hamming words and Golay's syndrome table)
COMPARE_CODECS = ("hamming74_encode", "hamming84_encode", "hamming74_decode", "hamming84_decode",
                  "golay_decode_packed", "golay_write_scrub")


def core_compare(torch, other):
    """python3 chip_smoke.py --compare-with DIR: the codec kernels
    (COMPARE_CODECS, on codec_cases' inputs, each tree's wrappers cycling
    the 8 copies) and the packed kernels (every
    row of COMPARE_ROWS: K1's extract read, K2r, K3, K2 hamming84 /
    hamming74 / golay and their K4 reads) of this tree and of DIR's (another
    checkout's qkv_ecc_tpu_torch, such as `git archive` of the parent
    commit, built from its own sources and launched by its own wrappers,
    its own split rule included), timed in one process on the same caches,
    in the order DIR, this, this, DIR, by device_ms (240 calls behind a
    sleep, every layer cycled), at bench-0.9b's decode step (batch 8, 24
    layers, ctx 1056) and at the group-1 instances' (gpt2: 12 layers, ctx
    928; trained-tiny: 6 layers, ctx 480; K4 rows at bench-0.9b's alone).
    Caches as tiny_kernel_times makes them (BER 2e-2 in the unscrubbed
    ones). Prints each row's four times, the best of each tree, their
    ratio, this tree's share of the bytes bound (the bytes at 3.35 TB/s),
    and its blocks per (sequence, KV head), threads, shared memory and
    warps per SM; a codec row its four times, the best of each, their ratio
    and the shares of the bytes bound."""
    import importlib
    import importlib.util
    from pathlib import Path

    from qkv_ecc_tpu_torch.kernels import _build
    from qkv_ecc_tpu_torch.kernels import codec_kernels as ck
    from qkv_ecc_tpu_torch.kernels import paged_attention as pa
    from qkv_ecc_tpu_torch.models.config import BENCH_0_9B, GPT2_124M, TRAINED_TINY

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the comparison needs an NVIDIA card")
    device = torch.device("cuda:0")
    smi = smi_name_power()
    say(f"  torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {smi}")
    # DIR's package under another name (its imports are relative)
    root = Path(other) / "qkv_ecc_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "other_qkv_ecc_tpu_torch", root / "__init__.py", submodule_search_locations=[str(root)])
    sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sys.modules[spec.name])
    opa = importlib.import_module(spec.name + ".kernels.paged_attention")
    ock = importlib.import_module(spec.name + ".kernels.codec_kernels")
    obuild = importlib.import_module(spec.name + ".kernels._build")
    names = ("write_attend", "decode_attend", "codec_kernels")
    for b in _build.build_all(names) + obuild.build_all(names):
        say(f"  {b.path}: built in {b.seconds:.2f} s")
    gen = torch.Generator(device=device).manual_seed(0)
    sms = pa._sm_count(0)
    cases = codec_cases(torch, gen, device, ck)
    crows = []  # (name, {tree: (call, wrapper)}, copies, bytes)
    for name in COMPARE_CODECS:
        inputs, nbytes = cases[name][:2]
        crows.append((name, {tree: ((lambda i, w=getattr(mod, name + "_cuda"), a=inputs:
                                     w(*a[i])), getattr(mod, name + "_cuda"))
                             for tree, mod in (("other", ock), ("this", ck))},
                      len(inputs), nbytes))
    rows = []  # (label, {tree: (call, wrapper)}, layers, bytes, S, data words, smem, Hkv)
    for cfg, tokens, k4 in ((BENCH_0_9B, 1056, True), (GPT2_124M, 928, False),
                            (TRAINED_TINY, 480, False)):
        Hkv, D, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        group = cfg.num_heads // Hkv
        ctx_before = [tokens - 1] * BATCH
        ctx = torch.full((BATCH,), tokens, dtype=torch.int32, device=device)
        caches = {"scrubbed": encoded_cache(torch, cfg, "golay", ctx_before, 128, gen, device),
                  "int4": encoded_cache(torch, cfg, "int4", ctx_before, 128, gen, device)}
        for mode in ("int4-hamming84", "int4-hamming", "int12-golay"):
            caches[mode] = unscrubbed_cache(torch, cfg, mode, ctx_before, gen, device)
        q = torch.randn((BATCH, cfg.num_heads, D), generator=gen, device=device)
        if cfg is BENCH_0_9B:
            q = q.to(torch.bfloat16)
        sn = torch.ones((BATCH, Hkv), device=device)
        names4 = ("k_cache", "v_cache", "k_scales", "v_scales")
        for key, mode, codec, kw, read in COMPARE_ROWS:
            if read and not k4:
                continue
            state, bt = caches[mode][:2]
            extract = codec == "int4" or kw.get("scrub")
            parity = () if extract else (state["k_parity"], state["v_parity"])
            words = state["k_cache"].shape[3] + (0 if extract else parity[0].shape[3])
            new = torch.zeros((BATCH, Hkv, words), dtype=torch.int32, device=device)
            kw = dict(kw)
            if "read_inject_ber" in kw:
                kw["read_inject_seed"] = 5
            calls = {}
            for tree, mod in (("other", opa), ("this", pa)):
                if read:
                    def call(layer, mod=mod, state=state, bt=bt, parity=parity, codec=codec,
                             kw=kw, q=q, ctx=ctx):
                        return mod.paged_attention_ecc(q, *(state[n] for n in names4), bt, ctx,
                                                       layer, *parity, codec=codec, **kw)
                    calls[tree] = (call, mod.paged_attention_ecc)
                else:
                    def call(layer, mod=mod, state=state, bt=bt, parity=parity, codec=codec,
                             kw=kw, q=q, new=new, sn=sn, ctx=ctx):
                        return mod.paged_attention_ecc_write_attend(
                            q, new, new, sn, sn, *(state[n] for n in names4), bt, ctx, layer,
                            *parity, codec=codec, **kw)
                    calls[tree] = (call, mod.paged_attention_ecc_write_attend if extract
                                   else mod.write_decode_attend)
            nbytes = (tokens * BATCH * Hkv * 2 * (words * 4 + 4) + 2 * q.numel() * q.element_size()
                      + (0 if read else 2 * BATCH * Hkv * (words * 4 + 4))
                      + bt.numel() * 4 + BATCH * 4)
            inject, wd = "read_inject_ber" in kw, state["k_cache"].shape[3]
            s = pa.packed_splits(BATCH, Hkv, pa.visited_pages(bt.shape[1], min(4, bt.shape[1])),
                                 sms, wd)
            smem = pa.packed_smem(wd, group, 128, s, parity_words=words - wd,
                                  staged=inject or codec in ("hamming74", "golay"),
                                  ring=not inject, edges=bool(kw.get("use_interpolation")))
            rows.append((f"{cfg.name} {key}", calls, L, nbytes, s, wd, smem, Hkv))
    times = {r[0]: {"other": [], "this": []} for r in rows + crows}
    for tree in ("other", "this", "this", "other"):
        for label, calls, L, *_ in rows + crows:
            call, wrapper = calls[tree]
            times[label][tree].append(device_ms(torch, call, 240, L, wrapper))
    for label, _, _, nbytes in crows:
        t = times[label]
        best_o, best_t = min(t["other"]), min(t["this"])
        b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        say(f"  codec {label}: {other} " + " / ".join(f"{x * 1e3:.2f}" for x in t["other"])
            + " us, this tree " + " / ".join(f"{x * 1e3:.2f}" for x in t["this"])
            + f" us; best {best_o * 1e3:.2f} -> {best_t * 1e3:.2f} us "
            f"(this / {other} {best_t / best_o:.3f}); bytes bound {b_ms * 1e3:.2f} us "
            f"({nbytes / 1e6:.2f} MB), share {b_ms / best_t:.3f} -> was {b_ms / best_o:.3f} "
            f"({smi})")
    for label, _, _, nbytes, s, wd, smem, Hkv in rows:
        t = times[label]
        best_o, best_t = min(t["other"]), min(t["this"])
        threads = pa.packed_threads(wd)
        say(f"  {label}: {other} " + " / ".join(f"{x * 1e3:.2f}" for x in t["other"])
            + " us, this tree " + " / ".join(f"{x * 1e3:.2f}" for x in t["this"])
            + f" us; best {best_o * 1e3:.2f} -> {best_t * 1e3:.2f} us "
            f"(this / {other} {best_t / best_o:.3f}); bytes bound "
            f"{nbytes / PEAK_BYTES_PER_S * 1e6:.2f} us ({nbytes / 1e6:.2f} MB), share "
            f"{nbytes / PEAK_BYTES_PER_S / (best_t * 1e-3):.3f} -> was "
            f"{nbytes / PEAK_BYTES_PER_S / (best_o * 1e-3):.3f}; this tree's launch: S {s}, "
            f"{threads} threads and {smem} B of shared memory a block, "
            f"{BATCH * Hkv * s * threads / 32 / sms:.1f} warps per SM on {sms} SMs ({smi})")
    return 0


def main():
    import dataclasses

    import torch

    if sys.argv[1:2] == ["--compare-with"]:
        return core_compare(torch, sys.argv[2])

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    try:
        import qkv_ecc_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port package is missing ({e}): run from the repository root")
    from qkv_ecc_tpu_torch.kernels import _build, swar
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
        max_err_k4 = attend_check(torch, gen, device)
        max_err_split = split_check(torch, gen, device)
        page_edge_check(torch, gen, device)

    with Phase("gpt2 kernel check"):
        max_err_gpt2 = gpt2_kernel_check(torch, gen, device)

    with Phase("trained-tiny kernel check"):
        max_err_tiny = tiny_kernel_check(torch, gen, device)
        tiny_kernel_times(torch, gen, device, smi)

    with Phase("M17 kernel check"):
        max_err_m17 = instance_checks(torch, gen, device)
        from qkv_ecc_tpu_torch.models.config import TRAINED_100M

        split_rounding_report(torch, gen, device, TRAINED_100M, smi)
        instance_times(torch, gen, device, smi)

    with Phase("tiny agreement"):
        tiny_agreement(torch, device)

    with Phase("M17 decode"):
        m17_launches = m17_decode_phase(torch, device, smi)

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

    with Phase("gpt2"):
        from qkv_ecc_tpu_torch.models.config import GPT2_124M

        gpt2_params = init_params(GPT2_124M, seed=0, device=device)
        gpt2_ids = torch.randint(0, GPT2_124M.vocab_size, (BATCH, GPT2_PROMPT), generator=gen,
                                 device=device)
        gpt2_runs, gpt2_stats_runs, gpt2_launches = gpt2_decode_phase(
            torch, gpt2_params, gpt2_ids, device, smi)
        gpt2_loss_phase(torch, gpt2_params, device, smi)
        gpt2_forward_check(torch, gpt2_params, gpt2_ids, device, smi)
        gpt2_serve_and_sample(torch, gpt2_params, device)
        gpt2_kernel_times(torch, gpt2_runs, gpt2_stats_runs, device, smi)
        del gpt2_runs, gpt2_stats_runs, gpt2_params

    # the quality path: run_sweep's forwards launch no kernel (as JAX's)
    with Phase("quality gpt2"):
        reset_counts(*kernel_wrappers())
        quality_gpt2_phase(torch, device, smi)
        check_no_launches("quality gpt2")

    with Phase("quality trained-tiny"):
        reset_counts(*kernel_wrappers())
        quality_tiny_phase(torch, smi)
        check_no_launches("quality trained-tiny")

    # the checkpoints and results the card runs write go to a temporary
    # directory, never to results/ (whose checkpoints are tracked)
    with Phase("train"), tempfile.TemporaryDirectory() as work:
        train_launches = train_phase(torch, device, smi, work)

    with Phase("experiments"), tempfile.TemporaryDirectory() as work:
        experiments_launches = experiments_phase(torch, device, smi, work)

    with Phase("codec kernels"):
        max_err_codec = codec_kernel_check(torch, gen, device)

    with Phase("harness"):
        max_err_g4 = group4_check(torch, gen)
        harness_launches = harness_phase(torch, smi)

    with Phase("scaling"):
        single_row, scaling_launches = scaling_phase(torch, smi)

    with Phase("scaling 1x1"):
        scaling_tp_phase(torch, smi, single_row)

    with Phase("parallel"):
        tp_launches, tp_serve_launches, cp_launches = parallel_phase(torch, smi)

    with Phase("golay_sliced"):
        golay_sliced_check(torch, device)

    with Phase("kernel timing"):
        group = cfg.num_heads // cfg.num_kv_heads
        q = torch.randn((BATCH, cfg.num_heads, cfg.head_dim), generator=gen,
                        device=device).to(torch.bfloat16)
        names = ("k_cache", "v_cache", "k_scales", "v_scales")
        sm = cfg.head_dim ** -0.5
        sn = torch.ones((BATCH, cfg.num_kv_heads), dtype=torch.float32, device=device)
        timings = {}

        # the integer work of Golay's decode and of the read hashes, counted
        # in the built libraries' SASS, and the card's SMs and largest clock
        from qkv_ecc_tpu_torch.kernels import paged_attention as pa_module
        from qkv_ecc_tpu_torch.kernels import sass_count

        sass = sass_count.probe_counts()
        clock = sass_count.max_sm_clock_hz()
        sms = pa_module._sm_count(0)
        for probe, ((_, fn), _, units, unit) in sass_count.PROBES.items():
            say(f"  {fn[:-1]}: SASS instructions per {unit}: "
                + ", ".join(f"{k} {v:.2f}" for k, v in sass[probe].items())
                + f" (cuobjdump -sass of the built library; {sms} SMs, largest SM clock "
                f"{clock / 1e9:.3f} GHz; {smi})")

        def time_kernel(key, label, call, plain, wrapper, state, bt, words_read, int_ops, row_w,
                        word_bytes=4, scale_bytes=4, library=None, note="", probe=None):
            """Device time (behind a sleep), back-to-back time, the plain
            version's time, the library call's (when one computes the same
            function) and the bound of one call on `state`'s caches; row_w
            words of a new row per (sequence, KV head) are written (0: a
            read, K4). A float cache reads values of word_bytes and no
            scales (scale_bytes 0). note is printed after the label. With
            probe ("golay", "hash"), int_ops(tokens, Hkv) counts that
            probe's units and the integer bound (sass_count) is printed and
            kept as int_bound_ms; else int_ops counts integer operations
            from the source, printed as an estimate."""
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
            # fp32, and the integer work
            nbytes = (tokens * Hkv * 2 * (words_read * word_bytes + scale_bytes)
                      + 2 * q.numel() * q.element_size()
                      + (2 * BATCH * Hkv * (row_w * word_bytes + scale_bytes) if row_w else 0)
                      + bt.numel() * 4 + BATCH * 4)
            flops = 2 * 2 * tokens * Hkv * group * cfg.head_dim
            b_ms, b_by, bytes_ms, ops_ms = bound(nbytes, flops)
            int_ms = None
            if probe is None:
                integer = int_estimate(int_ops(tokens, Hkv))
            else:
                units = int_ops(tokens, Hkv)
                int_ms, pipe = sass_count.int_bound_ms(sass[probe], units, sms, clock)
                unit = sass_count.PROBES[probe][3]
                integer = (f"integer bound {int_ms * 1e3:.2f} us by the {pipe} pipe ({units / 1e6:.2f} M "
                           f"{unit}s, SASS counts above); share of the integer bound "
                           f"{int_ms / ms:.3f}; the {'integer' if int_ms > b_ms else b_by} bound binds")
            say(f"  {label} at ctx {tokens // BATCH}{note}: {ms * 1e3:.2f} us/launch on the device "
                f"(CUDA events, calls queued behind a sleep; {call_ms * 1e3:.2f} us per "
                f"back-to-back call, host included); bound {b_ms * 1e3:.2f} us by {b_by} "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s = {bytes_ms * 1e3:.2f} us; "
                f"{flops / 1e6:.1f} MFLOP fp32 at 67 T/s = {ops_ms * 1e3:.2f} us; "
                f"{integer}); share of bound {b_ms / ms:.3f}; plain version "
                f"{plain_ms * 1e3:.1f} us; library call: "
                + ("none" if library_ms is None else
                   f"{library_ms * 1e3:.2f} us (scaled_dot_product_attention, dense bf16 K/V)")
                + f" ({smi})")
            timings[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms, int_bound_ms=int_ms)
            return ms

        golay_pw = swar.parity_words("golay", cfg.head_dim)

        def codewords(tok, h):  # golay: 44 codewords a row at head_dim 128, K and V
            return tok * h * 2 * 4 * (Wd + golay_pw) // 3

        def hashes(tok, h):  # 32 a data word read, K and V
            return tok * h * 2 * Wd * 32

        def sweep(label, call, wrapper, what):
            """The read at S = 1, 2, 4 and 8 blocks per (sequence, KV
            head), packed_splits replaced for the sweep alone."""
            times = {}
            for forced in (1, 2, 4, 8):
                with forced_splits(forced):
                    times[forced] = device_ms(torch, call, 240, cfg.num_layers, wrapper)
            say(f"  {label} at S blocks per sequence and KV head: "
                + ", ".join(f"S {k} {v * 1e3:.2f} us" for k, v in times.items())
                + f" (the rule's: {what}; {smi})")

        def against(kind, key, ms):
            """The required time (a miss fails the run) and the targets."""
            met = ms * 1e3 <= REQUIRED_US[kind]
            int_ms = timings[key]["int_bound_ms"]
            say(f"  {key} {kind}: {ms * 1e3:.2f} us; required at most {REQUIRED_US[kind]:.0f} us: "
                f"{'met' if met else 'MISSED'}; target at most "
                f"{TARGET_US[kind]:.0f} us: {'met' if ms * 1e3 <= TARGET_US[kind] else 'missed'}; "
                + ("" if int_ms is None else
                   f"target at least 0.5 of the integer bound: "
                   f"{'met' if int_ms / ms >= 0.5 else 'missed'} ({int_ms / ms:.3f}; ")
                + f"share of the bound {timings[key]['bound_ms'] / ms:.3f}; {smi})")
            if not met:
                fail(f"{key}: {ms * 1e3:.2f} us misses the required {REQUIRED_US[kind]:.0f} us")

        # K1 on the golay arm's cache (the column at ctx-1 is rewritten)
        state, bt = runs["int12-golay"][-1]["state"], runs["int12-golay"][-1]["bt"]
        Wd = state["k_cache"].shape[3]
        ctx = state["context_len"].clone()
        kn = torch.zeros((BATCH, cfg.num_kv_heads, Wd), dtype=torch.int32, device=device)
        s_rule = splits_label(torch, BATCH, cfg.num_kv_heads, bt.shape[1], 4, Wd)
        time_kernel(
            "read", "write_attend (scrub-extract read)",
            lambda layer: write_attend(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                       layer, codec="golay", scrub=True),
            lambda layer: write_attend_plain(q, kn, kn, sn, sn, *(state[n] for n in names), bt,
                                             ctx, layer, sm_scale=sm),
            write_attend, state, bt, Wd, lambda tok, h: 0, Wd, note=f" ({s_rule})")
        against("extract", "read", timings["read"]["ms"])

        # K2r on the stats phase's int4 cache, seed on the device
        state, bt = (stats_runs["int4"][k] for k in ("state", "bt"))
        ctx = state["context_len"].clone()
        seed = torch.randint(-2 ** 31, 2 ** 31, (), generator=gen, device=device).to(torch.int32)
        k2r_ms = time_kernel(
            "read-inject", f"write_attend int4 read-inject BER {BER}",
            lambda layer: write_attend(q, kn, kn, sn, sn, *(state[n] for n in names), bt, ctx,
                                       layer, codec="int4", read_inject_ber=BER,
                                       read_inject_seed=seed),
            lambda layer: write_attend_plain(q, kn, kn, sn, sn, *(state[n] for n in names), bt,
                                             ctx, layer, sm_scale=sm,
                                             read_threshold=int(BER * 2 ** 32), read_seed=seed,
                                             pages_per_chunk=4),
            write_attend, state, bt, Wd, hashes, Wd, note=f" ({s_rule})", probe="hash")
        against("read-inject", "read-inject", k2r_ms)

        # decode_attend: hamming84 on the interpolation arm's cache, hamming74
        # and golay on the stats phase's unscrubbed caches
        for key, codec, src, interp, per_row, probe in (
                ("hamming84-interp", "hamming84", runs["int4-hamming84-interp"][-1], True,
                 lambda w, p: w * (DECODE_OPS_PER_WORD + INTERP_OPS_PER_WORD), None),
                ("hamming84", "hamming84", runs["int4-hamming84-interp"][-1], False,
                 lambda w, p: w * DECODE_OPS_PER_WORD, None),
                ("hamming74", "hamming74", stats_runs["int4-hamming"], False,
                 lambda w, p: w * H74_OPS_PER_WORD, None),
                ("golay", "golay", stats_runs["int12-golay"], False, None, "golay")):
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

            ops = codewords if probe else (lambda tok, h, f=per_row, p=Pw: tok * h * 2 * f(Wd, p))
            t = time_kernel(key, f"decode_attend {key}", call_d, plain_d, write_decode_attend,
                            state, bt, Wd + Pw, ops, Wd + Pw, note=f" ({s_rule})", probe=probe)
            if probe or key.startswith("hamming84"):
                against(key, key, t)

        # K4, the read alone, on the same caches: each branch as above
        for key, codec, src, kw, per_row, probe in (
                ("read", "golay", runs["int12-golay"][-1], dict(scrub=True), lambda w, p: 0, None),
                ("read-inject", "int4", stats_runs["int4"], dict(read_inject_ber=BER), None,
                 "hash"),
                ("hamming84-interp", "hamming84", runs["int4-hamming84-interp"][-1],
                 dict(use_interpolation=True),
                 lambda w, p: w * (DECODE_OPS_PER_WORD + INTERP_OPS_PER_WORD), None),
                ("hamming84", "hamming84", runs["int4-hamming84-interp"][-1], {},
                 lambda w, p: w * DECODE_OPS_PER_WORD, None),
                ("hamming74", "hamming74", stats_runs["int4-hamming"], {},
                 lambda w, p: w * H74_OPS_PER_WORD, None),
                ("golay", "golay", stats_runs["int12-golay"], {}, None, "golay")):
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

            ops = ({"golay": codewords, "hash": hashes}[probe] if probe else
                   (lambda tok, h, f=per_row, p=Pw: tok * h * 2 * f(Wd, p)))
            inject = "read_inject_ber" in kw
            t = time_kernel("k4-" + key, f"paged_attention_ecc {key} (K4)", call_k4, plain_k4,
                            paged_attention_ecc, state, bt, Wd + Pw, ops, 0,
                            note=f" ({s_rule})", probe=probe)
            if probe:
                against("read-inject" if inject else "golay", "k4-" + key, t)
                sweep(f"paged_attention_ecc {key} (K4)", call_k4, paged_attention_ecc,
                      s_rule)

        # K2f on the float arms' caches of the slice, the write+attend and
        # the read; fp16's yardstick: scaled_dot_product_attention over the
        # same context stored dense ([B, Hkv, ctx, D] bf16, GQA), not paged
        from qkv_ecc_tpu_torch.kernels.paged_attention import (
            _sm_count, float_splits, gather_pages, visited_pages)

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

            # what the kernel reads beyond the bound's bytes: the V of every
            # slot of the visited pages (a dead slot's NaN reaches the output)
            ppc = min(4, bt.shape[1])  # 512-token chunks of 128-token pages
            tpc, chunks = ppc * 128, -(-bt.shape[1] // ppc)
            visited = sum(min(-(-c // tpc), chunks) * tpc for c in ctx.tolist())
            read_mb = (int(ctx.sum()) + visited) * cfg.num_kv_heads * D * elem / 1e6
            s = float_splits(BATCH, cfg.num_kv_heads, visited_pages(bt.shape[1], ppc) * 128,
                             elem, _sm_count(0))
            note = (f" (S {s} blocks per sequence and KV head; the K of the live tokens and the V "
                    f"of every visited slot, the dead pages' too: {read_mb:.2f} MB, "
                    f"{read_mb * 1e12 / PEAK_BYTES_PER_S:.2f} us at 3.35 TB/s)")
            no_ops = lambda tok, h: 0  # noqa: E731
            time_kernel(codec, f"float_attend {codec} write+attend (K2f)", call_w, plain_w,
                        write_attend, state, bt, D, no_ops, D, word_bytes=elem, scale_bytes=0,
                        library=library, note=note)
            time_kernel("k4-" + codec, f"paged_attention_ecc {codec} (K2f read)", call_r,
                        plain_r, paged_attention_ecc, state, bt, D, no_ops, 0, word_bytes=elem,
                        scale_bytes=0, library=library, note=note)
            del library
            # the read at every split count (float_splits replaced for the
            # sweep alone), and with no token: the launch's fixed cost
            sweep = {}
            for forced in (1, 2, 4, 8):
                pa_module.float_splits = lambda *a, forced=forced: forced
                try:
                    sweep[forced] = device_ms(torch, call_r, 240, cfg.num_layers,
                                              paged_attention_ecc)
                finally:
                    pa_module.float_splits = float_splits
            none = torch.zeros_like(ctx)
            fixed = device_ms(torch, lambda layer, none=none: call_r(layer, ctx=none), 240,
                              cfg.num_layers, paged_attention_ecc)
            say(f"  paged_attention_ecc {codec} (K2f read) at S blocks per sequence and KV head: "
                + ", ".join(f"S {k} {v * 1e3:.2f} us" for k, v in sweep.items())
                + f"; with no token (ctx 0, S {s}): {fixed * 1e3:.2f} us ({smi})")

        timings.update(codec_timing(torch, gen, device, smi, sass, sms, clock))

    with Phase("trace"):
        trace_decode(torch, params, ids, gen, device, smi)
        gpt2_params = init_params(GPT2_124M, seed=0, device=device)
        # two steps an arm: the profiler's events take most of the phase
        trace_decode(torch, gpt2_params, gpt2_ids, gen, device, smi, GPT2_124M, steps=2)
        del gpt2_params

    from qkv_ecc_tpu_torch.kernels.paged_attention import (
        DECODE_KERNEL_SHAPES, FLOAT_KERNEL_SHAPES, KERNEL_SHAPES)

    def instances(key, source):
        """The instances built for a row: (data words, group, head_dim) of the
        packed reads, (codec, data words, parity words, group, head_dim) of
        the correcting reads, (group, head_dim) of K2f."""
        if key.removeprefix("k4-") in ("fp16", "fp8"):
            return [list(x) for x in FLOAT_KERNEL_SHAPES]
        if source == "decode_attend.cu":
            codec = key.removeprefix("k4-").removesuffix("-interp")
            return [list(x) for x in DECODE_KERNEL_SHAPES if x[0] == codec]
        if source == "write_attend.cu":
            return [list(x) for x in KERNEL_SHAPES]
        return None

    def entry(name, key, source, replaces, launches, err):
        return dict(name=name, route="cuda", source=f"qkv_ecc_tpu_torch/csrc/{source}",
                    replaces=f"qkv_ecc_tpu/kernels/{replaces}", launches=launches,
                    max_abs_err=err, instances=instances(key, source), **timings[key])

    # the write+attend kernels' launches over the decode slice, the stats
    # phase, the serve phase, gpt2's decode and stats, the generation demo on
    # the card-trained trained-tiny and the fault-tolerance benchmark; K4's
    # over the engine phase
    sl, st, sv, g2, k4 = slice_launches, stats_launches, serve_launches, gpt2_launches, k4_launches
    tg, fx = train_launches, experiments_launches

    # and the M17 decode phase's, the TP arms' and the TP server's (summed
    # over the ranks); CP's K4 reads
    par = ({k.split(" ", 1)[1]: v for k, v in tp_launches.items() if k.startswith("write_")},
           {k.split(" ", 1)[1]: v for k, v in tp_launches.items() if k.startswith("decode_")})

    def wa(i, k):
        return (sl[i][k] + st[i][k] + sv[i][k] + g2[i][k] + tg[i][k] + fx[i][k]
                + m17_launches[i].get(k, 0) + par[i].get(k, 0)
                + (tp_serve_launches.get(k, 0) if i == 1 else 0))

    def g(key, err):  # with the errors of the group-1, -3 and head_dim-16 instances' checks
        return max(err, max_err_gpt2.get(key, 0.0), max_err_tiny.get(key, 0.0),
                   max_err_m17.get(key, 0.0))

    # the kernel benchmark's launches of K4 (group 4) and of K5-K9, and the
    # scaling row's of K1
    k4 = dict(k4, hamming84=k4["hamming84"] + harness_launches[("paged_attention_ecc",
                                                                 "hamming84")])
    # CP's reads (the ranks' K4 with its softmax state, parallel_phase)
    k4 = {k: v + cp_launches.get(k, 0) for k, v in k4.items()}

    def k4_err(key, err):  # with the group-4 check's error on the branch
        return max(err, max_err_g4.get(key, 0.0))

    def hv(key):
        return sum(n for (name, _), n in harness_launches.items() if name == key + "_cuda")

    table = {"kernels": [
        entry("write_attend", "read", "write_attend.cu", "paged_attention.py:1056",
              wa(0, "read") + scaling_launches, g("read", max_err)),
        entry("write_attend read-inject (K2r)", "read-inject", "write_attend.cu",
              "paged_attention.py:352", wa(0, "read-inject"),
              g("read-inject", max_err_split["inject"])),
        entry("decode_attend", "hamming84-interp", "decode_attend.cu", "paged_attention.py:677",
              wa(1, "hamming84-interp"), g("hamming84-interp", max_err_decode["hamming84-interp"])),
        entry("decode_attend hamming84 (K2)", "hamming84", "decode_attend.cu",
              "paged_attention.py:135", wa(1, "hamming84"),
              g("hamming84", max_err_decode["hamming84"])),
        entry("decode_attend hamming74 (K2)", "hamming74", "decode_attend.cu",
              "paged_attention.py:143", wa(1, "hamming74"),
              g("hamming74", max_err_decode["hamming74"])),
        entry("decode_attend golay (K2)", "golay", "decode_attend.cu", "paged_attention.py:154",
              wa(1, "golay"), g("golay", max(max_err_decode["golay"], max_err_split["golay"]))),
    ] + [
        entry(f"paged_attention_ecc {k} (K4)", "k4-" + k,
              "write_attend.cu" if k in ("read", "read-inject") else "decode_attend.cu",
              "paged_attention.py:828", k4[k],
              g("k4-" + k, k4_err(k, max(max_err_k4[k], max_err_k4["extract"]) if k == "read"
                     else max(max_err_k4[k], max_err_split["inject"]) if k == "read-inject"
                     else max(max_err_k4[k], max_err_split["k4_golay"]) if k == "golay"
                     else max_err_k4[k])))
        for k in ("read", "read-inject", "hamming84", "hamming84-interp", "hamming74", "golay")
    ] + [
        entry(f"float_attend {c} write+attend (K2f)", c, "write_attend.cu",
              "paged_attention.py:300", wa(0, c), g(c, max_err_float[(c, "write")]))
        for c in ("fp16", "fp8")
    ] + [
        entry(f"paged_attention_ecc {c} (K2f read)", "k4-" + c, "write_attend.cu",
              "paged_attention.py:300", k4[c],
              g("k4-" + c, k4_err("k4-" + c, max_err_float[(c, "read")])))
        for c in ("fp16", "fp8")
    ] + [
        # K5-K9: the largest difference from the plain version measured in
        # the codec kernels' check (which fails unless it is 0)
        entry(name, key, "codec_kernels.cu", replaces, hv(key), max_err_codec[key])
        for name, key, replaces in CODEC_KERNELS
    ]}
    say(f"total {time.perf_counter() - T0:.1f} s")
    say(json.dumps(table))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
