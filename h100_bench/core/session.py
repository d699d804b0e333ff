"""One run of one cell: set-up, warm-up, the timed window, the traced
stretch, and what the check needs afterwards.

The window drives ``qkv_ecc_tpu_torch.models.runtime.decode_step`` in a
loop of its own, greedily (argmax on the device), and copies each step's
tokens to the host, as a streaming client receives them. The loop runs in
rounds of the cell's new tokens; a round restores every row's context
length to its prompt's end and feeds the prefill's token again, so the mix
of contexts is the same all through the window whatever the speed. Each
round's write flips come from a generator seeded by (seed, round), the
prefill's from one seeded by (seed, group), so the check can draw them
again.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from . import traffic as tr
from .spec import arch_module
from .trace import Trace, traced
from .weights import make_weights

WARMUP_STEPS = 3  # decode steps at the cell's own shapes before the window


def spin_ms(n: int = 200_000) -> float:
    """A fixed pure-Python loop, timed: the host core's own speed, which
    paces the enqueue of a step and drifts apart from anything the program
    does. Taken just before and just after the window."""
    t = time.perf_counter()
    x = 0
    for k in range(n):
        x += k
    return (time.perf_counter() - t) * 1e3


@dataclasses.dataclass
class Run:
    """What the metric readers see (metrics/<name>.py ``read(run)``)."""
    cell: object  # spec.Cell
    model: dict  # counts.describe(config): what the counts are taken from
    arm: object  # reference.arms.Arm
    collect_stats: bool
    batch: int
    prompt_lengths: np.ndarray  # [batch] each row's prompt length
    prompt_sum: int  # sum of prompt lengths
    setup_s: float
    window_s: float = 0.0
    window_steps: int = 0
    window_j: list = dataclasses.field(default_factory=list)  # step index in its round
    gap_ms: list = dataclasses.field(default_factory=list)  # device clock, token copy to copy
    host_gap_ms: list = dataclasses.field(default_factory=list)  # host clock, arrival to arrival
    enqueue_ms: list = dataclasses.field(default_factory=list)  # decode_step call to return
    trace: Trace = None
    trace_j: list = dataclasses.field(default_factory=list)
    setup_parts: dict = dataclasses.field(default_factory=dict)  # seconds of each set-up stage
    compiled: bool = False  # set-up ran nvcc (a checkout's first run)
    spin_ms: list = dataclasses.field(default_factory=list)  # spin_ms() before and after the window

    def ctx_sum(self, j: int) -> int:
        """Contexts (the new token included) summed over the rows at step j
        of a round."""
        return self.prompt_sum + self.batch * (j + 1)

    def ctx(self, j: int) -> np.ndarray:
        """[batch] each row's context (the new token included) at step j of
        a round."""
        return self.prompt_lengths + (j + 1)


@dataclasses.dataclass
class Outcome:
    run: Run
    served: object  # check.Served
    memory_peak_bytes: int
    attempted: int
    failed: int


def port_config(config: dict):
    """The port's ModelConfig named by the configuration file, checked
    against the file's published sizes."""
    from qkv_ecc_tpu_torch.models.config import get_model_config

    cfg = get_model_config(config["port_model"])
    want = arch_module(config).port_sizes(config)
    have = {k: getattr(cfg, k) for k in want}
    if have != want:
        raise ValueError(f"the port's '{cfg.name}' is not the configuration run: {have} != {want}")
    return cfg


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             hooks=None) -> Outcome:
    """Run ``cell`` once. ``t_start``: the process's start on the host's
    perf_counter. ``hooks`` (tests): {"decode_step": a replacement}."""
    from qkv_ecc_tpu_torch.models import runtime
    from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode

    from . import check as ck
    from . import counts
    from ..reference.arms import arm as arm_of

    hooks = hooks or {}
    decode_step = hooks.get("decode_step", runtime.decode_step)
    device = torch.device(device)
    parts = {"start": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def stage(name):
        nonlocal mark
        _sync(device)
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now

    compiled = False
    if device.type == "cuda":
        from qkv_ecc_tpu_torch.kernels import _build
        compiled = any(b.seconds > 0 for b in _build.build_all())
    stage("build")
    tf = cell.traffic
    cfg = port_config(cell.config)
    arm = arm_of(tf["mode"])
    collect = bool(tf.get("collect_ecc_stats", False))
    policy = policy_for_mode(tf["mode"], ber=tf["ber"])
    B, n, page = tf["batch"], tf["new_tokens"], tf["page"]
    prompts = tr.make_prompts(tf, cfg.vocab_size, seed)
    weights = make_weights(arch_module(cell.config), cfg, seed, device)
    stage("weights")

    # set-up: the cache, and the prompts prefilled group by group
    state, table, _ = runtime.init_generation_state(cfg, policy, B, tf["prompt_max"] + n, page,
                                                    device=device)
    first = torch.empty(B, dtype=torch.long, device=device)
    for g, (rows, S) in enumerate(prompts.groups):
        gen = torch.Generator(device=device).manual_seed(tr.sub_seed(seed, tr.PREFILL, g))
        idx = torch.as_tensor(rows, device=device)
        ids = torch.as_tensor(prompts.tokens[rows, :S], device=device)
        P = torch.as_tensor(prompts.lengths[rows], device=device)
        logits, state = runtime.prefill(weights, ids, state, table[idx], cfg, policy, gen,
                                        logit_pos=P - 1, true_len=P)
        first[idx] = torch.argmax(logits, dim=-1)
        del logits
    ctx0 = torch.as_tensor(prompts.lengths, dtype=torch.int32, device=device)
    state["context_len"] = ctx0.clone()
    pinned = device.type == "cuda"
    stage("prefill")

    loop = {"round": 0, "j": 0, "gen": None, "tok": first}
    spans: list = []
    held = {}  # row -> tokens of the current round
    last = {}  # row -> tokens of the last complete round
    sample = [int(r) for r in prompts.sample]

    def step(record=None):
        """One decode step of the round loop; returns (enqueue ns, the
        token copy's event, host arrival ns)."""
        nonlocal state
        if loop["j"] == 0:
            t = time.perf_counter_ns()
            loop["gen"] = torch.Generator(device=device).manual_seed(
                tr.sub_seed(seed, tr.ROUND, loop["round"]))
            state["context_len"].copy_(ctx0)
            loop["tok"] = first
            spans.append(("round_restore", t, time.perf_counter_ns()))
        t0 = time.perf_counter_ns()
        logits, state = decode_step(weights, loop["tok"], state, table, cfg, policy, loop["gen"],
                                    page, collect)
        t1 = time.perf_counter_ns()
        tok = torch.argmax(logits, dim=-1)
        host = torch.empty(B, dtype=torch.long, pin_memory=pinned)
        host.copy_(tok, non_blocking=pinned)
        ev = None
        if pinned:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
        t2 = time.perf_counter_ns()
        spans.append(("decode_step", t0, t1))
        spans.append(("argmax_and_copy", t1, t2))
        toks = host.numpy()
        for r in sample:
            held.setdefault(r, []).append(int(toks[r]))
        loop["tok"] = tok
        if record is not None:
            record.append(loop["j"])
        loop["j"] += 1
        if loop["j"] == n:
            last.clear()
            last.update({r: np.array(v) for r, v in held.items()})
            held.clear()
            loop["j"] = 0
            loop["round"] += 1
        return t1 - t0, ev, t2, logits

    # warm-up at the cell's own shapes, then back to the first round
    loop["gen"] = torch.Generator(device=device).manual_seed(tr.sub_seed(seed, tr.WARMUP))
    for _ in range(WARMUP_STEPS):
        logits, state = decode_step(weights, loop["tok"], state, table, cfg, policy, loop["gen"],
                                    page, collect)
        loop["tok"] = torch.argmax(logits, dim=-1)
        loop["tok"].to("cpu")
    _sync(device)
    state["context_len"].copy_(ctx0)
    for name in ("ecc_corrected", "ecc_detected"):
        state.pop(name, None)
    loop["tok"] = first
    spans.clear()
    stage("warmup")

    model = counts.describe(cell.config)
    run = Run(cell=cell, model=model, arm=arm, collect_stats=collect, batch=B,
              prompt_lengths=prompts.lengths.copy(), prompt_sum=int(prompts.lengths.sum()),
              setup_s=time.perf_counter() - t_start, setup_parts=parts, compiled=compiled)

    # the timed window; what set-up left is moved out of the collector's
    # reach, so that a full collection does not walk it mid-window
    gc.collect()
    gc.freeze()
    events, arrivals = [], []
    spin_before = spin_ms()
    w0 = time.perf_counter()
    end = w0 + seconds
    while True:
        enq, ev, t2, logits = step(run.window_j)
        run.enqueue_ms.append(enq * 1e-6)
        events.append(ev)
        arrivals.append(t2)
        if time.perf_counter() >= end:
            break
    run.window_s = time.perf_counter() - w0
    run.spin_ms = [spin_before, spin_ms()]
    run.window_steps = len(run.window_j)
    if pinned:
        run.gap_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    run.host_gap_ms = [(b - a) * 1e-6 for a, b in zip(arrivals, arrivals[1:])]

    if trace and device.type == "cuda":
        def steps(k):
            for _ in range(k):
                step(run.trace_j)
        run.trace = traced(steps, tf["trace_steps"], spans)

    # finish the round the window was in, so that every row checked has
    # its whole round
    while loop["j"] != 0:
        *_, logits = step()
    _sync(device)
    failed = int((~torch.isfinite(logits).all(dim=-1)).sum())
    rounds = loop["round"]
    attempted = B * rounds
    counts_of = {}
    if collect:
        zeros = torch.zeros(B, dtype=torch.int32)  # a step that kept no counters counted 0
        corr = state.get("ecc_corrected", zeros).cpu()
        det = state.get("ecc_detected", zeros).cpu()
        counts_of = {r: (int(corr[r]), int(det[r])) for r in sample}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    kinds = [kind for kind, _, _ in model["layers"][0]["rows"]]
    stored = {r: _stored_rows(state, table, kinds, r, int(prompts.lengths[r]) + n)
              for r in sample}
    chunk = min(512 // page, table.shape[1]) * page
    del state, logits
    loop.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    served = ck.Served(
        config=cell.config, arm=arm, traffic=tf, seed=seed, weights=weights, prompts=prompts,
        first=first.cpu().numpy(), last_round=rounds - 1, rounds=rounds, tokens=last,
        stored=stored, counts=counts_of, chunk_tokens=chunk, device=device)
    return Outcome(run, served, peak, attempted, failed)


def _stored_rows(state, table, kinds: list, row: int, T: int) -> list:
    """Of each cache row a token stores (``kinds``: the port's
    ``<kind>_cache`` and ``<kind>_parity``), [L, T, count, row words] int32:
    row ``row``'s stored words (data words, then parity words) at positions
    [0, T)."""
    bs = state[f"{kinds[0]}_cache"].shape[4]
    pages = table[row, : -(-T // bs)].long()
    out = []
    for name in kinds:
        words = state[f"{name}_cache"][:, pages]
        if f"{name}_parity" in state:
            words = torch.cat([words, state[f"{name}_parity"][:, pages]], dim=3)
        L, npg, H, W, _ = words.shape
        out.append(words.permute(0, 1, 4, 2, 3).reshape(L, npg * bs, H, W)[:, :T].clone())
    return out
