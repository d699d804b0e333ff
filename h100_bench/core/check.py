"""What decides ``correct``: the rows the window served, recomputed by the
plain reference (``h100_bench/reference``) from the benchmark's own inputs.

Numbers compared, each against its limit in the workload file:

  logit_gap       the widest gap by which a served token's logit lies below
                  the reference's best, over the sampled rows' prefill token
                  and every token of their last round (greedy decode)
  bad_codewords   stored codewords that do not hold what the write chain
                  defines: a raw word XOR the reference's flips is not a
                  codeword, or a scrubbed word is not one (exact: 0)
  far_value_pct   % of the stored values whose clean nibble (the word with
                  the flips undone) lies more than one INT4 level from the
                  reference's quantization of the same K or V value
  ecc_count_diff  (cells that collect ECC counts) the program's corrected and
                  detected counters of the sampled rows against the counts
                  the reference's flips give, summed absolute difference
                  (exact: 0)

The control: the reference put in the program's place at the next precision
below the configuration's (bfloat16 -> fp8 e4m3, per-tensor scaled; float32
-> TF32, its inputs rounded to 10 mantissa bits), read at the same prompts
and served tokens: the gap of the token it puts first, and its far values.
The widest gap (``logit_gap``) is reported beside the numbers; a cell
compares it only where its limit is set (PERF.md: where the control's
readings stand three times above the program's).
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from . import traffic as tr
from ..reference import codecs as cd
from ..reference import forward as rf


def exact(x):
    return x


def tf32(x):
    """Round float32 to TF32 (10 mantissa bits, nearest even)."""
    i = x.contiguous().view(torch.int32)
    bias = 0x0FFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


def fp8(x):
    """Per-tensor scaled e4m3 round trip."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


CONTROL = {"bfloat16": fp8, "float32": tf32}


@dataclasses.dataclass
class Served:
    """What the run hands the check: inputs, served tokens, stored words."""
    config: dict  # the configuration file
    arm: object  # reference.arms.Arm
    traffic: dict
    seed: int
    weights: dict
    prompts: object  # traffic.Prompts
    first: np.ndarray  # [batch] the prefill's token of every row
    last_round: int  # the round whose tokens are checked (complete)
    rounds: int  # rounds run since the counters started (all complete)
    tokens: dict  # row -> [new_tokens] tokens of the last round
    stored: dict  # row -> of each cache row, [L, P + n, count, row words] int32 stored words
    counts: dict  # row -> (corrected, detected) or absent
    chunk_tokens: int
    device: torch.device


def _draw_shape(model) -> tuple:
    """(cache rows a layer, count, width) of the program's write flips, as
    the model states its cache (``cache(layer)``): every layer's rows are
    alike, and the program draws them so (decode_flips)."""
    sizes = {(count, width) for layer in range(model.L) for _, count, width in model.cache(layer)}
    per_layer = {len(model.cache(layer)) for layer in range(model.L)}
    if len(sizes) != 1 or len(per_layer) != 1:
        raise ValueError(f"cache rows of unlike sizes {sorted(sizes)} or numbers "
                         f"{sorted(per_layer)}: the program's draw of them is not stated")
    (count, width), = sizes
    return per_layer.pop(), count, width


def _prefill_flips(s: Served, model, shape: tuple):
    """row -> layer -> flips of each cache row from its prefill group's
    draws (per layer, one draw a cache row, in the model's order), each
    group replayed once and its sampled rows kept."""
    R, count, width = shape
    ncw = s.arm.codewords(width)
    group_of = {int(r): g for g, (rows, _) in enumerate(s.prompts.groups) for r in rows}
    sample = set(map(int, s.prompts.sample))
    cache = {}

    def for_row(row):
        g = group_of[row]
        if g not in cache:
            rows, S = s.prompts.groups[g]
            kept = [int(r) for r in rows if int(r) in sample]
            idx = torch.tensor([j for j, r in enumerate(rows) if int(r) in sample],
                               device=s.device)
            gen = torch.Generator(device=s.device).manual_seed(tr.sub_seed(s.seed, tr.PREFILL, g))
            per = [[cd.flip_pattern((len(rows), S, count, ncw), s.traffic["ber"],
                                    s.arm.n_bits, gen, select=lambda u: u[:, idx])
                    for _ in range(R)] for _ in range(model.L)]
            cache[g] = ({r: j for j, r in enumerate(kept)}, per)
        pos, per = cache[g]
        j = pos[row]
        return lambda layer: [e[j] for e in per[layer]]

    return for_row


def decode_flips(s: Served, model, shape: tuple, rnd_index: int, rows: list):
    """[n, L, R, len(rows), count, codewords] flips of round ``rnd_index``'s
    steps for ``rows``, replayed from the round's generator: one draw a
    step of [L, R, B, 1, count, codewords], R the cache rows a layer."""
    R, count, width = shape
    B, n = s.traffic["batch"], s.traffic["new_tokens"]
    gen = torch.Generator(device=s.device).manual_seed(tr.sub_seed(s.seed, tr.ROUND, rnd_index))
    idx = torch.tensor(rows, device=s.device)
    return torch.stack([
        cd.flip_pattern((model.L, R, B, 1, count, s.arm.codewords(width)), s.traffic["ber"],
                        s.arm.n_bits, gen,
                        select=lambda u: u[:, :, :, idx, 0])
        for _ in range(n)])


def _model(s: Served, rnd):
    module = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.reference.{s.config['reference']}")
    return module.Model(s.config, s.weights, rnd)


def _rows(s: Served, model, shape: tuple, dflips):
    pf = _prefill_flips(s, model, shape)
    padded = {int(x): S for rows, S in s.prompts.groups for x in rows}
    out = []
    for i, r in enumerate(map(int, s.prompts.sample)):
        S = padded[r]
        toks = torch.as_tensor(s.prompts.tokens[r, :S], device=s.device)
        fed = torch.as_tensor(np.concatenate([[s.first[r]], s.tokens[r][:-1]]), device=s.device)
        out.append(rf.Row(prompt=toks, P=int(s.prompts.lengths[r]), fed=fed,
                          prefill_flips=pf(r),
                          decode_flips=(lambda layer, i=i: list(dflips[:, layer, :, i]
                                                                .unbind(1)))))
    return out


def _gaps(logits, tokens):
    """Per position: best logit - the token's logit."""
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]


def _logits(row):
    """[n + 1, V]: the logits that chose each served token of a row."""
    return torch.cat([row.prefill_logits[None], row.decode_logits])


def _served(s: Served, r: int):
    return torch.as_tensor(np.concatenate([[s.first[r]], s.tokens[r]]), device=s.device)


def _clean_nibbles(arm, cw, e, scrubbed, pv):
    """(the clean nibbles a stored word implies, valid codeword, value
    skipped) [T, H, pv] of stored codewords cw and flips e [T, H, ncw]."""
    dev = str(cw.device)
    if arm.codec == "golay":
        delta, ok, _ = cd.golay_decode_error(e)
        raw = torch.where(scrubbed[:, None, None], cw, cw ^ e)
        valid = cd.golay_syndrome_t(raw) == 0
        data = raw & 0xFFF
        data = torch.where(scrubbed[:, None, None], data ^ delta, data)
        skip = scrubbed[:, None, None] & ~ok
        vals = cd.golay_values_of_data(data, pv)
        return vals, valid, cd.golay_values_of_data(skip.to(torch.int32) * 0xFFF, pv) != 0
    if arm.codec == "hamming84":
        delta = cd.hamming_tables(dev)[0][e.long()].to(torch.int32)
        check = cd.h84_valid
    elif arm.codec == "hamming74":
        delta = cd.hamming_tables(dev)[2][e.long()].to(torch.int32)
        check = cd.h74_valid
    else:
        delta, check = e & 0xF, (lambda w: torch.ones_like(w, dtype=torch.bool))
    sc = scrubbed[:, None, None]
    raw = torch.where(sc, cw, cw ^ e)
    vals = torch.where(sc, (raw & 0xF) ^ delta, raw & 0xF)
    return vals, check(raw), torch.zeros_like(vals, dtype=torch.bool)


def _stored_numbers(s: Served, model, rows, detail=None):
    """(bad codewords, far values, values compared)."""
    bad, far, total = 0, 0, 0
    collect = bool(s.traffic.get("collect_ecc_stats", False))
    for r, row in zip(map(int, s.prompts.sample), rows):
        stored = s.stored[r]
        T = stored[0].shape[1]
        scrubbed = torch.full((T,), s.arm.scrub_prefill(), dtype=torch.bool, device=s.device)
        scrubbed[row.P:] = s.arm.scrub_decode(collect)
        for layer, kept in enumerate(row.nibbles):
            for j, ((q, _), (_, _, D)) in enumerate(zip(kept, model.cache(layer), strict=True)):
                cw = cd.stored_codewords(s.arm.codec, stored[j][layer], D)
                vals, valid, skip = _clean_nibbles(s.arm, cw, row.flips[layer][j], scrubbed,
                                                   cd.padded_values(s.arm.codec, D))
                bad += int((~valid).sum())
                off = ((vals - q.to(torch.int32)).abs() > 1) & ~skip
                far += int(off[..., :D].sum())
                total += int((~skip[..., :D]).sum())
                if detail is not None:
                    # per layer, of each cache row: far values in the prompt, then the decode
                    d = detail.setdefault("far_by_layer", [[0] * 2 * len(k) for k in row.nibbles])
                    d[layer][2 * j] += int(off[:row.P, :, :D].sum())
                    d[layer][2 * j + 1] += int(off[row.P:, :, :D].sum())
                    one = detail.setdefault("one_level_by_layer", [0 for _ in row.nibbles])
                    one[layer] += int(((vals - q.to(torch.int32)).abs() == 1)[..., :D].sum())
    return bad, far, total


def _far_value_pct(model, rows_a, rows_b) -> float:
    """% of values whose nibbles differ by more than one level between two
    runs of the reference (the control's stored values against the
    reference's)."""
    far, total = 0, 0
    for ra, rb in zip(rows_a, rows_b):
        for layer, (ka, kb) in enumerate(zip(ra.nibbles, rb.nibbles)):
            for (a, _), (b, _), (_, _, D) in zip(ka, kb, model.cache(layer), strict=True):
                far += int(((a.to(torch.int32) - b.to(torch.int32)).abs() > 1)[..., :D].sum())
                total += a[..., :D].numel()
    return 100.0 * far / total


def _counts(s: Served, model, shape: tuple, rows, last_flips):
    """Expected (corrected, detected) of each sampled row over every round
    (a cell that counts: its decode steps write raw words)."""
    n = s.traffic["new_tokens"]

    def per_codeword(e):
        if s.arm.codec == "golay":
            _, _, cnt = cd.golay_decode_error(e)
            return torch.where(cnt < 4, cnt, 0), (cnt == 4).to(torch.int32)
        if s.arm.codec == "hamming84":
            k = cd.hamming_tables(str(e.device))[1][e.long()].to(torch.int32)
            return (k == 1).to(torch.int32), (k == 2).to(torch.int32)
        if s.arm.codec == "hamming74":
            return cd.hamming_tables(str(e.device))[3][e.long()].to(torch.int32), torch.zeros_like(e)
        return torch.zeros_like(e), torch.zeros_like(e)

    sample = list(map(int, s.prompts.sample))
    out = {}
    prompt = []
    for row in rows:
        c = torch.zeros(2, dtype=torch.int64, device=s.device)
        if not s.arm.scrub_prefill():
            for layer in range(model.L):
                for e in row.flips[layer]:
                    a, b = per_codeword(e[:row.P])
                    c += torch.stack([a.sum(), b.sum()])
        prompt.append(c)
    total = [n * s.rounds * p for p in prompt]
    if not s.arm.scrub_decode(collect_stats=True):
        for rnd_index in range(s.rounds):
            fl = last_flips if rnd_index == s.last_round else decode_flips(
                s, model, shape, rnd_index, sample)
            a, b = per_codeword(fl)  # [n, L, R, rows, count, codewords]
            per_step = torch.stack([a.sum((1, 2, 4, 5)), b.sum((1, 2, 4, 5))], -1)  # [n, rows, 2]
            weight = (n - torch.arange(n, device=s.device))[:, None, None]
            for i in range(len(rows)):
                total[i] = total[i] + (per_step * weight).sum(0)[i]
    for i, r in enumerate(sample):
        out[r] = (int(total[i][0]), int(total[i][1]))
    return out


def verdict(nums: dict, limits: dict, failed: int):
    """(correct, {number: {"value", "limit"}}): every number that has a limit
    at or under it, and no row with non-finite logits."""
    checks = {k: {"value": nums[k], "limit": limit} for k, limit in limits.items()}
    return failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()), checks


def numbers(s: Served, with_control: bool = False) -> dict:
    """The numbers compared (and the control's, with ``with_control``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = _model(s, exact)
    shape = _draw_shape(model)
    sample = list(map(int, s.prompts.sample))
    last = decode_flips(s, model, shape, s.last_round, sample)
    rows = rf.run_rows(model, s.arm, _rows(s, model, shape, last), exact, s.chunk_tokens)
    gaps = [_gaps(_logits(r), _served(s, q)) for q, r in zip(sample, rows)]
    out = {"logit_gap": float(max(g.max() for g in gaps)),
           "logit_gap_mean": float(torch.cat(gaps).mean())}
    detail = {"gap_by_position": [g.tolist() for g in gaps]}
    out["bad_codewords"], far, total = _stored_numbers(s, model, rows, detail)
    out["far_value_pct"] = 100.0 * far / total
    out["detail"] = detail
    if s.traffic.get("collect_ecc_stats"):
        want = _counts(s, model, shape, rows, last)
        out["ecc_count_diff"] = sum(abs(want[r][0] - s.counts[r][0]) + abs(want[r][1] - s.counts[r][1])
                                    for r in sample)
    if with_control:
        rnd = CONTROL[s.config["torch_dtype"]]
        crows = rf.run_rows(_model(s, rnd), s.arm, _rows(s, model, shape, last), rnd,
                            s.chunk_tokens)
        cg = torch.cat([_gaps(_logits(r), _logits(c).argmax(-1)) for r, c in zip(rows, crows)])
        out["control"] = {"logit_gap": float(cg.max()), "logit_gap_mean": float(cg.mean()),
                          "far_value_pct": _far_value_pct(model, crows, rows)}
    return out
