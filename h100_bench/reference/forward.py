"""The served rows recomputed in float32 over a protected cache.

A model (``reference/<name>.py`` ``Model``) states per layer the rows a
token stores in its cache (``cache(layer)``: (kind, count, width), a K and
a V row of each KV head, or one row read as both), the tokens a query
attends back (``window(layer)``, None for the whole context), and may give
the layer's attention over the rows read (``attend(layer, q, *rows, mask,
rnd, edge)``; by default ``attend`` below over a K and a V row). ``qkv``
returns the query and one tensor [T, count, width] of each cache row.

For one row the cache semantics are:

  prefill   the prompt, padded to its prefill group's length, in one causal
            pass; each layer's cache rows are quantized, encoded, flipped by
            the prefill's draw and read back through the codec (a Golay word it
            cannot correct keeps its data; Hamming(8,4) doubles interpolate
            along the whole padded prompt, each end its own neighbour);
  decode    n steps, step j at position P + j feeding served token j: its
            cache rows written with step j's flips, then every position up to
            P + j read through the codec (an uncorrectable Golay word reads
            as 0; a double interpolates with its right neighbour only where
            that is inside the context and in the same chunk of
            ``chunk_tokens``, so the newest token is its own right
            neighbour).

The decode steps are computed together (teacher forcing): query j masks the
keys after P + j, and its diagonal key takes the newest token's read.
Every product goes through ``rnd`` (identity for the reference, a lower
precision for the control).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from . import codecs as cd
from .arms import Arm


@dataclasses.dataclass
class Row:
    prompt: torch.Tensor  # [S] token ids, the prompt padded to its group's length
    P: int  # prompt length
    fed: torch.Tensor  # [n] tokens fed to the decode steps (served tokens 0..n-1)
    prefill_flips: Callable  # layer -> flip patterns [S, count, codewords] of each cache row
    decode_flips: Callable  # layer -> flip patterns [n, count, codewords] of each cache row
    # filled in, per layer and cache row: the clean nibbles [P + n, count,
    # pv] (uint8) and scales, and the flip patterns
    nibbles: list = dataclasses.field(default_factory=list)
    flips: list = dataclasses.field(default_factory=list)
    prefill_logits: torch.Tensor = None  # [V] at position P - 1
    decode_logits: torch.Tensor = None  # [n, V] at positions P .. P + n - 1


def read_nibbles(arm: Arm, q: torch.Tensor, e: torch.Tensor, phase: str):
    """The nibbles a read sees of clean nibbles q [T, H, pv] stored with flip
    patterns e [T, H, codewords]: (nibbles int32, doubles bool or None)."""
    dev = str(q.device)
    q = q.to(torch.int32)
    if arm.codec == "hamming84":
        delta, klass = cd.hamming_tables(dev)[:2]
        idx = e.long()
        return q ^ delta[idx].to(torch.int32), klass[idx] == 2
    if arm.codec == "hamming74":
        return q ^ cd.hamming_tables(dev)[2][e.long()].to(torch.int32), None
    if arm.codec == "int4":
        return q ^ (e & 0xF), None
    if arm.codec == "golay":
        delta, ok, _ = cd.golay_decode_error(e)
        d = cd.golay_data_of_values(q) ^ delta
        if phase == "decode":
            d = torch.where(ok, d, torch.zeros_like(d))
        return cd.golay_values_of_data(d, q.shape[-1]), None
    raise ValueError(arm.codec)


def _interp(nib, dbl, own_right):
    left = torch.cat([nib[:1], nib[:-1]])
    right = torch.where(own_right[:, None, None], nib, torch.cat([nib[1:], nib[-1:]]))
    return torch.where(dbl, (left + right + 1) >> 1, nib)


def attend(q, k, v, mask, rnd, edge=None):
    """Grouped-query attention: q [Tq, H, D], k and v [Tk, Hkv, D], mask
    [Tq, Tk] (True: attended). ``edge`` = (k', v', idx): query i's key
    idx[i] reads as k'[i], v'[i] instead. Returns [Tq, H * D]."""
    Tq, H, D = q.shape
    Hkv = k.shape[1]
    g = H // Hkv
    qh = rnd(q.reshape(Tq, Hkv, g, D).permute(1, 2, 0, 3))  # [Hkv, g, Tq, D]
    kh = rnd(k.permute(1, 0, 2))[:, None]  # [Hkv, 1, Tk, D]
    vh = rnd(v.permute(1, 0, 2))[:, None]
    s = qh @ kh.transpose(-1, -2) / math.sqrt(D)  # [Hkv, g, Tq, Tk]
    rows = torch.arange(Tq, device=q.device)
    if edge is not None:
        ke, ve, idx = edge
        s[..., rows, idx] = (qh * rnd(ke.permute(1, 0, 2))[:, None]).sum(-1) / math.sqrt(D)
    s = torch.where(mask, s, torch.full_like(s, -math.inf))
    p = torch.softmax(s, dim=-1)
    out = rnd(p) @ vh
    if edge is not None:
        pd = p[..., rows, idx][..., None]  # [Hkv, g, Tq, 1]
        dv = rnd(ve.permute(1, 0, 2))[:, None] - vh[:, :, idx]
        out = out + pd * dv
    return out.permute(2, 0, 1, 3).reshape(Tq, H * D)


def causal_mask(pos, T: int, window):
    """[len(pos), T] True where the query at position pos attends key t:
    t <= pos, and with a window, pos - t < window."""
    t = torch.arange(T, device=pos.device)[None, :]
    mask = t <= pos[:, None]
    if window is not None:
        mask &= t > pos[:, None] - window
    return mask


def _attend_of(model, layer):
    own = getattr(model, "attend", None)
    return attend if own is None else functools.partial(own, layer)


def _quant(x, pv):
    q, s = cd.quantize_int4(x)
    if pv > q.shape[-1]:
        q = torch.nn.functional.pad(q, (0, pv - q.shape[-1]))
    return q, s


def run_rows(model, arm: Arm, rows: list, rnd, chunk_tokens: int):
    """Both passes over every row, layer by layer; fills each Row's
    logits, its clean nibbles and the flip patterns its positions were
    stored with (prompt positions from the prefill, then the decode's)."""
    dev = rows[0].prompt.device
    xs = [model.embed(r.prompt, torch.arange(r.prompt.shape[0], device=dev)) for r in rows]
    # per layer, of each cache row: the prompt pass's (nibbles, scales, flips)
    pre = [[] for _ in rows]
    for layer in range(model.L):
        cache, att = model.cache(layer), _attend_of(model, layer)
        for i, r in enumerate(rows):
            S = r.prompt.shape[0]
            pos = torch.arange(S, device=dev)
            q, *xc = model.qkv(layer, xs[i], pos)
            vals, kept = [], []
            for (_, _, width), x, e in zip(cache, xc, r.prefill_flips(layer), strict=True):
                nq, sc = _quant(x, cd.padded_values(arm.codec, width))
                nib, dbl = read_nibbles(arm, nq, e, "prefill")
                if arm.interp:
                    ends = torch.zeros(S, dtype=torch.bool, device=dev)
                    ends[-1] = True
                    nib = _interp(nib, dbl, ends)
                vals.append(cd.dequantize(nib[..., :width], sc))
                kept.append((nq, sc, e))
            pre[i].append(kept)
            mask = causal_mask(pos, S, model.window(layer))
            xs[i] = model.post(layer, xs[i], att(q, *vals, mask, rnd))
    for i, r in enumerate(rows):
        r.prefill_logits = model.logits(xs[i][r.P - 1:r.P])[0]
    xs = [model.embed(r.fed, r.P + torch.arange(r.fed.shape[0], device=dev)) for r in rows]
    for layer in range(model.L):
        cache, att = model.cache(layer), _attend_of(model, layer)
        for i, r in enumerate(rows):
            n, P = r.fed.shape[0], r.P
            T = P + n
            pos = P + torch.arange(n, device=dev)
            q, *xc = model.qkv(layer, xs[i], pos)
            full, edge, kept = [], [], []
            for (_, _, width), x, e, (pq, ps, pe) in zip(cache, xc, r.decode_flips(layer),
                                                          pre[i][layer], strict=True):
                nq, sc = _quant(x, cd.padded_values(arm.codec, width))
                nq, sc = torch.cat([pq[:P], nq]), torch.cat([ps[:P], sc])
                e = torch.cat([pe[:P], e])
                kept.append((nq, sc, e))
                nib, dbl = read_nibbles(arm, nq, e, "decode")
                if arm.interp:
                    t = torch.arange(T, device=dev)
                    own = ((t + 1) % chunk_tokens == 0) | (t == T - 1)
                    nib_full = _interp(nib, dbl, own)
                    nib_edge = _interp(nib, dbl, torch.ones_like(own))[P:]
                    edge.append(cd.dequantize(nib_edge[..., :width], sc[P:]))
                    nib = nib_full
                full.append(cd.dequantize(nib[..., :width], sc))
            r.nibbles.append([(nq, sc) for nq, sc, _ in kept])
            r.flips.append([e for _, _, e in kept])
            mask = causal_mask(pos, T, model.window(layer))
            e_arg = (*edge, pos) if arm.interp else None
            xs[i] = model.post(layer, xs[i], att(q, *full, mask, rnd, e_arg))
        if layer == model.L - 1:
            for i, r in enumerate(rows):
                r.decode_logits = model.logits(xs[i])
        for i in range(len(rows)):  # the prompt pass's layer is no longer needed
            pre[i][layer] = None
    return rows
