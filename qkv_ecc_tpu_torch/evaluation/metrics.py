"""Evaluation metrics (counterpart of ``qkv_ecc_tpu/evaluation/metrics.py``):
perplexity over sliding windows, per-sample perplexity and the catastrophic
failure rate, KL divergence against clean logits, and top-5 accuracy.

The protocol is the JAX module's: sliding windows with -100 labels on the
positions already scored, texts padded to 32-token buckets, KL(clean ||
corrupted) in nats. JAX runs one forward per text or window; its flips
depend on (seed, layer, K or V) and the input's shape alone, so every text
of one padded length sees the same flips. The port runs those texts as one
batch (``forward_rows``), each row given the flips of a forward of that row
alone: the same results, with one forward and one read back to the host per
batch instead of per text.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..models.kv_policy import KVCachePolicy, forward_masks
from ..models.registry import _params_device, forward_jit
from .data import pad_to_bucket, tokenize

# logits elements one batched forward may hold (1 GiB of float32)
MAX_BATCH_LOGITS = 1 << 28


def _text_windows(ids: np.ndarray, max_length: int, stride: int):
    """Sliding windows with -100 masking of already-scored positions."""
    seq_len = ids.shape[1]
    prev_end = 0
    for begin in range(0, seq_len, stride):
        end = min(begin + max_length, seq_len)
        target_len = end - max(begin, prev_end)
        if target_len <= 0:
            prev_end = end
            if end >= seq_len:
                return
            continue
        window = ids[:, begin:end]
        labels = window.copy()
        if begin > 0:
            labels[:, : min(prev_end - begin, end - begin)] = -100
        yield window, labels, target_len
        prev_end = end
        if end >= seq_len:
            return


def _row_losses(logits: torch.Tensor, labels) -> List[float]:
    """Each row's mean next-token cross entropy over its targets (labels
    other than -100), in float32 as registry.cross_entropy computes it."""
    targets = torch.as_tensor(labels).to(logits.device, torch.long)[:, 1:]
    valid = targets != -100
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, targets, 0)[..., None])[..., 0]
    total = torch.where(valid, nll, 0.0).sum(dim=1)
    return (total / valid.sum(dim=1).clamp(min=1)).tolist()


def forward_rows(params, cfg, policy: KVCachePolicy, rows, labels=None):
    """The forwards of ``rows`` (numpy ids [1, P] each), one per batch of
    rows of one length P (cut so its logits hold at most MAX_BATCH_LOGITS
    values), every row given the flips that process_kv draws for one row
    of that length (kv_policy.forward_masks): the forward JAX runs for the
    row alone, with its flips. With ``labels`` (one [1, P] array a row)
    each row's mean loss is computed too.

    Yields (row indices, logits [B, P, V], mean losses or None, stats of
    the batch) per batch. A row's ECC counts are the batch's divided by B:
    they depend on the flips alone, which the rows share."""
    device = _params_device(params)
    groups = {}
    for i, r in enumerate(rows):
        groups.setdefault(r.shape[1], []).append(i)
    for P, members in groups.items():
        step = max(1, MAX_BATCH_LOGITS // (P * cfg.vocab_size))
        wm, rm = forward_masks(policy, cfg.num_layers, (1, P, cfg.num_kv_heads, cfg.head_dim),
                               device)
        for k in range(0, len(members), step):
            idx = members[k:k + step]
            B = len(idx)

            def batch(m):
                return None if m is None else m.expand(m.shape[:2] + (B,) + m.shape[3:])

            ids = np.concatenate([rows[i] for i in idx])
            logits, stats = forward_jit(params, ids, cfg, policy, write_masks=batch(wm),
                                        read_masks=batch(rm))
            losses = None
            if labels is not None:
                losses = _row_losses(logits, np.concatenate([labels[i] for i in idx]))
            yield idx, logits, losses, stats


def _window_rows(tokenizer, texts, max_length, stride):
    """Every window of every non-blank text: (text index, padded ids,
    padded labels, target tokens)."""
    out = []
    for t, text in enumerate(texts):
        if not text.strip():
            continue
        ids = tokenize(tokenizer, text)
        for window, labels, target_len in _text_windows(ids, max_length, stride):
            pw, _, L = pad_to_bucket(window, bucket=32)
            pl = np.full_like(pw, -100)
            pl[:, :L] = labels
            out.append((t, pw, pl, target_len))
    return out


def _window_losses(params, cfg, policy, tokenizer, texts, max_length, stride):
    """(text index, loss, target tokens) of every window in text order,
    the windows whose loss is NaN or inf left out."""
    rows = _window_rows(tokenizer, texts, max_length, stride)
    losses = [None] * len(rows)
    for idx, _, batch_losses, _ in forward_rows(params, cfg, policy, [r[1] for r in rows],
                                                [r[2] for r in rows]):
        for i, loss in zip(idx, batch_losses):
            losses[i] = loss
    return [(t, loss, target_len) for (t, _, _, target_len), loss in zip(rows, losses)
            if not (math.isnan(loss) or math.isinf(loss))]


def compute_perplexity(
    params, cfg, policy: KVCachePolicy, tokenizer, texts,
    max_length: int = 512, stride: int = 256,
) -> float:
    """Aggregate sliding-window PPL = exp(total_loss / total_tokens)."""
    total_loss = 0.0
    total_tokens = 0
    for _, loss, target_len in _window_losses(params, cfg, policy, tokenizer, texts,
                                              max_length, stride):
        total_loss += loss * target_len
        total_tokens += target_len
    if total_tokens == 0:
        return float("inf")
    return math.exp(total_loss / total_tokens)


def compute_per_sample_perplexity(
    params, cfg, policy, tokenizer, texts, max_length: int = 512, stride: int = 256
) -> List[float]:
    sums = [[0.0, 0] for _ in texts]
    for t, loss, target_len in _window_losses(params, cfg, policy, tokenizer, texts,
                                              max_length, stride):
        sums[t][0] += loss * target_len
        sums[t][1] += target_len
    return [math.exp(total_loss / total_tokens) if total_tokens else float("inf")
            for total_loss, total_tokens in sums]


def compute_catastrophic_rate(perplexities: List[float], threshold: float = 1000.0):
    if not perplexities:
        return 0.0
    n = sum(1 for p in perplexities if p > threshold or math.isinf(p))
    return n / len(perplexities)


def compute_kl_divergence(logits_a, logits_b, temperature: float = 1.0) -> float:
    """KL(a || b) in nats, averaged over positions, in float32."""
    a = torch.as_tensor(logits_a).to(torch.float32)
    b = torch.as_tensor(logits_b).to(device=a.device, dtype=torch.float32)
    log_p = torch.log_softmax(a / temperature, dim=-1)
    log_q = torch.log_softmax(b / temperature, dim=-1)
    kl = torch.sum(torch.exp(log_p) * (log_p - log_q), dim=-1).mean()
    return float(kl)


def _text_logits(params, cfg, policy, tokenizer, texts, max_length, min_tokens):
    """(text index, ids [1, L], logits [L, V]) of each non-blank text with
    at least min_tokens tokens, from the bucket-padded first max_length
    tokens, batch by batch."""
    ids = {}
    for t, text in enumerate(texts):
        if text.strip():
            row = tokenize(tokenizer, text, max_length)
            if row.shape[1] >= min_tokens:
                ids[t] = row
    order = list(ids)
    rows = [pad_to_bucket(ids[t], bucket=32)[0] for t in order]
    for idx, logits, _, _ in forward_rows(params, cfg, policy, rows):
        for j, i in enumerate(idx):
            t = order[i]
            yield t, ids[t], logits[j, : ids[t].shape[1]]


def generate_clean_logits(
    params, cfg, tokenizer, texts, max_length: int = 256
) -> List[Optional[torch.Tensor]]:
    """FP16-oracle logits per text, [L, V] float32, kept on the parameters'
    device (the forward's: JAX keeps them on the host), None for a blank
    text."""
    out = [None] * len(texts)
    for t, _, logits in _text_logits(params, cfg, KVCachePolicy(codec="fp16"), tokenizer,
                                     texts, max_length, 0):
        out[t] = logits.to(torch.float32)
    return out


def compute_mean_kl_divergence(
    params, cfg, policy, tokenizer, texts, clean_logits_list, max_length: int = 256
) -> float:
    usable = [t if clean is not None else "" for t, clean in zip(texts, clean_logits_list)]
    kls = {}
    for t, _, corrupted in _text_logits(params, cfg, policy, tokenizer, usable, max_length, 2):
        clean = clean_logits_list[t]
        n = min(corrupted.shape[0], clean.shape[0])
        kl = compute_kl_divergence(clean[:n], corrupted[:n])
        if not (math.isnan(kl) or math.isinf(kl)):
            kls[t] = kl
    kls = [kls[t] for t in sorted(kls)]  # summed in text order, as JAX's
    return sum(kls) / len(kls) if kls else 0.0


def top5_indices(logits: torch.Tensor) -> torch.Tensor:
    """The indices of the five largest logits of each row [..., 5], as
    ``jax.lax.top_k`` picks them: NaN above every number and equal values
    by lower index (a stable descending sort; ``torch.topk`` leaves ties,
    all-NaN rows among them, in no set order)."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[..., :5]


def compute_top5_accuracy(
    params, cfg, policy, tokenizer, texts, max_length: int = 256
) -> float:
    """Share of next tokens among the five largest logits (top5_indices);
    a hit is membership in the five, as JAX counts it."""
    total, hits = 0, 0
    for _, ids, logits in _text_logits(params, cfg, policy, tokenizer, texts, max_length, 2):
        top5 = top5_indices(logits[:-1])  # [L-1, 5]
        targets = torch.from_numpy(ids[0, 1:].astype(np.int64)).to(top5.device)
        hits += int((top5 == targets[:, None]).any(dim=1).sum())
        total += targets.shape[0]
    return hits / total if total else 0.0
