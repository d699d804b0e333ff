"""The one traffic generator: a closed batch of greedy decode over seeded
prompts, from a workload file's parameters.

  batch          rows decoded together
  prompt_min/max prompt lengths, uniform over [min, max]: the same set of
                 lengths for every seed (stratified), in a seeded order, so
                 that every seed asks for the same work
  new_tokens     decode steps a round; each round restarts every row at its
                 prompt's end
  prefill_*      how prompts are grouped for the set-up's prefill
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MASK64 = (1 << 64) - 1
PAD_TOKEN = 0

# tags of the independent streams drawn from one --seed
PROMPTS, WEIGHTS, PREFILL, WARMUP, ROUND, SAMPLE = range(1, 7)


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed of (seed, tags), mixed as splitmix64, so that nearby
    seeds and tags give unrelated streams; any integer seed is taken."""
    h = 0x9E3779B97F4A7C15
    for p in (seed, *tags):
        h = (h ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return h & ((1 << 63) - 1)


@dataclasses.dataclass
class Prompts:
    tokens: np.ndarray  # [batch, prompt_max] int64, each row's prompt then padding
    lengths: np.ndarray  # [batch] int64
    groups: list  # prefill groups: (row indices, padded length)
    sample: np.ndarray  # rows the check recomputes: the longest first


def make_prompts(traffic: dict, vocab: int, seed: int) -> Prompts:
    B, lo, hi = traffic["batch"], traffic["prompt_min"], traffic["prompt_max"]
    if not 1 <= lo <= hi:
        raise ValueError(f"prompt lengths [{lo}, {hi}]")
    rng = np.random.Generator(np.random.PCG64(sub_seed(seed, PROMPTS)))
    strata = np.array([lo + (2 * i + 1) * (hi - lo + 1) // (2 * B) for i in range(B)])
    lengths = strata[rng.permutation(B)]
    tokens = rng.integers(0, vocab, size=(B, hi), dtype=np.int64)
    tokens[np.arange(hi)[None, :] >= lengths[:, None]] = PAD_TOKEN
    order = np.argsort(-lengths, kind="stable")
    groups, i = [], 0
    budget, most = traffic["prefill_tokens_sq"], traffic["prefill_rows_max"]
    while i < B:
        S = int(lengths[order[i]])
        n = max(1, min(most, budget // (S * S), B - i))
        groups.append((order[i:i + n].copy(), S))
        i += n
    srng = np.random.Generator(np.random.PCG64(sub_seed(seed, SAMPLE)))
    k = min(traffic["check_rows"], B)
    longest = int(order[0])
    rest = np.array([r for r in range(B) if r != longest])
    sample = np.concatenate([[longest], srng.choice(rest, size=k - 1, replace=False)]) \
        if k > 1 else np.array([longest])
    return Prompts(tokens, lengths, groups, sample.astype(np.int64))
