"""Deterministic in-container text corpus and the word-level tokenizer of
the trained word models (counterpart of ``qkv_ecc_tpu/training/corpus.py``).

Sources (no network): Python sources of the large installed libraries
(tens of MB of code + English docstrings/comments) and the system license
texts. Files are collected in sorted order and split train/held-out
deterministically, so the corpus is the same bytes on the same machine.
It is the machine's own: a host with other libraries installed (the card's
has no ``jax`` and no ``transformers``) builds other bytes, so a model
trained there is not the one trained elsewhere from the same seed.
"""

from __future__ import annotations

import collections
import json
import os
import re
from typing import List, Tuple

_TOKEN = re.compile(r"\S+|\n")
_LIB_ROOTS = ("transformers", "jax", "numpy", "torch")
_EXTRA_FILES = ("/THIRD_PARTY_NOTICES/LICENSES.txt",)


def _site_packages() -> str:
    import numpy

    return os.path.dirname(os.path.dirname(numpy.__file__))


def _iter_py_files(max_files_per_lib: int = 4000) -> List[str]:
    sp = _site_packages()
    out: List[str] = []
    for lib in _LIB_ROOTS:
        root = os.path.join(sp, lib)
        if not os.path.isdir(root):
            continue
        files = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            for f in sorted(filenames):
                if f.endswith(".py"):
                    files.append(os.path.join(dirpath, f))
        out.extend(files[:max_files_per_lib])
    return out


def build_corpus(
    max_bytes: int = 32 * 1024 * 1024,
    holdout_every: int = 53,
    eval_texts: int = 20,
    eval_chars: int = 2000,
) -> Tuple[bytes, List[str]]:
    """Returns (train_bytes, held_out_eval_texts).

    Every `holdout_every`-th file is held out; eval texts are fixed-size
    character windows from the held-out set (the sweep's "WikiText-2 test
    samples" analogue)."""
    train_parts: List[bytes] = []
    hold_parts: List[str] = []
    total = 0
    files = _iter_py_files()
    for i, path in enumerate(files):
        if total >= max_bytes and len(hold_parts) >= eval_texts * 2:
            break
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except OSError:
            continue
        if len(data) < 256:
            continue
        if i % holdout_every == 0:
            hold_parts.append(data.decode("utf-8", errors="replace"))
        elif total < max_bytes:
            train_parts.append(data)
            total += len(data) + 2
    for path in _EXTRA_FILES:
        try:
            with open(path, "rb") as fh:
                train_parts.append(fh.read())
        except OSError:
            pass

    texts: List[str] = []
    for t in hold_parts:
        for start in range(0, max(len(t) - eval_chars, 1), eval_chars):
            texts.append(t[start : start + eval_chars])
            if len(texts) >= eval_texts:
                break
        if len(texts) >= eval_texts:
            break
    return b"\n\n".join(train_parts), texts


class WordTokenizer:
    """Frequency-ranked word-level tokenizer. Tokens are \\S+ runs and
    newlines; out-of-vocab words map to <unk> (id 1), id 0 pads."""

    pad_token_id = 0
    eos_token_id = 0
    unk_id = 1

    def __init__(self, vocab):
        self.vocab = vocab  # token -> id
        self.vocab_size = max(vocab.values()) + 1

    @classmethod
    def train(cls, text: str, vocab_size: int = 8192) -> "WordTokenizer":
        """The ``vocab_size - 2`` most frequent tokens of ``text`` after
        <pad> and <unk>, ties in order of first appearance (Counter's
        most_common)."""
        counts = collections.Counter(_TOKEN.findall(text))
        vocab = {"<pad>": 0, "<unk>": 1}
        for tok, _ in counts.most_common(vocab_size - 2):
            vocab[tok] = len(vocab)
        return cls(vocab)

    def encode(self, text: str, max_length=None):
        ids = [self.vocab.get(t, self.unk_id) for t in _TOKEN.findall(text)]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids):
        inv = {v: k for k, v in self.vocab.items()}
        return " ".join(inv.get(int(i), "<unk>") for i in ids)

    def __call__(self, text, truncation=False, max_length=None, **kw):
        return {"input_ids": self.encode(text, max_length if truncation else None)}

    def save(self, path: str):
        with open(path, "w") as fh:
            json.dump(self.vocab, fh)

    @classmethod
    def load(cls, path: str) -> "WordTokenizer":
        with open(path) as fh:
            return cls(json.load(fh))
