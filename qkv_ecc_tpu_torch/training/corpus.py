"""The word-level tokenizer of the trained word models (counterpart of
``WordTokenizer`` in ``qkv_ecc_tpu/training/corpus.py``): loading a saved
vocabulary, encoding and decoding. Building the corpus and training the
vocabulary stay with the JAX package's training."""

from __future__ import annotations

import json
import re

_TOKEN = re.compile(r"\S+|\n")


class WordTokenizer:
    """Frequency-ranked word-level tokenizer. Tokens are \\S+ runs and
    newlines; out-of-vocab words map to <unk> (id 1), id 0 pads."""

    pad_token_id = 0
    eos_token_id = 0
    unk_id = 1

    def __init__(self, vocab):
        self.vocab = vocab  # token -> id
        self.vocab_size = max(vocab.values()) + 1

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

    @classmethod
    def load(cls, path: str) -> "WordTokenizer":
        with open(path) as fh:
            return cls(json.load(fh))
