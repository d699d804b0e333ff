"""Evaluation data and tokenizers (counterpart of
``qkv_ecc_tpu/evaluation/data.py``): a deterministic synthetic corpus and a
byte-level tokenizer, so the whole harness runs offline."""

from __future__ import annotations

import numpy as np

_FALLBACK_SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "In the beginning, there was nothing. Then there was light.",
    "Science is the systematic study of the natural world.",
    "A paged key value cache stores attention context in fixed size blocks.",
    "Error correcting codes add parity bits so corrupted data can be repaired.",
    "The transformer architecture relies on attention instead of recurrence.",
    "Quantization maps floating point values onto a small set of integers.",
    "Bit flips in memory can silently corrupt the state of a running program.",
    "The Golay code corrects up to three errors in every codeword.",
    "Perplexity measures how well a language model predicts held out text.",
    "Hardware reliability degrades as process nodes shrink and voltage drops.",
    "Interpolation recovers a damaged value from its temporal neighbors.",
]


def load_wikitext2_test(max_samples: int = 100, min_chars: int = 50):
    """The evaluation texts of the gpt2-class models: ``synthetic_corpus(
    max_samples)``. The JAX function loads the WikiText-2 test split
    through ``datasets`` when the hub is reachable and falls back to these
    texts otherwise; the port runs offline, so it returns the fallback
    directly, probing no socket and importing no ``datasets``
    (``min_chars`` filtered WikiText's lines and is kept for the call's
    shape)."""
    return synthetic_corpus(max_samples)


def synthetic_corpus(n_texts: int = 20, sentences_per_text: int = 12, seed: int = 0):
    """Deterministic pseudo-texts for offline runs."""
    rng = np.random.default_rng(seed)
    texts = []
    for _ in range(n_texts):
        idx = rng.integers(0, len(_FALLBACK_SENTENCES), size=sentences_per_text)
        texts.append(" ".join(_FALLBACK_SENTENCES[i] for i in idx))
    return texts


class ByteTokenizer:
    """UTF-8 byte tokenizer (vocab 256) for random-init and byte-level
    models."""

    vocab_size = 256
    pad_token_id = 0
    eos_token_id = 0

    def encode(self, text: str, max_length: int | None = None):
        ids = list(text.encode("utf-8"))
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids):
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")

    def __call__(self, text, truncation=False, max_length=None, **kw):
        return {"input_ids": self.encode(text, max_length if truncation else None)}


def get_tokenizer(model_name: str, hf_id: str | None):
    """The byte tokenizer. JAX's returns an HF tokenizer when
    ``transformers`` can load ``hf_id`` and the byte tokenizer otherwise,
    which is what it returns with no ``transformers`` or no network; the
    port returns it without importing ``transformers``."""
    return ByteTokenizer()


def tokenize(tokenizer, text: str, max_length: int | None = None) -> np.ndarray:
    """Uniform [1, S] int32 ids from either tokenizer flavor."""
    if isinstance(tokenizer, ByteTokenizer):
        ids = tokenizer.encode(text, max_length)
    else:
        out = tokenizer(text, truncation=max_length is not None, max_length=max_length)
        ids = out["input_ids"]
    return np.asarray(ids, dtype=np.int32)[None, :]


def pad_to_bucket(ids: np.ndarray, bucket: int = 32, pad_id: int = 0):
    """Pad [1, S] ids up to a multiple of ``bucket`` (JAX compiles its
    forward once per bucket; the port keeps the shapes so that the K/V
    statistics and the fault masks' shapes are JAX's).

    Returns (padded_ids, labels, true_len): padded label positions are -100
    so the CE math is unchanged; KV statistics include the (zero-embedding)
    padded tail."""
    L = ids.shape[1]
    target = -(-L // bucket) * bucket
    padded = np.full((ids.shape[0], target), pad_id, dtype=np.int32)
    padded[:, :L] = ids
    labels = np.full_like(padded, -100)
    labels[:, :L] = ids
    return padded, labels, L
