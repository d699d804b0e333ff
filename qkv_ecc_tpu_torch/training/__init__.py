"""Loading what the JAX package's training wrote (counterpart of part of
``qkv_ecc_tpu/training``): the ``.npz`` checkpoints of the trained models
and the word-level tokenizer's vocabulary. Training itself is the JAX
package's."""

from .corpus import WordTokenizer
from .trainer import load_params

__all__ = ["WordTokenizer", "load_params"]
