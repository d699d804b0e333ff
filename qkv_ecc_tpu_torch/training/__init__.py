"""In-container language-model training (counterpart of
``qkv_ecc_tpu/training``).

The reference's quality tables were produced on HF-pretrained checkpoints,
which this environment cannot download. A random-init model cannot show
the framework's reason to exist - at BER 1e-2 its perplexity barely moves
because its predictions carry no information to destroy. This package
trains a small language model on text available on the machine (Python
library sources + license texts), on the card unless told otherwise, so
the sweep runs on a model whose perplexity degrades under KV-cache
corruption: unprotected INT4 blows up at a high BER while the
ECC-protected modes hold. It also loads and saves the ``.npz``
checkpoints, which the two packages share, and the word tokenizer's
vocabulary.
"""

from .corpus import WordTokenizer, build_corpus
from .trainer import TrainConfig, load_params, save_params, train_tiny

__all__ = [
    "build_corpus",
    "TrainConfig",
    "train_tiny",
    "save_params",
    "load_params",
    "WordTokenizer",
]
