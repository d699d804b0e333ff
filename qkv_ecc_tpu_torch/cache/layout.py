"""Physical layout of the paged ECC KV cache (counterpart of
``qkv_ecc_tpu/cache/layout.py``, the packed-int codecs).

The JAX package's format, kept so that caches compare bit for bit:
  * data arrays k_cache/v_cache [layers, blocks, kv_heads, data_words,
    block_size] int32, tokens on the minor axis;
  * parity arrays k_parity/v_parity [layers, blocks, kv_heads, parity_words,
    block_size] int32 (hamming74, hamming84 and golay);
  * scales k_scales/v_scales [layers, blocks, kv_heads, block_size] float32.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels import swar

CODEC_CHOICES = ("int4", "hamming74", "hamming84", "golay")


@dataclasses.dataclass(frozen=True)
class ECCCacheConfig:
    """Static configuration of a paged ECC KV cache."""

    num_blocks: int = 256
    block_size: int = 128
    num_layers: int = 12
    num_kv_heads: int = 12
    head_dim: int = 64
    codec: str = "golay"
    max_seqs: int = 32

    def __post_init__(self):
        if self.codec not in CODEC_CHOICES:
            swar.unsupported(self.codec)

    @property
    def row_words(self) -> int:
        return swar.row_words(self.codec, self.head_dim)

    @property
    def data_words(self) -> int:
        return swar.data_words(self.codec, self.head_dim)

    @property
    def parity_words(self) -> int:
        return swar.parity_words(self.codec, self.head_dim)

    @property
    def padded_head_dim(self) -> int:
        return swar.padded_values(self.codec, self.head_dim)

    def cache_shape(self):
        return (self.num_layers, self.num_blocks, self.num_kv_heads,
                self.data_words, self.block_size)

    def parity_shape(self):
        """Shape of k_parity / v_parity, or None when the codec has none."""
        if self.parity_words == 0:
            return None
        return (self.num_layers, self.num_blocks, self.num_kv_heads,
                self.parity_words, self.block_size)

    def scales_shape(self):
        return (self.num_layers, self.num_blocks, self.num_kv_heads,
                self.block_size)


def allocate_ecc_kv_cache(config: ECCCacheConfig, device=None) -> dict:
    """Zeroed cache tensors: k_cache, v_cache, k_scales, v_scales, plus
    k_parity/v_parity for the codecs that have parity. ``device=None``
    means the card."""
    device = resolve_device(device)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    out = {
        "k_cache": zeros(config.cache_shape(), torch.int32),
        "v_cache": zeros(config.cache_shape(), torch.int32),
        "k_scales": zeros(config.scales_shape(), torch.float32),
        "v_scales": zeros(config.scales_shape(), torch.float32),
    }
    pshape = config.parity_shape()
    if pshape is not None:
        out["k_parity"] = zeros(pshape, torch.int32)
        out["v_parity"] = zeros(pshape, torch.int32)
    return out
