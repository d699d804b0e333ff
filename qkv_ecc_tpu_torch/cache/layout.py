"""Physical layout of the paged ECC KV cache (counterpart of
``qkv_ecc_tpu/cache/layout.py``).

The JAX package's format, kept so that caches compare bit for bit:
  * data arrays k_cache/v_cache [layers, blocks, kv_heads, data_words,
    block_size], tokens on the minor axis: int32 words of the packed-int
    codecs, raw values of the float codecs (fp16: torch.bfloat16, as the
    JAX package stores it; fp8: torch.float8_e4m3fn);
  * parity arrays k_parity/v_parity [layers, blocks, kv_heads, parity_words,
    block_size] int32 (hamming74, hamming84 and golay);
  * scales k_scales/v_scales [layers, blocks, kv_heads, block_size] float32
    (allocated for every codec; the float codecs never read them).
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..kernels import swar
from ..kernels.common import FLOAT_STORAGE_DTYPES

CODEC_CHOICES = ("fp16", "fp8", "int4", "hamming74", "hamming84", "golay")


def cache_dtype_for(codec: str) -> torch.dtype:
    if codec in ("int4", "hamming74", "hamming84", "golay"):
        return torch.int32  # bit-packed storage words
    if codec in FLOAT_STORAGE_DTYPES:
        return FLOAT_STORAGE_DTYPES[codec]
    raise ValueError(f"Unknown codec: {codec}")


def storage_bits_per_value(codec: str) -> float:
    """Physical bits per protected value in the packed layout."""
    return {"fp16": 16.0, "fp8": 8.0, "int4": 4.0, "hamming74": 7.0, "hamming84": 8.0,
            "golay": 8.0}[codec]


@dataclasses.dataclass(frozen=True)
class ECCCacheConfig:
    """Static configuration of a paged ECC KV cache."""

    num_blocks: int = 256
    block_size: int = 128
    num_layers: int = 12
    num_kv_heads: int = 12
    head_dim: int = 64
    codec: str = "hamming84"
    max_seqs: int = 32

    def __post_init__(self):
        if self.codec not in CODEC_CHOICES:
            raise ValueError(f"Unsupported codec '{self.codec}'; choose from {CODEC_CHOICES}")

    @property
    def row_words(self) -> int:
        """Storage elements per (token, head) row: packed int32 words, or
        raw values of the float codecs."""
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

    @property
    def cache_dtype(self) -> torch.dtype:
        return cache_dtype_for(self.codec)

    @property
    def needs_scales(self) -> bool:
        return self.codec not in swar.FLOAT_CODECS

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
        "k_cache": zeros(config.cache_shape(), config.cache_dtype),
        "v_cache": zeros(config.cache_shape(), config.cache_dtype),
        "k_scales": zeros(config.scales_shape(), torch.float32),
        "v_scales": zeros(config.scales_shape(), torch.float32),
    }
    pshape = config.parity_shape()
    if pshape is not None:
        out["k_parity"] = zeros(pshape, torch.int32)
        out["v_parity"] = zeros(pshape, torch.int32)
    return out


def create_block_table(max_seqs: int, max_blocks_per_seq: int, device=None) -> torch.Tensor:
    """Logical -> physical block table, -1 for unallocated, on ``device``
    (None: the card)."""
    return torch.full((max_seqs, max_blocks_per_seq), -1, dtype=torch.int32,
                      device=resolve_device(device))


def compute_slot_mapping(positions, block_size: int):
    """Token position -> (logical block, slot)."""
    positions = torch.as_tensor(positions)
    return positions // block_size, positions % block_size
