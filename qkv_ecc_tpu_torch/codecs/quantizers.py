"""Pluggable INT4 quantization backends (counterpart of
``qkv_ecc_tpu/codecs/quantizers.py``), as torch functions on the caller's
device; the registry and facade API are the JAX module's:

    get_quantizer("kivi", QuantizationConfig(...)).quantize(x, mode)

Symmetric INT4 convention (shared with the ECC cache engine):
    scale = max|x| / 7,  q = round(x / scale) + 8, clamped to [0, 15].
KIVI asymmetric convention (KIVI paper, ICML 2024):
    zero_point = min(x), scale = (max(x) - min(x)) / (2^bits - 1),
    q = round((x - zp) / scale);  keys per-channel, values per-token.

Rounding is half to even (``torch.round``, as ``jnp.round``), every step in
the input's float32, so codes and scales equal JAX's bit for bit.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Any, Optional

import torch
import torch.nn.functional as F


class QuantizationMode(Enum):
    KEY = "key"
    VALUE = "value"
    GENERIC = "generic"


@dataclasses.dataclass
class QuantizationConfig:
    bits: int = 4
    symmetric: bool = True
    block_size: int = 32
    group_size: Optional[int] = None
    dtype: Any = torch.float32
    residual_length: int = 128
    channel_axis: int = -1


@dataclasses.dataclass
class QuantizedTensor:
    data: torch.Tensor
    scales: torch.Tensor
    zero_points: Optional[torch.Tensor] = None
    original_shape: Optional[tuple] = None
    mode: QuantizationMode = QuantizationMode.GENERIC
    metadata: Optional[dict] = None


def _pad_last(x, multiple):
    n = x.shape[-1]
    pad = (multiple - n % multiple) % multiple
    if pad:
        x = F.pad(x, (0, pad))
    return x, pad


def _symmetric(grouped, scales, zero_point, qmin, qmax):
    """round(x / scale) + zero_point, clamped, as uint8."""
    q = torch.round(grouped / scales) + zero_point
    return torch.clamp(q, qmin, qmax).to(torch.uint8)


class QuantizerBackend:
    """Base class: INT4 with zero-point 8 (symmetric backends)."""

    QMIN = 0
    QMAX = 15
    ZERO_POINT = 8

    def __init__(self, config: Optional[QuantizationConfig] = None):
        self.config = config or QuantizationConfig()

    @property
    def name(self):
        return self.__class__.__name__


class _GroupedSymmetric(QuantizerBackend):
    """Symmetric absmax over groups of ``_group()`` values of the last
    dimension (padded with zeros to a whole group), the group size kept in
    the metadata under META_KEY."""

    META_KEY = ""

    def _group(self) -> int:
        raise NotImplementedError

    def quantize(self, x, mode=QuantizationMode.GENERIC):
        x = torch.as_tensor(x)
        original_shape = tuple(x.shape)
        group = self._group()
        xp, pad = _pad_last(x, group)
        grouped = xp.reshape(*xp.shape[:-1], xp.shape[-1] // group, group)
        scales = torch.clamp(grouped.abs().amax(dim=-1), min=1e-8) / 7.0
        q = _symmetric(grouped, scales[..., None], self.ZERO_POINT, self.QMIN, self.QMAX)
        q = q.reshape(*xp.shape[:-1], -1)
        if pad:
            q = q[..., :-pad]
        return QuantizedTensor(
            data=q.reshape(original_shape),
            scales=scales,
            original_shape=original_shape,
            mode=mode,
            metadata={self.META_KEY: group, "pad_size": pad},
        )

    def dequantize(self, qt: QuantizedTensor):
        group = (qt.metadata or {}).get(self.META_KEY, self._group())
        q = torch.as_tensor(qt.data)
        qp, pad = _pad_last(q, group)
        grouped = qp.reshape(*qt.scales.shape, group).to(self.config.dtype)
        x = (grouped - self.ZERO_POINT) * qt.scales[..., None]
        x = x.reshape(*qp.shape[:-1], -1)
        if pad:
            x = x[..., :-pad]
        return x.reshape(q.shape).to(self.config.dtype)


class BlockAbsmaxQuantizer(_GroupedSymmetric):
    """Per-block symmetric absmax over the last dimension (the default)."""

    META_KEY = "block_size"

    def _group(self):
        return self.config.block_size


class GroupWiseQuantizer(_GroupedSymmetric):
    """Symmetric group-wise quantization (GPTQ-style granularity)."""

    META_KEY = "group_size"

    def _group(self):
        return self.config.group_size or 128


class PerTokenQuantizer(QuantizerBackend):
    """One symmetric scale per position along the last axis reduction
    (good for the value cache, per the KIVI paper)."""

    def quantize(self, x, mode=QuantizationMode.GENERIC):
        x = torch.as_tensor(x)
        scales = torch.clamp(x.abs().amax(dim=-1), min=1e-8) / 7.0
        q = _symmetric(x, scales[..., None], self.ZERO_POINT, self.QMIN, self.QMAX)
        return QuantizedTensor(data=q, scales=scales, original_shape=tuple(x.shape), mode=mode)

    def dequantize(self, qt: QuantizedTensor):
        return ((torch.as_tensor(qt.data).to(self.config.dtype) - self.ZERO_POINT)
                * qt.scales[..., None]).to(self.config.dtype)


class PerChannelQuantizer(QuantizerBackend):
    """One symmetric scale per channel (last axis), reducing over all
    leading dims (good for the key cache - keys carry fixed-channel
    outliers)."""

    def quantize(self, x, mode=QuantizationMode.GENERIC):
        x = torch.as_tensor(x)
        reduce_dims = tuple(range(x.ndim - 1))
        scales = torch.clamp(x.abs().amax(dim=reduce_dims), min=1e-8) / 7.0
        q = _symmetric(x, scales, self.ZERO_POINT, self.QMIN, self.QMAX)
        return QuantizedTensor(data=q, scales=scales, original_shape=tuple(x.shape), mode=mode)

    def dequantize(self, qt: QuantizedTensor):
        return ((torch.as_tensor(qt.data).to(self.config.dtype) - self.ZERO_POINT)
                * qt.scales).to(self.config.dtype)


class KIVIQuantizer(QuantizerBackend):
    """KIVI asymmetric quantization (keys per-channel, values per-token).

    Q(X) = round((X - zp) / s), zp = min(X), s = (max(X) - min(X)) / (2^B - 1),
    grouped at group_size (default 32), bits configurable (default 4 here
    for ECC compatibility vs 2 in the paper).
    """

    def __init__(self, config=None):
        super().__init__(config)
        self.group_size = self.config.group_size or 32
        self.bits = self.config.bits
        self.qmax = (1 << self.bits) - 1

    def _codes(self, g, x_min, scales):
        q = torch.round((g - x_min) / scales)
        return torch.clamp(q, 0, self.qmax).to(torch.uint8)

    def _quantize_per_token(self, x):
        xp, pad = _pad_last(x, self.group_size)
        g = xp.reshape(*xp.shape[:-1], xp.shape[-1] // self.group_size, self.group_size)
        x_min = g.amin(dim=-1)
        x_max = g.amax(dim=-1)
        scales = torch.clamp((x_max - x_min) / self.qmax, min=1e-8)
        q = self._codes(g, x_min[..., None], scales[..., None])
        q = q.reshape(*xp.shape[:-1], -1)
        if pad:
            q = q[..., :-pad]
        return q.reshape(x.shape), scales, x_min

    def _quantize_per_channel(self, x):
        xp, pad = _pad_last(x, self.group_size)
        n_groups = xp.shape[-1] // self.group_size
        flat = xp.reshape(-1, n_groups, self.group_size)
        x_min = flat.amin(dim=(0, 2))
        x_max = flat.amax(dim=(0, 2))
        scales = torch.clamp((x_max - x_min) / self.qmax, min=1e-8)
        q = self._codes(flat, x_min[None, :, None], scales[None, :, None])
        q = q.reshape(*xp.shape[:-1], -1)
        if pad:
            q = q[..., :-pad]
        return q.reshape(x.shape), scales, x_min

    def quantize(self, x, mode=QuantizationMode.GENERIC):
        x = torch.as_tensor(x)
        per_channel = mode == QuantizationMode.KEY
        if per_channel:
            q, scales, zps = self._quantize_per_channel(x)
        else:
            q, scales, zps = self._quantize_per_token(x)
        return QuantizedTensor(
            data=q,
            scales=scales,
            zero_points=zps,
            original_shape=tuple(x.shape),
            mode=mode,
            metadata={
                "per_channel": per_channel,
                "group_size": self.group_size,
                "bits": self.bits,
            },
        )

    def dequantize(self, qt: QuantizedTensor):
        per_channel = (qt.metadata or {}).get("per_channel", False)
        q = torch.as_tensor(qt.data).to(self.config.dtype)
        qp, pad = _pad_last(q, self.group_size)
        if per_channel:
            n_groups = qt.scales.shape[0]
            flat = qp.reshape(-1, n_groups, self.group_size)
            x = flat * qt.scales[None, :, None] + qt.zero_points[None, :, None]
        else:
            g = qp.reshape(*qt.scales.shape, self.group_size)
            x = g * qt.scales[..., None] + qt.zero_points[..., None]
        x = x.reshape(*qp.shape[:-1], -1)
        if pad:
            x = x[..., :-pad]
        return x.reshape(q.shape).to(self.config.dtype)

    def quantize_kv(self, keys, values):
        return (
            self.quantize(keys, QuantizationMode.KEY),
            self.quantize(values, QuantizationMode.VALUE),
        )

    def dequantize_kv(self, q_keys, q_values):
        return self.dequantize(q_keys), self.dequantize(q_values)


class KIVISymmetricQuantizer(QuantizerBackend):
    """KIVI strategy selection (keys per-channel / values per-token) with
    symmetric zero-point-8 quantization, for ECC compatibility."""

    def __init__(self, config=None):
        super().__init__(config)
        self.per_channel = PerChannelQuantizer(config)
        self.per_token = PerTokenQuantizer(config)

    def quantize(self, x, mode=QuantizationMode.GENERIC):
        if mode == QuantizationMode.KEY:
            return self.per_channel.quantize(x, mode)
        return self.per_token.quantize(x, mode)

    def dequantize(self, qt: QuantizedTensor):
        if qt.mode == QuantizationMode.KEY:
            return self.per_channel.dequantize(qt)
        return self.per_token.dequantize(qt)

    def quantize_kv(self, keys, values):
        return (
            self.quantize(keys, QuantizationMode.KEY),
            self.quantize(values, QuantizationMode.VALUE),
        )

    def dequantize_kv(self, q_keys, q_values):
        return self.dequantize(q_keys), self.dequantize(q_values)


QUANTIZER_BACKENDS = {
    "block_absmax": BlockAbsmaxQuantizer,
    "per_token": PerTokenQuantizer,
    "per_channel": PerChannelQuantizer,
    "kivi": KIVIQuantizer,
    "kivi_symmetric": KIVISymmetricQuantizer,
    "group_wise": GroupWiseQuantizer,
}


def get_quantizer(name: str, config: Optional[QuantizationConfig] = None):
    if name not in QUANTIZER_BACKENDS:
        raise ValueError(
            f"Unknown quantizer backend '{name}'. "
            f"Available: {sorted(QUANTIZER_BACKENDS)}"
        )
    return QUANTIZER_BACKENDS[name](config)


def quantize_kv_cache(keys, values, backend="kivi_symmetric", config=None):
    """Quantize K and V with the KIVI-style mode split."""
    quantizer = get_quantizer(backend, config)
    qk = quantizer.quantize(keys, QuantizationMode.KEY)
    qv = quantizer.quantize(values, QuantizationMode.VALUE)
    return qk, qv, quantizer


def dequantize_kv_cache(qk, qv, quantizer):
    return quantizer.dequantize(qk), quantizer.dequantize(qv)


# =============================================================================
# Facade: reference-compatible (q, scales) API
# =============================================================================


class INT4Quantizer:
    """Backward-compatible facade over the backend registry."""

    QMIN = 0
    QMAX = 15
    ZERO_POINT = 8

    def __init__(self, block_size: int = 32, backend: str = "block_absmax"):
        self.block_size = block_size
        self.backend_name = backend
        self._backend = None

    @property
    def backend(self):
        if self._backend is None:
            self._backend = get_quantizer(
                self.backend_name, QuantizationConfig(block_size=self.block_size)
            )
        return self._backend

    def quantize_full(self, x):
        qt = self.backend.quantize(torch.as_tensor(x))
        return qt.data, qt.scales

    def dequantize_full(self, q, scales):
        qt = QuantizedTensor(data=q, scales=scales)
        return self.backend.dequantize(qt)

    def quantize_kv(self, x):
        """Per-position (last-dim) symmetric quantization used by the ECC
        cache write path: scale = max|x|/7 with a floor of 1.0 when the row
        is all zeros."""
        x = torch.as_tensor(x).to(torch.float32)
        scales = compute_quantization_scales(x)
        q = torch.clamp(torch.round(x / scales[..., None]), -8, 7) + 8
        return q.to(torch.uint8), scales

    def dequantize_kv(self, q, scales):
        return (torch.as_tensor(q).to(torch.float32) - 8.0) * scales[..., None]


class INT4QuantizerSimple(INT4Quantizer):
    """Alias kept for API parity with the reference."""


def compute_quantization_scales(tensor, axis=-1):
    """Per-position absmax scales: scale = max|x| / 7, zero rows -> 1.0."""
    abs_max = torch.as_tensor(tensor).to(torch.float32).abs().amax(dim=axis)
    scales = abs_max / 7.0
    return torch.where(scales == 0, 1.0, scales)
