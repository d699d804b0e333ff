"""The ECC cache engine (counterpart of ``qkv_ecc_tpu/cache/engine.py``):
quantize -> encode -> (inject) -> store on write; load -> decode ->
(interpolate) -> dequantize -> attention on attend, one sequence at a time,
with the JAX engine's codec semantics and error accounting.

  * ``write`` is plain tensor work for every codec: quantize, encode and
    pack through ``kernels/swar.py``, XOR the injection masks, and store
    with one ``index_put_`` per array (the JAX package jits the same jnp
    ops; no Pallas kernel runs there).
  * ``attend`` of one decode query (S == 1) in a packed-int codec without
    interpolation reads through kernel K4, ``paged_attention_ecc`` - on the
    card the CUDA kernel, on the CPU its plain version. Everything else -
    prefill and causal S > 1, interpolation, fp16 and fp8 - takes the plain
    general path ``_attend_general``.

Decode-path semantics kept from the JAX engine: the general path keeps the
data of an uncorrectable golay codeword, K4 reads it as 0; hamming84 keeps
the data of doubles in both paths, and the general path interpolates them
along the context when asked.

Every random draw - the write masks and the read seeds of the read-inject
arm - comes from one ``torch.Generator`` seeded with ``config.seed`` (and
re-seeded by ``reset_stats``). JAX draws threefry bits from keys folded
with the layer and a counter, which a torch generator does not reproduce;
``write(masks=...)`` and ``attend(read_inject_seed=..., read_masks=...)``
take the draws as tensors instead, which is how the tests feed both engines
the same noise.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..codecs.fault_injection import flip_mask
from ..codecs.interpolation import interpolate_double_errors
from ..device import resolve_device
from ..kernels import common as C
from ..kernels import swar
from ..kernels.paged_attention import paged_attention_ecc
from .block_manager import BlockManager
from .layout import ECCCacheConfig, allocate_ecc_kv_cache

CODEC_N_BITS = {"int4": 4, "hamming74": 7, "hamming84": 8, "golay": 24, "fp8": 8}
_PACKED = ("int4", "hamming74", "hamming84", "golay")
_FLOAT = swar.FLOAT_CODECS


@dataclasses.dataclass
class ECCEngineConfig:
    """The engine's configuration (the JAX ``ECCEngineConfig``)."""

    codec: str = "hamming84"
    ber: float = 0.0
    block_size: int = 128
    num_blocks: int = 256
    inject_errors: bool = False
    seed: int = 42
    use_interpolation: bool = False
    max_seqs: int = 32
    # "write": flips persist in the stored codewords (protected arms);
    # "read": fresh flips on the raw int4 nibbles at every attend
    inject_at: str = "write"

    SUPPORTED_CODECS = ("fp16", "fp8", "int4", "hamming74", "hamming84", "golay")

    def __post_init__(self):
        if self.codec not in self.SUPPORTED_CODECS:
            raise ValueError(f"Unsupported codec: '{self.codec}'. "
                             f"Supported codecs: {sorted(self.SUPPORTED_CODECS)}")
        if self.inject_at not in ("write", "read"):
            raise ValueError(f"inject_at must be write|read: {self.inject_at}")
        if self.inject_at == "read" and self.codec != "int4":
            raise ValueError("read-time injection is only defined for the unprotected int4 arm")


def _quantize(x: torch.Tensor):
    """Per-(token, head) symmetric INT4: scale absmax / 7 (1.0 for a zero
    row), codes round(x / scale) clipped to [-8, 7], plus 8. The scale is
    absmax times the float32 reciprocal of 7, which is what XLA compiles the
    JAX engine's jitted division by the constant 7 into: the stored bits then
    compare (kv_policy's eager division differs in about 1 in 50 scales by
    an ulp)."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, 1.0, absmax * torch.tensor(1 / 7, dtype=torch.float32))
    q = torch.clamp(torch.round(x / scale[..., None]), -8, 7) + 8
    return q.to(torch.int32), scale


def _popsum(m: torch.Tensor) -> torch.Tensor:
    return C.popcount(m.to(torch.int32)).sum(dtype=torch.int32)


def _write_step(cache, k, v, layer_idx, phys, slots, masks, *, codec, head_dim):
    """Quantize + encode + (XOR ``masks``, logical codeword masks) + pack S
    tokens k, v [S, H, D] and store them at (phys[s], slots[s]) of layer
    ``layer_idx``, data and parity into their own arrays, in place. Returns
    the flipped bit count (an int32 tensor)."""
    kq, ks = _quantize(k.to(torch.float32))
    vq, vs = _quantize(v.to(torch.float32))
    kc = swar.encode_codewords(codec, kq, head_dim)
    vc = swar.encode_codewords(codec, vq, head_dim)
    flips = torch.zeros((), dtype=torch.int32, device=k.device)
    if masks is not None:
        km, vm = (m.to(device=k.device, dtype=torch.int32) for m in masks)
        flips = _popsum(km) + _popsum(vm)
        kc, vc = kc ^ km, vc ^ vm
    kc = swar.pack_codewords(codec, kc, head_dim)
    vc = swar.pack_codewords(codec, vc, head_dim)
    dw = cache["k_cache"].shape[3]
    cache["k_cache"][layer_idx, phys, :, :, slots] = kc[..., :dw]
    cache["v_cache"][layer_idx, phys, :, :, slots] = vc[..., :dw]
    if "k_parity" in cache:
        cache["k_parity"][layer_idx, phys, :, :, slots] = kc[..., dw:]
        cache["v_parity"][layer_idx, phys, :, :, slots] = vc[..., dw:]
    cache["k_scales"][layer_idx, phys, :, slots] = ks
    cache["v_scales"][layer_idx, phys, :, slots] = vs
    return flips


def _write_step_float(cache, k, v, layer_idx, phys, slots, masks, *, codec):
    """fp16 / fp8: store the values as JAX rounds them (bfloat16; e4m3 with
    NaN past +-464, ``C.to_fp8_e4m3``); fp8's bytes XORed with ``masks``
    when given. Returns the flipped bit count."""
    kc, vc = C.to_float_storage(codec, k), C.to_float_storage(codec, v)
    flips = torch.zeros((), dtype=torch.int32, device=k.device)
    if masks is not None:
        km, vm = (m.to(device=k.device, dtype=torch.uint8) for m in masks)
        flips = _popsum(km) + _popsum(vm)
        kc = (kc.view(torch.uint8) ^ km).view(kc.dtype)
        vc = (vc.view(torch.uint8) ^ vm).view(vc.dtype)
    for name, x in (("k_cache", kc), ("v_cache", vc)):
        C.fp8_as_bytes(cache[name])[layer_idx, phys, :, :, slots] = C.fp8_as_bytes(x)
    return flips


def _attend_general(q, cache, table_row, layer_idx, *, codec, use_interpolation, head_dim,
                    num_ctx, causal, read_masks=None):
    """Gather + decode + (interpolate) + dequantize + attention over one
    sequence's first ``num_ctx`` tokens, in float32. q [Hq, S, D];
    table_row [pages]. ``read_masks`` (K, V) flip the int4 nibbles read.
    Returns (out [Hq, S, D] float32, corrected, detected, read flips)."""
    bs = cache["k_cache"].shape[4]
    n_pages = -(-num_ctx // bs)
    table = table_row[:n_pages].clamp(min=0).long()

    def gather(arr):
        g = C.fp8_as_bytes(arr)[layer_idx][table]  # [pages, H, w, bs]
        g = g.permute(0, 3, 1, 2).reshape(n_pages * bs, g.shape[1], -1)[:num_ctx]
        return g.view(arr.dtype)

    def gather_scales(arr):
        g = arr[layer_idx][table]  # [pages, H, bs]
        return g.permute(0, 2, 1).reshape(n_pages * bs, -1)[:num_ctx]

    k_raw, v_raw = gather(cache["k_cache"]), gather(cache["v_cache"])
    if "k_parity" in cache:
        k_raw = torch.cat([k_raw, gather(cache["k_parity"])], dim=-1)
        v_raw = torch.cat([v_raw, gather(cache["v_parity"])], dim=-1)
    zero = torch.zeros((), dtype=torch.int32, device=q.device)
    corrected = detected = read_flips = zero
    if codec in _FLOAT:
        k_f, v_f = k_raw.to(torch.float32), v_raw.to(torch.float32)
    else:
        k_raw = swar.unpack_codewords(codec, k_raw, head_dim)
        v_raw = swar.unpack_codewords(codec, v_raw, head_dim)
        if read_masks is not None:
            km, vm = (m.to(device=q.device, dtype=torch.int32) for m in read_masks)
            read_flips = _popsum(km) + _popsum(vm)
            k_raw, v_raw = k_raw ^ km, v_raw ^ vm

        def decode(raw):
            """-> (nibbles [T, H, head_dim], ErrorType or None, corrected,
            detected)"""
            if codec == "int4":
                return raw & 0xF, None, zero, zero
            if codec == "hamming74":
                data, err = C.hamming74_decode_i32(raw)
                return data[..., :head_dim], None, err.sum(dtype=torch.int32), zero
            if codec == "hamming84":
                data, et = C.hamming84_decode_i32(raw)
                return (data[..., :head_dim], et[..., :head_dim],
                        (et == 1).sum(dtype=torch.int32), (et == 2).sum(dtype=torch.int32))
            # golay keeps the data of an uncorrectable codeword here
            d12, cnt = swar.golay_decode_wide(raw, zero_uncorrectable=False)
            return (swar.golay_unpack_thirds(d12)[..., :head_dim], None,
                    torch.where(cnt < 4, cnt, 0).sum(dtype=torch.int32),
                    (cnt == 4).sum(dtype=torch.int32))

        def dequant(raw, scales_arr):
            nonlocal corrected, detected
            nib, et, corr, det = decode(raw)
            corrected, detected = corrected + corr, detected + det
            if codec == "hamming84" and use_interpolation:
                nib = interpolate_double_errors(nib.to(torch.uint8), et, seq_dim=0)
            nib = nib[..., :head_dim].to(torch.float32)
            return (nib - 8.0) * gather_scales(scales_arr)[..., None]

        k_f = dequant(k_raw, cache["k_scales"])
        v_f = dequant(v_raw, cache["v_scales"])
    Hq, S, D = q.shape
    Hkv = k_f.shape[1]
    qg = q.reshape(Hkv, Hq // Hkv, S, D).to(torch.float32)
    s = torch.einsum("hgsd,thd->hgst", qg, k_f) / torch.sqrt(
        torch.tensor(float(D), device=q.device))
    if causal:  # the last S queries sit at the last S context tokens
        qi = torch.arange(S, device=q.device)[:, None]
        tj = torch.arange(num_ctx, device=q.device)[None, :]
        s = torch.where((tj <= qi + num_ctx - S)[None, None], s, torch.full_like(s, -1e30))
    out = torch.einsum("hgst,thd->hgsd", torch.softmax(s, dim=-1), v_f).reshape(Hq, S, D)
    return out, corrected, detected, read_flips


class ECCEngine:
    """Owns the cache arrays, the block manager, the generator and the
    error statistics; ``device`` None means the card."""

    def __init__(self, config: ECCEngineConfig, num_layers: int, num_heads: int,
                 num_kv_heads: int, head_dim: int, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads
        self.head_dim = head_dim
        self.num_kv_groups = num_heads // num_kv_heads
        self.cache_config = ECCCacheConfig(
            num_blocks=config.num_blocks, block_size=config.block_size, num_layers=num_layers,
            num_kv_heads=num_kv_heads, head_dim=head_dim, codec=config.codec,
            max_seqs=config.max_seqs)
        self.cache = allocate_ecc_kv_cache(self.cache_config, device=self.device)
        self.manager = BlockManager(config.num_blocks, config.block_size, config.max_seqs,
                                    device=self.device)
        self.reset_stats()

    # --- statistics -------------------------------------------------------

    def reset_stats(self):
        self._injection_count = 0
        self._errors_corrected = 0
        self._errors_detected = 0
        self._total_values = 0
        self._bits_flipped = 0
        self._total_bits = 0
        self._read_count = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.config.seed)

    def reset(self):
        self.manager.reset()
        for arr in self.cache.values():
            arr.zero_()
        self.reset_stats()

    @property
    def stats(self):
        return {
            "injection_count": self._injection_count,
            "errors_corrected": self._errors_corrected,
            "errors_detected": self._errors_detected,
            "total_values": self._total_values,
            "bits_flipped": self._bits_flipped,
            "total_bits": self._total_bits,
            "actual_ber": self._bits_flipped / self._total_bits if self._total_bits else 0.0,
        }

    # --- write ------------------------------------------------------------

    def _inject(self) -> bool:
        c = self.config
        return bool(c.inject_errors and c.ber > 0 and c.codec != "fp16"
                    and c.inject_at == "write")

    def mask_shape(self, num_tokens: int):
        """The shape of one write's K or V injection mask: logical codewords
        [S, Hkv, values] (golay: values / 3 codewords), fp8's bytes
        [S, Hkv, D]."""
        codec = self.config.codec
        if codec in _FLOAT:
            return (num_tokens, self.num_kv_heads, self.head_dim)
        pv = swar.padded_values(codec, self.head_dim)
        return (num_tokens, self.num_kv_heads, pv // 3 if codec == "golay" else pv)

    def write(self, k, v, layer_idx: int, seq_id: int = 0, start_pos: int = 0, masks=None):
        """Write S tokens at positions [start_pos, start_pos + S).

        k, v: [S, H*D] or [S, H, D] float tensors. With write injection the
        masks (K, V) of ``mask_shape(S)`` are drawn from the generator, or
        taken from ``masks``."""
        k = torch.as_tensor(k, device=self.device)
        v = torch.as_tensor(v, device=self.device)
        if k.dim() == 2:
            k = k.reshape(k.shape[0], self.num_kv_heads, self.head_dim)
            v = v.reshape(v.shape[0], self.num_kv_heads, self.head_dim)
        S = k.shape[0]
        self._total_values += 2 * S * self.num_kv_heads * self.head_dim
        end = start_pos + S
        if self.manager.get_context_len(seq_id) < end:
            self.manager.allocate(seq_id, end)
        phys, slots = self.manager.physical_slots(seq_id, range(start_pos, end))
        phys = torch.from_numpy(phys).long().to(self.device)
        slots = torch.from_numpy(slots).long().to(self.device)
        codec = self.config.codec
        inject = self._inject()
        if inject:
            self._injection_count += 1
            if masks is None:
                n_bits = CODEC_N_BITS[codec]
                masks = [flip_mask(self.mask_shape(S), self.config.ber, n_bits, self.generator)
                         for _ in range(2)]
        else:
            masks = None
        if codec in _FLOAT:
            flips = _write_step_float(self.cache, k, v, layer_idx, phys, slots, masks,
                                      codec=codec)
        else:
            flips = _write_step(self.cache, k, v, layer_idx, phys, slots, masks, codec=codec,
                                head_dim=self.head_dim)
        if inject:
            self._bits_flipped += int(flips)
            shape = self.mask_shape(S)
            self._total_bits += 2 * math.prod(shape) * CODEC_N_BITS[codec]

    # --- attend -----------------------------------------------------------

    def attend(self, q, layer_idx: int, seq_id: int = 0, read_inject_seed=None,
               read_masks=None):
        """Attention of q [Hq, S, D] (or [1, Hq, S, D]) over the cached
        context of seq_id; returns the same shape (float32 from the general
        path, the query's dtype from K4).

        The read-inject arm draws the seed of a K4 read (S == 1) or the
        masks (K, V) of a general read from the generator, unless
        ``read_inject_seed`` / ``read_masks`` give them."""
        q = torch.as_tensor(q, device=self.device)
        squeeze = q.dim() == 4
        if squeeze:
            if q.shape[0] != 1:
                raise ValueError("engine attend is per-sequence")
            q = q[0]
        Hq, S, D = q.shape
        ctx = self.manager.get_context_len(seq_id)
        if ctx == 0:
            out = torch.zeros_like(q)
            return out[None] if squeeze else out
        c = self.config
        read = bool(c.inject_at == "read" and c.inject_errors and c.ber > 0)
        if read:
            self._read_count += 1
        use_fused = S == 1 and c.codec in _PACKED and not c.use_interpolation
        table = self.manager.block_table()
        if use_fused:
            kwargs = {}
            if read:
                if read_inject_seed is None:
                    read_inject_seed = torch.randint(
                        -2 ** 31, 2 ** 31, (), generator=self.generator,
                        device=self.device).to(torch.int32)
                kwargs = dict(read_inject_ber=float(c.ber), read_inject_seed=read_inject_seed,
                              collect_stats=True)
            out = paged_attention_ecc(
                q[:, 0, :][None].contiguous(), self.cache["k_cache"], self.cache["v_cache"],
                self.cache["k_scales"], self.cache["v_scales"], table[seq_id:seq_id + 1],
                torch.tensor([ctx], dtype=torch.int32, device=self.device), layer_idx,
                self.cache.get("k_parity"), self.cache.get("v_parity"), codec=c.codec,
                block_size=c.block_size, num_pages=-(-ctx // c.block_size), **kwargs)
            if read:
                out, kstats = out
                self._bits_flipped += int(kstats[0, 0])
                self._total_bits += self._read_bits(ctx)
            out = out[0][:, None, :]  # [Hq, 1, D]
        else:
            if read and read_masks is None:
                shape = (ctx, self.num_kv_heads, swar.padded_values("int4", self.head_dim))
                read_masks = [flip_mask(shape, c.ber, 4, self.generator) for _ in range(2)]
            out, corrected, detected, read_flips = _attend_general(
                q, self.cache, table[seq_id], layer_idx, codec=c.codec,
                use_interpolation=c.use_interpolation, head_dim=self.head_dim, num_ctx=ctx,
                causal=S > 1, read_masks=read_masks if read else None)
            self._errors_corrected += int(corrected)
            self._errors_detected += int(detected)
            if read:
                self._bits_flipped += int(read_flips)
                self._total_bits += self._read_bits(ctx)
        return out[None] if squeeze else out

    def _read_bits(self, ctx: int) -> int:
        """The raw int4 bits one read of ``ctx`` tokens sees, K and V."""
        return 2 * ctx * self.num_kv_heads * swar.padded_values("int4", self.head_dim) * 4
