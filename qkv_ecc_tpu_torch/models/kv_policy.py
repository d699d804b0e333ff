"""KV-cache protection policy and the write chain (counterpart of
``qkv_ecc_tpu/models/kv_policy.py``).

The scrubbed write chain of a decode step is quantize -> XOR the folded
scrub delta -> encode -> pack; the unscrubbed one (interpolation, a policy
without scrub, or a step that collects ECC statistics) is quantize -> encode
-> XOR the raw mask -> pack. Masks come from an explicit ``torch.Generator``
or are passed in as tensors (``mask=`` raw logical-codeword masks,
``folded=`` deltas already folded by ``swar.scrub_fold_mask``,
``read_mask=`` the read-time flips of the unprotected ``int4`` arm).

The float codecs store raw values and no scales: fp16 as bfloat16, fp8 as
e4m3 (rounded as JAX rounds, ``kernels/common.to_float_storage``), whose
bytes write injection XORs with an 8-bit mask; fp16 is never injected.
"""

from __future__ import annotations

import dataclasses

import torch

from ..codecs.fault_injection import flip_mask
from ..codecs.interpolation import interpolate_double_errors
from ..kernels import common as C
from ..kernels import swar

N_BITS = {"int4": 4, "hamming74": 7, "hamming84": 8, "golay": 24, "fp8": 8}


@dataclasses.dataclass(frozen=True)
class KVCachePolicy:
    """Cache-mode policy: codec, fault model and scrubbing.

    inject_at: "write" flips the stored codewords once (errors persist);
    "read" re-corrupts raw INT4 nibbles at every attend (the unprotected
    ``int4`` arm): the cache stays clean and each read draws fresh flips.
    scrub: correct at write time so reads only extract data nibbles;
    interpolation, read injection and per-read statistics turn it off; the
    float codecs have nothing to scrub. The default codec is JAX's,
    "fp16"."""

    codec: str = "fp16"
    ber: float = 0.0
    inject_errors: bool = False
    seed: int = 42
    use_interpolation: bool = False
    inject_at: str = "write"
    scrub: bool = True

    def with_seed(self, seed: int) -> "KVCachePolicy":
        return dataclasses.replace(self, seed=seed)

    def __post_init__(self):
        if self.inject_at not in ("write", "read"):
            raise ValueError(f"inject_at must be write|read, got {self.inject_at}")
        if self.inject_at == "read" and self.codec != "int4":
            raise ValueError("read-time injection is only defined for int4")


MODE_CONFIG = {
    "fp16": {"codec": "fp16", "use_interpolation": False},
    "fp8": {"codec": "fp8", "use_interpolation": False},
    "int4": {"codec": "int4", "use_interpolation": False, "inject_at": "read"},
    "int4-write-inject": {"codec": "int4", "use_interpolation": False},
    "int4-hamming": {"codec": "hamming74", "use_interpolation": False},
    "int4-hamming84": {"codec": "hamming84", "use_interpolation": False},
    "int4-hamming84-interp": {"codec": "hamming84", "use_interpolation": True},
    "int12-golay": {"codec": "golay", "use_interpolation": False},
}


def policy_for_mode(mode: str, ber: float = 0.0, seed: int = 42) -> KVCachePolicy:
    if mode not in MODE_CONFIG:
        raise ValueError(f"Unknown cache mode: {mode}. Valid: {list(MODE_CONFIG)}")
    cfg = MODE_CONFIG[mode]
    return KVCachePolicy(
        codec=cfg["codec"],
        ber=ber,
        inject_errors=ber > 0,
        seed=seed,
        use_interpolation=cfg["use_interpolation"],
        inject_at=cfg.get("inject_at", "write"),
    )


def read_inject(policy: KVCachePolicy) -> bool:
    """Whether reads draw fresh flips of the raw nibbles: the int4 arm."""
    return policy.inject_at == "read" and policy.inject_errors and policy.ber > 0


def write_inject(policy: KVCachePolicy) -> bool:
    """Whether a write draws flips: fp16 is the uncorrupted oracle."""
    return (policy.inject_errors and policy.ber > 0 and policy.inject_at == "write"
            and policy.codec != "fp16")


def _quantize(x: torch.Tensor):
    """Per-(position, head) symmetric INT4, scale floor 1.0 on zero rows.
    x / scale in float32, rounded half to even (as jnp.round)."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax == 0, 1.0, absmax / 7.0)
    q = torch.clamp(torch.round(x / scale[..., None]), -8, 7) + 8
    return q.to(torch.int32), scale


def _draw(mask, generator, shape, policy):
    if mask is not None:
        return mask.to(torch.int32)
    if generator is None:
        raise ValueError("fault injection needs a mask or a torch.Generator")
    return flip_mask(shape, policy.ber, N_BITS[policy.codec], generator)


def encode_kv(x, policy: KVCachePolicy, generator=None, mask=None):
    """Quantize + encode + (inject) one K or V tensor [..., D].

    Returns (logical codewords int32, scales float32, flipped bit count);
    the float codecs return their stored values (bfloat16, e4m3) and no
    scales (None)."""
    codec = policy.codec
    x = x.to(torch.float32)
    if codec in swar.FLOAT_CODECS:
        enc = C.to_float_storage(codec, x)
        flips = torch.zeros((), dtype=torch.int32, device=x.device)
        if write_inject(policy):  # fp8: flip bits of the stored bytes
            m = _draw(mask, generator, x.shape, policy).to(torch.uint8)
            flips = C.popcount(m.to(torch.int32)).sum(dtype=torch.int32)
            enc = (enc.view(torch.uint8) ^ m).view(enc.dtype)
        return enc, None, flips
    q, scale = _quantize(x)
    enc = swar.encode_codewords(codec, q, x.shape[-1])
    flips = torch.zeros((), dtype=torch.int32, device=x.device)
    if write_inject(policy):
        m = _draw(mask, generator, enc.shape, policy)
        flips = swar.C.popcount(m).sum(dtype=torch.int32)
        enc = enc ^ m
    return enc, scale, flips


def _apply_golay_fold(q, folded):
    """q' = where(bit 4, 0, q ^ (delta & 0xF)); deltas are 5-bit, so bit 4
    is set exactly when delta >= 16."""
    return torch.where(folded >= 16, 0, q ^ folded)


def _fold_for(policy, q_shape, generator, mask, folded):
    """The folded write delta of one tensor: given, or folded from the given
    or drawn raw mask."""
    if folded is not None:
        return folded
    head_dim = q_shape[-1]
    if policy.codec == "golay":
        shape = q_shape[:-1] + (swar.padded_values("golay", head_dim) // 3,)
    else:
        shape = q_shape[:-1] + (swar.padded_values(policy.codec, head_dim),)
    return swar.scrub_fold_mask(policy.codec, _draw(mask, generator, shape, policy))


def encode_kv_scrubbed(x, policy: KVCachePolicy, generator=None, mask=None,
                       folded=None):
    """Quantize + encode with the write-path scrub folded into the mask:
    scrub_codewords(encode(q) ^ mask) == encode(q ^ fold(mask)).

    Returns (scrubbed logical codewords, scales); the float codecs have
    nothing to scrub and return encode_kv's values and None."""
    codec = policy.codec
    if codec in swar.FLOAT_CODECS:
        return encode_kv(x, policy, generator, mask=mask)[:2]
    x = x.to(torch.float32)
    head_dim = x.shape[-1]
    pv = swar.padded_values(codec, head_dim)
    q, scale = _quantize(x)
    q = swar._pad_values(q, pv) & 0xF
    if write_inject(policy):
        f = _fold_for(policy, x.shape, generator, mask, folded)
        if codec == "golay":
            q = _apply_golay_fold(q, f)
        else:
            q = q ^ (f.to(torch.int32) & 0xF)
    if codec == "golay":
        return swar.golay_encode_wide(swar.golay_pack_thirds(q)), scale
    if codec == "hamming74":
        return C.hamming74_encode_i32(q), scale
    if codec == "hamming84":
        return C.hamming84_encode_i32(q), scale
    return q, scale


def encode_pack_kv_scrubbed(x, policy: KVCachePolicy, generator=None, mask=None,
                            folded=None):
    """encode_kv_scrubbed + pack_kv in one chain, the decode step's write
    path; golay rows are packed straight from the folded nibbles.

    Returns (packed rows [..., row_words], scales)."""
    codec = policy.codec
    if codec != "golay":
        cw, scale = encode_kv_scrubbed(x, policy, generator, mask=mask, folded=folded)
        return pack_kv(cw, policy, x.shape[-1]), scale
    x = x.to(torch.float32)
    head_dim = x.shape[-1]
    q, scale = _quantize(x)
    q = swar._pad_values(q, swar.padded_values("golay", head_dim))
    if write_inject(policy):
        q = _apply_golay_fold(q, _fold_for(policy, x.shape, generator, mask, folded))
    return swar.golay_pack_rows_from_nibbles(q, head_dim), scale


def hoisted_write_deltas(policy: KVCachePolicy, num_layers: int, enc_shape,
                         generator=None, raw_masks=None, rows: int = 2) -> torch.Tensor:
    """Every layer's (K, V) folded write delta in one chain (``rows`` 1: a
    latent model's one cache row).

    raw_masks: [num_layers, rows, *enc_shape] logical masks to fold, or None
    to draw them from ``generator``. enc_shape is the d12 codeword shape
    [..., C] for golay and the padded nibble shape otherwise.
    Returns uint8 [num_layers, rows, *fold shape] (golay's last axis C -> 3C)."""
    if raw_masks is None:
        raw_masks = _draw(None, generator, (num_layers, rows) + tuple(enc_shape), policy)
    return swar.scrub_fold_mask(policy.codec, raw_masks).to(torch.uint8)


def hoisted_logical_masks(policy: KVCachePolicy, num_layers: int, enc_shape,
                          generator=None, rows: int = 2) -> torch.Tensor:
    """Every layer's (K, V) raw logical-codeword mask in one chain, for the
    unscrubbed write path (encode_kv(mask=...)): [num_layers, rows,
    *enc_shape] (``rows`` 1: a latent model's one cache row), enc_shape the
    padded nibble shape (golay: the d12 codeword shape). uint8 for the
    codecs whose masks fit 8 bits, int32 for golay's 24-bit masks."""
    m = _draw(None, generator, (num_layers, rows) + tuple(enc_shape), policy)
    return m if N_BITS[policy.codec] > 8 else m.to(torch.uint8)


def pack_kv(enc, policy: KVCachePolicy, head_dim: int):
    """Logical codewords -> packed int32 storage words; the float codecs'
    values pass through."""
    if policy.codec in swar.FLOAT_CODECS:
        return enc
    return swar.pack_codewords(policy.codec, enc, head_dim)


def decode_kv(enc, scale, policy: KVCachePolicy, *, head_dim: int, seq_axis: int = 1,
              read_mask=None):
    """Decode + (interpolate along ``seq_axis``) + dequantize, the inverse of
    encode_kv.

    With policy.inject_at == "read" (the unprotected int4 arm) and injection
    on, ``read_mask`` (an int mask of enc's shape, the flips JAX draws from
    its ``read_key``) is XORed into the raw nibbles before dequantization.

    Returns (x float32 [..., head_dim], corrected, detected[, read_flips
    when read_mask is given]), the counts int32 scalars."""
    codec = policy.codec
    zero = torch.zeros((), dtype=torch.int32, device=enc.device)
    read_inject = (policy.inject_at == "read" and policy.inject_errors and policy.ber > 0
                   and read_mask is not None)
    read_flips = zero
    if codec in swar.FLOAT_CODECS:
        out = enc.to(torch.float32), zero, zero
        return out + (read_flips,) if read_mask is not None else out
    if codec == "int4":
        enc = enc.to(torch.int32)
        if read_inject:
            m = read_mask.to(torch.int32)
            read_flips = C.popcount(m).sum(dtype=torch.int32)
            enc = enc ^ m
        dec = enc & 0xF
        corrected = detected = zero
    elif codec == "golay":
        data12, cnt = swar.golay_decode_wide(enc, zero_uncorrectable=False)
        corrected = torch.where(cnt < 4, cnt, 0).sum(dtype=torch.int32)
        detected = (cnt == 4).sum(dtype=torch.int32)
        dec = swar.golay_unpack_thirds(data12)
    elif codec == "hamming74":
        dec, err = C.hamming74_decode_i32(enc.to(torch.int32))
        corrected = err.sum(dtype=torch.int32)
        detected = zero
    elif codec == "hamming84":
        dec, et = C.hamming84_decode_i32(enc.to(torch.int32))
        corrected = (et == 1).sum(dtype=torch.int32)
        detected = (et == 2).sum(dtype=torch.int32)
        if policy.use_interpolation:
            dec = interpolate_double_errors(
                dec.to(torch.uint8), et, seq_dim=seq_axis).to(torch.int32)
    else:
        swar.unsupported(codec)
    x = (dec[..., :head_dim].to(torch.float32) - 8.0) * scale[..., None]
    if read_mask is not None:
        return x, corrected, detected, read_flips
    return x, corrected, detected


def encode_kv_pair_scrubbed(k, v, policy: KVCachePolicy, k_generator=None, v_generator=None,
                            k_mask=None, v_mask=None, k_folded=None, v_folded=None):
    """encode_kv_scrubbed for a (K, V) pair, in JAX's argument order (a
    generator in each key's place). Returns ((k_codewords, k_scales),
    (v_codewords, v_scales))."""
    return (encode_kv_scrubbed(k, policy, k_generator, mask=k_mask, folded=k_folded),
            encode_kv_scrubbed(v, policy, v_generator, mask=v_mask, folded=v_folded))


# -- the forward path: the codec chain as one roundtrip ----------------------
#
# Writing S tokens and reading them back at once is the roundtrip quantize ->
# encode -> inject -> decode -> (interpolate) -> dequantize, so the forward
# (prefill, perplexity) path applies it to the K/V activations directly;
# the paged cache is only materialised for generation (models/runtime.py).

_MASK64 = (1 << 64) - 1


def stream_seed(*parts: int) -> int:
    """A 64-bit generator seed from integers (policy seed, layer, K or V,
    ...), mixed as splitmix64 so that neighbouring tuples seed unrelated
    streams: the port's counterpart of JAX's fold_in chain."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (p & _MASK64)) * 0xBF58476D1CE4E5B9 & _MASK64
        h = (h ^ (h >> 31)) * 0x94D049BB133111EB & _MASK64
        h ^= h >> 29
    return h


def empty_stats(device=None) -> dict:
    """The four ECC counters of a forward, int32 scalars at 0."""
    return {name: torch.zeros((), dtype=torch.int32, device=device)
            for name in ("errors_corrected", "errors_detected", "bits_flipped", "total_values")}


def kv_roundtrip(x, policy: KVCachePolicy, generator=None, *, seq_axis: int = 1, mask=None,
                 read_mask=None):
    """The full codec chain on one K or V tensor [..., S, ..., D]: encode
    (write flips from ``mask``, a logical-codeword mask of the codewords'
    shape, or drawn from ``generator``), decode (the int4 arm's fresh read
    flips of the nibbles from ``read_mask`` or ``generator``, added to
    bits_flipped), interpolate along ``seq_axis`` (hamming84-interp) and
    dequantize. Arguments are JAX's, a generator in the key's place.

    Returns (x processed float32, stats dict of int32 scalars)."""
    x = x.to(torch.float32)
    stats = empty_stats(x.device)
    stats["total_values"] = torch.tensor(x.numel(), dtype=torch.int32, device=x.device)
    enc, scale, flips = encode_kv(x, policy, generator, mask=mask)
    head_dim = x.shape[-1]
    if read_inject(policy):
        if read_mask is None:
            read_mask = _draw(None, generator, enc.shape, policy)
        out, corrected, detected, read_flips = decode_kv(
            enc, scale, policy, head_dim=head_dim, seq_axis=seq_axis, read_mask=read_mask)
        flips = flips + read_flips
    else:
        out, corrected, detected = decode_kv(enc, scale, policy, head_dim=head_dim,
                                             seq_axis=seq_axis)
    stats["bits_flipped"] = flips
    stats["errors_corrected"] = corrected
    stats["errors_detected"] = detected
    return out, stats


def process_kv(k, v, policy: KVCachePolicy, layer_idx: int, *, seq_axis: int = 1, masks=None,
               read_masks=None):
    """Protect one layer's (K, V) pair through kv_roundtrip. Flips come from
    ``masks`` / ``read_masks`` ([2, ...]: K's, then V's) when given, else
    from a generator on K's device seeded from (policy.seed, layer, K or V)
    (stream_seed): deterministic per seed, statistically what JAX draws
    from its keys folded the same way. Returns (k, v, stats summed over K
    and V)."""
    draws = ((write_inject(policy) and masks is None)
             or (read_inject(policy) and read_masks is None))
    outs, stats = [], None
    for i, x in enumerate((k, v)):
        gen = None
        if draws:
            gen = torch.Generator(device=x.device).manual_seed(
                stream_seed(policy.seed, layer_idx, i))
        out, s = kv_roundtrip(x, policy, gen, seq_axis=seq_axis,
                              mask=None if masks is None else masks[i],
                              read_mask=None if read_masks is None else read_masks[i])
        outs.append(out)
        stats = merge_stats(stats, s)
    return outs[0], outs[1], stats


def codeword_shape(codec: str, shape, head_dim: int) -> tuple:
    """The shape of the logical codewords (the injection domain) of K or V
    of ``shape`` [..., head_dim]: fp8's stored bytes, golay's 24-bit
    codewords (a third of its padded values), the padded values of the
    others."""
    values = swar.padded_values(codec, head_dim)
    return tuple(shape[:-1]) + (values // 3 if codec == "golay" else values,)


def forward_masks(policy: KVCachePolicy, num_layers: int, shape, device):
    """The flips that process_kv draws for a forward whose K/V have
    ``shape`` [..., head_dim] when it is given none: (write_masks,
    read_masks), each [num_layers, 2, *codeword_shape] (K's, then V's) or
    None, each (layer, K or V) drawn from its stream_seed generator on
    ``device`` as process_kv draws it. Drawn for one row (shape[0] == 1)
    and expanded along the batch, they give every row of a batch the flips
    of a forward of that row alone."""
    write, read = write_inject(policy), read_inject(policy)
    if not (write or read):
        return None, None
    es = codeword_shape(policy.codec, shape, shape[-1])
    masks = torch.stack([
        torch.stack([_draw(None, torch.Generator(device=device).manual_seed(
            stream_seed(policy.seed, layer, i)), es, policy) for i in (0, 1)])
        for layer in range(num_layers)])
    return (masks, None) if write else (None, masks)


def merge_stats(acc, new):
    """The counters of ``new`` added to ``acc`` (None: a copy of new)."""
    if acc is None:
        return dict(new)
    return {k: acc[k] + new[k] for k in acc}
