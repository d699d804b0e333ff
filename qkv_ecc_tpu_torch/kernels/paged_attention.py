"""Fused decode-step cache write + paged attention (counterpart of
``qkv_ecc_tpu/kernels/paged_attention.py``: ``paged_attention_ecc_write_attend``
in scrub-extract mode and in the hamming84 correcting read with and without
interpolation, ``gather_pages``, ``gather_scales`` and
``paged_attention_ecc_reference``).

Two hand-written CUDA kernels serve ``paged_attention_ecc_write_attend``:

  * ``csrc/write_attend.cu`` (K1): the scrub-extract read of every packed
    codec; its launches are counted in
    ``paged_attention_ecc_write_attend.launches``;
  * ``csrc/decode_attend.cu``: the hamming84 correcting read (SECDED decode
    of data ++ parity, optionally the temporal interpolation of double
    errors); its launches are counted in ``write_decode_attend.launches``.

For tensors on the card the wrapper launches the kernel or raises; for
tensors on the CPU it runs the kernel's plain PyTorch version
(``write_attend_plain``, ``write_decode_attend_plain``). The caches are
updated in place (the JAX version returns updated copies).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import swar
from ._build import load

_NEG_INF = -1e30
# (data words per row, GQA group, head_dim) instantiated in
# csrc/write_attend.cu: those of the registered models, tiny-llama (int4,
# golay, hamming84: 2 words; hamming74 pads 16 values to 32: 4 words) and
# bench-0.9b (16 words in every codec)
KERNEL_SHAPES = ((2, 2, 16), (4, 2, 16), (16, 2, 128))
# (data words per row, GQA group) instantiated in csrc/decode_attend.cu, each
# with and without interpolation; head_dim is 8 * data words for hamming84
DECODE_KERNEL_SHAPES = ((2, 2), (16, 2))


def gather_pages(cache, block_table, layer_idx, num_pages, parity=None):
    """[batch, num_pages*block_size, kv_heads, words] token-major rows from
    the token-minor paged cache (invalid pages clamp to block 0). With
    ``parity`` the parity words are appended on the word axis."""
    def one(arr):
        table = block_table[:, :num_pages].clamp(min=0).long()
        g = arr[layer_idx][table]  # [batch, pages, heads, w, bs]
        b, p, h, w, bs = g.shape
        return g.permute(0, 1, 4, 2, 3).reshape(b, p * bs, h, w)

    rows = one(cache)
    if parity is not None:
        rows = torch.cat([rows, one(parity)], dim=-1)
    return rows


def gather_scales(scales, block_table, layer_idx, num_pages):
    """[batch, tokens, kv_heads] scales from [layers, blocks, heads, bs]."""
    table = block_table[:, :num_pages].clamp(min=0).long()
    g = scales[layer_idx][table]  # [batch, pages, heads, bs]
    b, p, h, bs = g.shape
    return g.permute(0, 1, 3, 2).reshape(b, p * bs, h)


def paged_attention_ecc_reference(query, k_cache, v_cache, k_scales, v_scales,
                                  block_table, context_lens, layer_idx,
                                  k_parity=None, v_parity=None, *, codec: str,
                                  num_pages=None, sm_scale=None):
    """Plain paged attention with explicit unpack + decode of full rows, in
    float32 (golay zeroes uncorrectable codewords, hamming84 doubles keep
    their data; no interpolation)."""
    batch, num_q_heads, head_dim = query.shape
    num_kv_heads = k_cache.shape[2]
    group = num_q_heads // num_kv_heads
    num_pages = block_table.shape[1] if num_pages is None else num_pages
    sm_scale = float(head_dim) ** -0.5 if sm_scale is None else sm_scale

    def decode(cache, parity, scales):
        raw = gather_pages(cache, block_table, layer_idx, num_pages, parity)
        cw = swar.unpack_codewords(codec, raw, head_dim)
        nib = swar.decode_values(codec, cw, head_dim, zero_uncorrectable=True)
        s = gather_scales(scales, block_table, layer_idx, num_pages)
        return ((nib.to(torch.float32) - 8.0) * s[..., None]).movedim(1, 2)

    k = decode(k_cache, k_parity, k_scales)  # [batch, kv_heads, tokens, D]
    v = decode(v_cache, v_parity, v_scales)
    q = query.reshape(batch, num_kv_heads, group, head_dim).to(torch.float32)
    s = torch.einsum("bhgd,bhtd->bhgt", q, k) * sm_scale
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < context_lens[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, _NEG_INF))
    w = torch.softmax(s, dim=-1)
    w = torch.where(mask.any(-1)[:, None, None, None], w, torch.zeros_like(w))
    out = torch.einsum("bhgt,bhtd->bhgd", w, v)
    return out.reshape(batch, num_q_heads, head_dim).to(query.dtype)


def _write_column(cols, arrays, scale_cols, scale_arrays, block_table, context_lens,
                  layer_idx):
    """Store each sequence's new columns (``cols[i]`` [B, Hkv, w] into
    ``arrays[i]``) and scales at slot ctx-1, in place; rows whose slot has
    no page (ctx 0, beyond the table, page -1) are skipped, as the kernels
    skip them."""
    bs = arrays[0].shape[4]
    tok = context_lens.long() - 1
    pidx = tok.clamp(min=0) // bs
    inside = (tok >= 0) & (pidx < block_table.shape[1])
    phys = block_table.long().gather(1, pidx.clamp(max=block_table.shape[1] - 1)[:, None])[:, 0]
    rows = torch.nonzero(inside & (phys >= 0))[:, 0]
    phys, slot = phys[rows], tok[rows] % bs
    for col, arr in zip(cols, arrays):
        arr[layer_idx][phys, :, :, slot] = col[rows]
    for col, arr in zip(scale_cols, scale_arrays):
        arr[layer_idx][phys, :, slot] = col[rows].to(arr.dtype)


def _online_attend(query, kn, vn, ks, vs, context_lens, bs, *, sm_scale,
                   sliding_window):
    """The kernels' attention over dequantization-free codes: kn / vn
    [B, Hkv, tokens, D] nibbles minus 8 (float32), ks / vs [B, Hkv, tokens]
    scales. A masked softmax taken online page by page with the kernels'
    precision (bf16 q, bf16 p * v_scale against the running maximum, fp32
    sums)."""
    batch, num_q_heads, head_dim = query.shape
    num_kv_heads, tokens = kn.shape[1], kn.shape[2]
    group = num_q_heads // num_kv_heads
    q = query.to(torch.bfloat16).to(torch.float32).reshape(
        batch, num_kv_heads, group, head_dim)
    ctx = context_lens.long()[:, None]
    tok = torch.arange(tokens, device=q.device)[None, :]
    live = tok < ctx
    if sliding_window is not None:
        live = live & (tok >= ctx - sliding_window)
    live = live[:, None, None, :]  # [batch, 1, 1, tokens]
    m = torch.full((batch, num_kv_heads, group, 1), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, num_kv_heads, group, head_dim), device=q.device)
    for start in range(0, tokens, bs):
        t = slice(start, start + bs)
        s = torch.einsum("bhgd,bhtd->bhgt", q, kn[:, :, t])
        s = s * (ks[:, :, None, t] * sm_scale)
        s = torch.where(live[..., t], s, torch.full_like(s, _NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.where(live[..., t], p * vs[:, :, None, t], torch.zeros_like(p))
        pv = pv.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha + torch.einsum("bhgt,bhtd->bhgd", pv, vn[:, :, t])
        m = m_new
    out = torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                      torch.zeros_like(acc))
    return out.reshape(batch, num_q_heads, head_dim).to(query.dtype)


def write_attend_plain(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                       k_scales, v_scales, block_table, context_lens, layer_idx,
                       *, sm_scale, sliding_window=None):
    """K1's function in plain PyTorch: the in-place column write, then
    gather, unpack and dequantize the data nibbles (padding values dropped),
    and the online softmax of ``_online_attend``."""
    _write_column((k_new, v_new), (k_cache, v_cache), (ks_new, vs_new),
                  (k_scales, v_scales), block_table, context_lens, layer_idx)
    head_dim = query.shape[-1]
    num_pages = block_table.shape[1]

    def nibbles(cache):
        rows = gather_pages(cache, block_table, layer_idx, num_pages)
        nib = swar.unpack_int4(rows)[..., :head_dim].to(torch.float32) - 8.0
        return nib.movedim(1, 2)  # [batch, kv_heads, tokens, D]

    ks = gather_scales(k_scales, block_table, layer_idx, num_pages).movedim(1, 2)
    vs = gather_scales(v_scales, block_table, layer_idx, num_pages).movedim(1, 2)
    return _online_attend(query, nibbles(k_cache), nibbles(v_cache), ks, vs, context_lens,
                          k_cache.shape[4], sm_scale=sm_scale, sliding_window=sliding_window)


def h84_decode_rows(rows, data_words: int):
    """Full hamming84 rows [..., 2 * data_words] (data ++ parity) -> (the
    corrected nibbles [..., pv], the doubles mask [..., pv] bool), in value
    order, by the SWAR decoder the kernels run."""
    lo, hi = swar.h84_rebuild_cw_words(rows[..., :data_words], rows[..., data_words:])
    dec_lo, _, dbl_lo = swar.h84_swar_decode(lo)
    dec_hi, _, dbl_hi = swar.h84_swar_decode(hi)
    nib = torch.cat([swar.unpack_bytes4(dec_lo), swar.unpack_bytes4(dec_hi)], dim=-1)
    dbl = torch.cat([swar.unpack_bytes4(dbl_lo), swar.unpack_bytes4(dbl_hi)], dim=-1)
    return nib, dbl != 0


def interpolate_chunked(nib, dbl, context_lens, chunk_tokens: int):
    """Double-error interpolation along the token axis (1) of [B, T, ...]
    codes as the TPU kernel computes it chunk by chunk: a double takes
    (left + right + 1) >> 1 of its pre-interpolation neighbours; token 0 is
    its own left neighbour, and token t is its own right neighbour when t+1
    is past the context or starts a new chunk of ``chunk_tokens`` tokens
    (the kernel had not decoded the next chunk yet)."""
    T = nib.shape[1]
    tok = torch.arange(T, device=nib.device)[None, :]
    own_right = (tok + 1 >= context_lens.long()[:, None]) | ((tok + 1) % chunk_tokens == 0)
    own_right = own_right.reshape(own_right.shape + (1,) * (nib.dim() - 2))
    left = torch.cat([nib[:, :1], nib[:, :-1]], dim=1)
    right = torch.where(own_right, nib, torch.cat([nib[:, 1:], nib[:, -1:]], dim=1))
    return torch.where(dbl, (left + right + 1) >> 1, nib)


def write_decode_attend_plain(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                              k_scales, v_scales, block_table, context_lens, layer_idx,
                              k_parity, v_parity, *, sm_scale, interpolate: bool,
                              pages_per_chunk: int, sliding_window=None):
    """The decode_attend kernel's function in plain PyTorch: write the new
    full rows (data and parity columns) and scales in place, SECDED-decode
    every page of data ++ parity, interpolate the doubles chunk by chunk
    (``interpolate_chunked``) when asked, then the online softmax of
    ``_online_attend``."""
    dw = k_cache.shape[3]
    _write_column((k_new[..., :dw], v_new[..., :dw], k_new[..., dw:], v_new[..., dw:]),
                  (k_cache, v_cache, k_parity, v_parity), (ks_new, vs_new),
                  (k_scales, v_scales), block_table, context_lens, layer_idx)
    head_dim = query.shape[-1]
    num_pages, bs = block_table.shape[1], k_cache.shape[4]

    def codes(cache, parity):
        rows = gather_pages(cache, block_table, layer_idx, num_pages, parity)
        nib, dbl = h84_decode_rows(rows, dw)
        if interpolate:
            nib = interpolate_chunked(nib, dbl, context_lens, pages_per_chunk * bs)
        return (nib[..., :head_dim].to(torch.float32) - 8.0).movedim(1, 2)

    ks = gather_scales(k_scales, block_table, layer_idx, num_pages).movedim(1, 2)
    vs = gather_scales(v_scales, block_table, layer_idx, num_pages).movedim(1, 2)
    return _online_attend(query, codes(k_cache, k_parity), codes(v_cache, v_parity), ks, vs,
                          context_lens, bs, sm_scale=sm_scale, sliding_window=sliding_window)


def _check(name, problems):
    bad = [msg for ok, msg in problems if not ok]
    if bad:
        raise ValueError(f"{name}: {'; '.join(bad)}")


def _common_problems(query, new, scales_new, caches, scales, block_table, context_lens,
                     layer_idx):
    """What both kernels check: devices, contiguity, dtypes, shapes."""
    batch = query.shape[0]
    L, NB, Hkv, _, bs = caches[0].shape
    ints = (*new, *caches, block_table, context_lens)
    floats = (*scales_new, *scales)
    return [
        (all(t.device == query.device and t.is_contiguous() for t in ints + floats),
         "every tensor must be contiguous and on the query's device"),
        (all(t.dtype == torch.int32 for t in ints), "words, block table and lengths must be int32"),
        (all(t.dtype == torch.float32 for t in floats), "scales must be float32"),
        (query.dtype in (torch.bfloat16, torch.float32), "query must be bf16 or float32"),
        (all(c.shape[:3] + c.shape[4:] == (L, NB, Hkv, bs) for c in caches)
         and all(s.shape == (L, NB, Hkv, bs) for s in scales), "cache or scale shapes"),
        (new[0].shape == new[1].shape and new[0].shape[:2] == (batch, Hkv)
         and all(s.shape == (batch, Hkv) for s in scales_new), "new column or new scale shapes"),
        (block_table.dim() == 2 and block_table.shape[0] == batch and context_lens.shape == (batch,),
         "block table or context length shapes"),
        (0 <= layer_idx < L, "layer out of range"),
    ]


def _stream(query):
    return torch.cuda.current_stream(query.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _launcher(name: str, n_ptrs: int, n_ints: int, n_tail_ints: int):
    """The C launcher ``<name>_launch`` of csrc/<name>.cu, built and loaded
    at first use: n_ptrs pointers, n_ints ints, sm_scale, n_tail_ints ints,
    the stream; returns a cudaError_t."""
    fn = getattr(load(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_float]
                   + [ctypes.c_int] * n_tail_ints + [ctypes.c_void_p])
    return fn


def _launch(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
            v_scales, block_table, context_lens, layer_idx, sm_scale,
            sliding_window):
    """Check what K1 takes, allocate the output and launch
    csrc/write_attend.cu on the current stream."""
    batch, num_q_heads, head_dim = query.shape
    L, NB, Hkv, Wd, bs = k_cache.shape
    group = num_q_heads // Hkv
    _check("write_attend", _common_problems(
        query, (k_new, v_new), (ks_new, vs_new), (k_cache, v_cache), (k_scales, v_scales),
        block_table, context_lens, layer_idx) + [
        (k_new.shape[2] == Wd, "new column width"),
        (group * Hkv == num_q_heads and (Wd, group, head_dim) in KERNEL_SHAPES,
         f"(data words, GQA group, head_dim) = {(Wd, group, head_dim)} has no kernel "
         f"instance; built: {KERNEL_SHAPES}"),
    ])
    q = query if query.dtype == torch.bfloat16 else query.to(torch.bfloat16)
    out = torch.empty(query.shape, dtype=query.dtype, device=query.device)
    ptrs = (q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, v_scales,
            block_table, context_lens, out)
    rc = _launcher("write_attend", 12, 9, 2)(
        *(t.data_ptr() for t in ptrs), batch, Hkv, group, Wd, head_dim, bs, NB,
        block_table.shape[1], int(layer_idx), float(sm_scale), int(sliding_window or 0),
        int(query.dtype == torch.bfloat16), _stream(query))
    if rc != 0:
        raise RuntimeError(f"write_attend kernel launch failed: cudaError {rc}")
    paged_attention_ecc_write_attend.launches += 1
    return out


def _launch_decode(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                   v_scales, block_table, context_lens, layer_idx, k_parity, v_parity,
                   sm_scale, interpolate, pages_per_chunk, sliding_window):
    """Check what csrc/decode_attend.cu takes, allocate the output and
    launch it on the current stream."""
    batch, num_q_heads, head_dim = query.shape
    L, NB, Hkv, Wd, bs = k_cache.shape
    group = num_q_heads // Hkv
    _check("decode_attend", _common_problems(
        query, (k_new, v_new), (ks_new, vs_new), (k_cache, v_cache, k_parity, v_parity),
        (k_scales, v_scales), block_table, context_lens, layer_idx) + [
        (k_parity.shape[3] == Wd and k_new.shape[2] == 2 * Wd,
         "hamming84 rows hold as many parity words as data words"),
        (group * Hkv == num_q_heads and head_dim == 8 * Wd
         and (Wd, group) in DECODE_KERNEL_SHAPES,
         f"(data words, GQA group) = {(Wd, group)} at head_dim {head_dim} has no kernel "
         f"instance; built: {DECODE_KERNEL_SHAPES}"),
        (pages_per_chunk >= 1, "pages_per_chunk must be positive"),
    ])
    q = query if query.dtype == torch.bfloat16 else query.to(torch.bfloat16)
    out = torch.empty(query.shape, dtype=query.dtype, device=query.device)
    ptrs = (q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_parity, v_parity,
            k_scales, v_scales, block_table, context_lens, out)
    rc = _launcher("decode_attend", 14, 8, 4)(
        *(t.data_ptr() for t in ptrs), batch, Hkv, group, Wd, bs, NB, block_table.shape[1],
        int(layer_idx), float(sm_scale), int(sliding_window or 0),
        int(query.dtype == torch.bfloat16), int(pages_per_chunk * bs), int(bool(interpolate)),
        _stream(query))
    if rc != 0:
        raise RuntimeError(f"decode_attend kernel launch failed: cudaError {rc}")
    write_decode_attend.launches += 1
    return out


def write_decode_attend(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                        v_scales, block_table, context_lens, layer_idx, k_parity, v_parity,
                        *, sm_scale, interpolate: bool, pages_per_chunk: int,
                        sliding_window=None):
    """The hamming84 correcting read: on the card csrc/decode_attend.cu (or
    raise), on the CPU write_decode_attend_plain. Arguments as
    write_decode_attend_plain."""
    args = (query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, v_scales,
            block_table, context_lens, layer_idx, k_parity, v_parity)
    if query.device.type == "cuda":
        return _launch_decode(*args, sm_scale, interpolate, pages_per_chunk, sliding_window)
    if query.device.type == "cpu":
        return write_decode_attend_plain(*args, sm_scale=sm_scale, interpolate=interpolate,
                                         pages_per_chunk=pages_per_chunk,
                                         sliding_window=sliding_window)
    raise ValueError(f"decode_attend: no kernel for device {query.device}")


write_decode_attend.launches = 0


def paged_attention_ecc_write_attend(query, k_new, v_new, ks_new, vs_new,
                                     k_cache, v_cache, k_scales, v_scales,
                                     block_table, context_lens, layer_idx,
                                     k_parity=None, v_parity=None, *,
                                     codec: str, scrub: bool = True,
                                     use_interpolation: bool = False,
                                     pages_per_chunk=None, sm_scale=None,
                                     sliding_window=None, collect_stats: bool = False,
                                     read_inject_ber: float = 0.0):
    """Write the new token's packed column and scales at slot ctx-1 (in
    place), then attend over the cache. Returns the attention output
    [B, Hq, D] in query's dtype.

    query [B, Hq, D] (bf16 or fp32); ks_new/vs_new [B, Hkv] fp32; caches
    [L, NB, Hkv, data_words, bs] int32; scales [L, NB, Hkv, bs] fp32;
    block_table [B, P] int32; context_lens [B] int32 including the new token.

    scrub=True (the port's default; the JAX signature defaults to False):
    the scrub-extract read of a write-scrubbed cache, kernel K1. k_new/v_new
    are the data words [B, Hkv, data_words]; parity is not an operand (the
    caller stores the new parity column).

    scrub=False: the correcting read, streaming k_parity/v_parity
    [L, NB, Hkv, parity_words, bs]; k_new/v_new are full rows (data ++
    parity) and both columns are written. Ported for hamming84, with
    ``use_interpolation`` (kernel K3) or without (K2's hamming84 branch);
    ``pages_per_chunk`` (default: 512 tokens of pages, capped at the table)
    sets where the interpolation's chunk seams fall, as on the TPU.

    Not ported yet, and raising NotImplementedError: the hamming74 and golay
    correcting reads and ``collect_stats`` (K2), and int4 read-time
    injection (K2r)."""
    head_dim = query.shape[-1]
    if codec not in ("int4", "hamming74", "hamming84", "golay"):
        swar.unsupported(codec)
    if read_inject_ber:
        raise NotImplementedError(
            "read-time injection (mode 'int4') comes with kernel K2r, a later slice")
    if collect_stats:
        raise NotImplementedError(
            "per-read ECC statistics (collect_stats) come with kernel K2's counting "
            "pass, a later slice")
    if scrub and use_interpolation:
        raise ValueError("scrub + interpolation: scrubbing re-encodes double-error data "
                         "as valid codewords, which erases the doubles mask")
    extract = scrub and swar.scrub_extract_ok(codec, head_dim)
    if not extract and codec != "hamming84":
        raise NotImplementedError(
            f"the {codec} correcting read (kernel K2) is not ported yet")
    sm_scale = float(head_dim) ** -0.5 if sm_scale is None else sm_scale
    dw = swar.data_words(codec, head_dim)
    if k_cache.shape[3] != dw:
        raise ValueError(f"cache has {k_cache.shape[3]} data words, "
                         f"{codec} at head_dim {head_dim} has {dw}")
    if extract:
        if k_parity is not None or v_parity is not None:
            raise ValueError("the scrub-extract read takes no parity arrays: the caller "
                             "stores the new parity column")
        args = (query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                v_scales, block_table, context_lens, layer_idx)
        if query.device.type == "cuda":
            return _launch(*args, sm_scale, sliding_window)
        if query.device.type == "cpu":
            return write_attend_plain(*args, sm_scale=sm_scale, sliding_window=sliding_window)
        raise ValueError(f"write_attend: no kernel for device {query.device}")
    if k_parity is None or v_parity is None:
        raise ValueError("the hamming84 correcting read needs k_parity and v_parity")
    pw = swar.parity_words(codec, head_dim)
    if k_parity.shape[3] != pw or k_new.shape[-1] != dw + pw:
        raise ValueError(f"hamming84 at head_dim {head_dim}: parity arrays of {pw} words "
                         f"and new rows of {dw + pw} words (data ++ parity)")
    if pages_per_chunk is None:  # the TPU kernel's chunk: 512 tokens of pages
        pages_per_chunk = max(1, 512 // k_cache.shape[4])
    cp = min(pages_per_chunk, block_table.shape[1])
    return write_decode_attend(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                               k_scales, v_scales, block_table, context_lens, layer_idx,
                               k_parity, v_parity, sm_scale=sm_scale,
                               interpolate=use_interpolation, pages_per_chunk=cp,
                               sliding_window=sliding_window)


paged_attention_ecc_write_attend.launches = 0
