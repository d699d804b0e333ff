"""Paged attention over the ECC cache (counterpart of
``qkv_ecc_tpu/kernels/paged_attention.py``): the fused decode-step
write+attend ``paged_attention_ecc_write_attend``, the read-only
``paged_attention_ecc``, ``gather_pages``, ``gather_scales`` and
``paged_attention_ecc_reference``.

Hand-written CUDA kernels serve both wrappers; each reads the context with
or without writing a new column first (a runtime flag), and the read can
return the unnormalised softmax state:

  * ``csrc/write_attend.cu`` (K1, K2r and K4's reads of data words): reads
    int4-packed data words only - the scrub-extract read of every packed
    codec, and int4's general read (``scrub=False``), with the read-time
    injection of mode ``int4`` and its flipped-bit count;
  * ``csrc/decode_attend.cu`` (K2, K3 and K4's correcting reads): the
    correcting read of the parity codecs - hamming84 (optionally
    interpolating double errors), hamming74 and golay - with the per-read
    ECC statistics;
  * ``float_attend`` in ``csrc/write_attend.cu`` (K2f, and K4's reads of
    the float codecs): the raw values of fp16 (stored as bfloat16) and fp8
    (e4m3), widened to float32, with no scales, no zero point and no
    statistics (a float read that collects them returns zeros).

Launches are counted on the wrapper that made them:
``paged_attention_ecc_write_attend.launches`` (write_attend.cu),
``write_decode_attend.launches`` (decode_attend.cu) and
``paged_attention_ecc.launches`` (any kernel, for K4), each with
``launches_by`` per branch (the float branches: "fp16", "fp8").

For tensors on the card a wrapper launches the kernel or raises; for tensors
on the CPU it runs the kernel's plain PyTorch version (``write_attend_plain``,
``write_decode_attend_plain``, ``attend_plain``). The write+attend caches are
updated in place (the JAX version returns updated copies).

Like the TPU kernel, every read visits ``num_pages`` rounded up to whole
chunks of ``pages_per_chunk`` pages and reads a page past ``num_pages`` as
page ``num_pages - 1`` (the TPU's chunk copy clamps the page index): when
``num_pages`` is not a multiple of the chunk, tokens after page
``num_pages`` up to the context length attend that page's slots again.

A float read also takes from the TPU kernel which slots reach the output:
every slot of every page of each chunk that starts before the context
length, dead slots and pages before a sliding window included, with weight
0. So a NaN stored there (an fp8 byte 0x7f or 0xff) makes its head-dim
value of the output NaN, as on the TPU; a NaN in a live K slot makes the
whole row's weights NaN, and its normalised output 0 (acc / l where l > 0).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import common as C
from . import swar
from ._build import load

_NEG_INF = -1e30
_PACKED = ("int4", "hamming74", "hamming84", "golay")
_FLOAT = swar.FLOAT_CODECS
# (data words per row, GQA group, head_dim) instantiated in
# csrc/write_attend.cu, each with and without read injection: those of the
# registered models, tiny-llama (int4, golay, hamming84: 2 words; hamming74
# pads 16 values to 32: 4 words) and bench-0.9b (16 words in every codec)
KERNEL_SHAPES = ((2, 2, 16), (4, 2, 16), (16, 2, 128))
# (codec, data words, parity words, GQA group, head_dim) instantiated in
# csrc/decode_attend.cu for tiny-llama and bench-0.9b (hamming84 with and
# without interpolation)
DECODE_KERNEL_SHAPES = (
    ("hamming84", 2, 2, 2, 16), ("hamming84", 16, 16, 2, 128),
    ("hamming74", 4, 3, 2, 16), ("hamming74", 16, 12, 2, 128),
    ("golay", 2, 4, 2, 16), ("golay", 16, 17, 2, 128),
)
_CODEC_IDS = {"hamming84": 0, "hamming74": 1, "golay": 2}
# (GQA group, head_dim) instantiated in csrc/write_attend.cu's float_attend,
# for bfloat16 (fp16) and e4m3 (fp8): tiny-llama and bench-0.9b
FLOAT_KERNEL_SHAPES = ((2, 16), (2, 128))


def visited_pages(num_pages: int, pages_per_chunk: int) -> int:
    """The pages a kernel's loop visits: ``num_pages`` rounded up to whole
    chunks."""
    return C.cdiv(num_pages, pages_per_chunk) * pages_per_chunk


def _page_table(block_table, num_pages, pages_per_chunk):
    """[batch, pages] physical pages (-1 clamped to 0): the first
    ``num_pages`` entries, or with ``pages_per_chunk`` the pages a kernel
    visits, each index clamped to ``num_pages - 1``."""
    if pages_per_chunk is None:
        table = block_table[:, :num_pages]
    else:
        idx = torch.arange(visited_pages(num_pages, pages_per_chunk),
                           device=block_table.device).clamp(max=num_pages - 1)
        table = block_table[:, idx]
    return table.clamp(min=0).long()


def gather_pages(cache, block_table, layer_idx, num_pages, parity=None, pages_per_chunk=None):
    """[batch, pages*block_size, kv_heads, words] token-major rows from the
    token-minor paged cache (invalid pages clamp to block 0); the pages are
    those of ``_page_table``. With ``parity`` the parity words are appended
    on the word axis."""
    table = _page_table(block_table, num_pages, pages_per_chunk)

    def one(arr):
        g = C.fp8_as_bytes(arr)[layer_idx][table]  # [batch, pages, heads, w, bs]
        b, p, h, w, bs = g.shape
        return g.permute(0, 1, 4, 2, 3).reshape(b, p * bs, h, w).view(arr.dtype)

    rows = one(cache)
    if parity is not None:
        rows = torch.cat([rows, one(parity)], dim=-1)
    return rows


def gather_scales(scales, block_table, layer_idx, num_pages, pages_per_chunk=None):
    """[batch, tokens, kv_heads] scales from [layers, blocks, heads, bs],
    over the pages of ``_page_table``."""
    g = scales[layer_idx][_page_table(block_table, num_pages, pages_per_chunk)]
    b, p, h, bs = g.shape  # [batch, pages, heads, bs]
    return g.permute(0, 1, 3, 2).reshape(b, p * bs, h)


def paged_attention_ecc_reference(query, k_cache, v_cache, k_scales, v_scales,
                                  block_table, context_lens, layer_idx,
                                  k_parity=None, v_parity=None, *, codec: str,
                                  num_pages=None, sm_scale=None):
    """Plain paged attention with explicit unpack + decode of full rows, in
    float32 (golay zeroes uncorrectable codewords, hamming84 doubles keep
    their data; no interpolation; fp16 / fp8 widen their raw values, with
    no scales)."""
    batch, num_q_heads, head_dim = query.shape
    num_kv_heads = k_cache.shape[2]
    group = num_q_heads // num_kv_heads
    num_pages = block_table.shape[1] if num_pages is None else num_pages
    sm_scale = float(head_dim) ** -0.5 if sm_scale is None else sm_scale

    def decode(cache, parity, scales):
        raw = gather_pages(cache, block_table, layer_idx, num_pages, parity)
        if codec in _FLOAT:
            return raw.to(torch.float32).movedim(1, 2)
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
                  layer_idx, num_pages):
    """Store each sequence's new columns (``cols[i]`` [B, Hkv, w] into
    ``arrays[i]``) and scales at slot ctx-1, in place, as the TPU kernel
    does: a page entry of -1 is clamped to physical page 0 and written there;
    rows whose slot has no page (ctx 0, at or beyond ``num_pages``) are
    skipped."""
    bs = arrays[0].shape[4]
    tok = context_lens.long() - 1
    pidx = tok.clamp(min=0) // bs
    rows = torch.nonzero((tok >= 0) & (pidx < num_pages))[:, 0]
    phys = block_table.long()[rows, pidx[rows]].clamp(min=0)
    slot = tok[rows] % bs
    for col, arr in zip(cols, arrays):
        C.fp8_as_bytes(arr)[layer_idx][phys, :, :, slot] = C.fp8_as_bytes(col)[rows]
    for col, arr in zip(scale_cols, scale_arrays):
        arr[layer_idx][phys, :, slot] = col[rows].to(arr.dtype)


def _online_attend(query, kn, vn, ks, vs, context_lens, bs, *, sm_scale,
                   sliding_window, exact=False):
    """The kernels' attention over dequantization-free codes: kn / vn
    [B, Hkv, tokens, D] nibbles minus 8 (float32), ks / vs [B, Hkv, tokens]
    scales. A masked softmax taken online page by page with the kernels'
    precision: "fast" (``exact`` False) rounds q and p * v_scale to bf16,
    "highest" keeps both in float32; sums in float32. Returns the
    unnormalised state: acc [B, Hq, D], the running maximum m and the sum of
    weights l [B, Hq], float32 (an empty row: 0, -1e30, 0)."""
    batch, num_q_heads, head_dim = query.shape
    num_kv_heads, tokens = kn.shape[1], kn.shape[2]
    group = num_q_heads // num_kv_heads
    q = query.to(torch.float32) if exact else query.to(torch.bfloat16).to(torch.float32)
    q = q.reshape(batch, num_kv_heads, group, head_dim)
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
        # a row with no live token yet keeps l at 0 (exp(s - m_new) would
        # be 1 there); once one is live, the others' weights are 0 anyway
        p = torch.where(live[..., t], torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = p * vs[:, :, None, t]
        if not exact:
            pv = pv.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha + torch.einsum("bhgt,bhtd->bhgd", pv, vn[:, :, t])
        m = m_new
    return (acc.reshape(batch, num_q_heads, head_dim), m.reshape(batch, num_q_heads),
            l.reshape(batch, num_q_heads))


def _normalise(acc, l, dtype):
    """acc / l, 0 where l is 0 (an empty row), in the query's dtype."""
    l = l[..., None]
    return torch.where(l > 0, acc / torch.where(l > 0, l, torch.ones_like(l)),
                       torch.zeros_like(acc)).to(dtype)


def read_flip_mask(seed, threshold: int, layer_idx: int, batch: int, num_pages: int,
                   pages_per_chunk: int, num_kv_heads: int, data_words: int,
                   block_size: int, device=None) -> torch.Tensor:
    """The read-time flips of mode ``int4`` (the TPU kernel's
    ``_read_flip_mask``): [2 (K, V), batch, P * block_size, num_kv_heads,
    data_words] int32 over the P = ``visited_pages`` pages a kernel visits,
    in gather_pages' token-major layout. The tile of (sequence b, page p = c
    * pages_per_chunk + i of chunk c, head h, K/V t) is
    ``swar.hash_flip_mask(seed, uid * data_words * block_size, (data_words,
    block_size))`` with uid = ((((layer * batch + b) * num_chunks + c) *
    pages_per_chunk + i) * num_kv_heads + h) * 2 + t and num_chunks =
    cdiv(num_pages, pages_per_chunk): the flips depend on the batch size and
    the chunking, and a page past num_pages gets its own."""
    pages = visited_pages(num_pages, pages_per_chunk)
    ar = functools.partial(torch.arange, dtype=torch.int64, device=device)
    b = ar(batch).reshape(batch, 1, 1, 1)
    p = ar(pages).reshape(1, pages, 1, 1)
    h = ar(num_kv_heads).reshape(1, 1, num_kv_heads, 1)
    t = ar(2).reshape(1, 1, 1, 2)
    uid = (((layer_idx * batch + b) * pages + p) * num_kv_heads + h) * 2 + t
    base = (uid * (data_words * block_size)) & 0xFFFFFFFF
    m = swar.hash_flip_mask(seed, base[..., None, None], (data_words, block_size), threshold)
    # [B, P, H, 2, W, bs] -> [2, B, P * bs, H, W]
    return m.permute(3, 0, 1, 5, 2, 4).reshape(
        2, batch, pages * block_size, num_kv_heads, data_words)


def decode_rows(codec: str, rows: torch.Tensor, data_words: int, head_dim: int):
    """Full rows [..., W] (data ++ parity) -> (the corrected nibbles of the
    data words [..., 8 * data_words] in value order, the doubles mask
    [..., 8 * data_words] bool for hamming84 or None), as the correcting
    reads decode them: hamming84 keeps the data of doubles; hamming74
    corrects each value from its three parity planes; golay rebuilds the
    24-bit codewords and reads an uncorrectable one as 0; int4 splits
    nibbles."""
    dw = data_words
    if codec == "int4":
        return swar.unpack_int4(rows[..., :dw]), None
    if codec == "hamming84":
        return h84_decode_rows(rows, dw)
    if codec == "hamming74":
        p = swar._slice_unpack(rows[..., dw:], 3)
        d = swar.unpack_int4(rows[..., :dw])
        dec, _ = swar.h74_value_correct(d, p & 1, (p >> 1) & 1, (p >> 2) & 1)
        return dec, None
    if codec == "golay":
        d12, _ = swar.golay_decode_wide(swar.golay_split_unpack(rows, head_dim),
                                        zero_uncorrectable=True)
        return swar.golay_unpack_thirds(d12)[..., : 8 * dw], None
    swar.unsupported(codec)


def count_errors(codec: str, rows: torch.Tensor, valid: torch.Tensor, data_words: int,
                 head_dim: int) -> torch.Tensor:
    """Per-read ECC statistics of full rows [B, T, H, W] over the tokens
    where ``valid`` [B, T] holds: [B, 2] int32 (corrected, detected) summed
    over heads, words and valid tokens (the TPU kernel's ``_count_errors``).
    hamming84: singles and doubles; hamming74: nonzero syndromes (padding
    values included); golay: corrected bits (error counts 1-3) and
    uncorrectable codewords; int4: nothing."""
    dw = data_words
    zero = torch.zeros(rows.shape[:3], dtype=torch.int32, device=rows.device)
    if codec == "int4":
        corr, det = zero, zero
    elif codec == "hamming84":
        corr, det = zero, zero
        for piece in swar.h84_rebuild_cw_words(rows[..., :dw], rows[..., dw:]):
            _, single, double = swar.h84_swar_decode(piece)
            corr = corr + C.popcount(single).sum(-1, dtype=torch.int32)
            det = det + C.popcount(double).sum(-1, dtype=torch.int32)
    elif codec == "hamming74":
        p = swar._slice_unpack(rows[..., dw:], 3)
        _, err = swar.h74_value_correct(swar.unpack_int4(rows[..., :dw]), p & 1,
                                        (p >> 1) & 1, (p >> 2) & 1)
        corr, det = err.sum(-1, dtype=torch.int32), zero
    elif codec == "golay":
        _, cnt = swar.golay_decode_wide(swar.golay_split_unpack(rows, head_dim),
                                        zero_uncorrectable=True)
        corr = torch.where(cnt < 4, cnt, 0).sum(-1, dtype=torch.int32)
        det = (cnt == 4).sum(-1, dtype=torch.int32)
    else:
        swar.unsupported(codec)
    v = valid[:, :, None]
    return torch.stack([torch.where(v, corr, 0).sum((1, 2), dtype=torch.int32),
                        torch.where(v, det, 0).sum((1, 2), dtype=torch.int32)], dim=1)


def _valid_tokens(context_lens, tokens):
    return torch.arange(tokens, device=context_lens.device)[None, :] < context_lens.long()[:, None]


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


def _read(query, k_cache, v_cache, k_scales, v_scales, block_table, context_lens, layer_idx,
          k_parity=None, v_parity=None, *, codec, sm_scale, num_pages, pages_per_chunk,
          precision="fast", sliding_window=None, read_threshold=None, read_seed=0,
          interpolate=False, collect_stats=False):
    """What every kernel reads, in plain PyTorch: the pages the kernel
    visits (``visited_pages``, F4's clamp included), then

      * codec "int4" (the data words alone: int4, and the scrub-extract read
        of every packed codec): the nibbles, XORed first with
        ``read_flip_mask`` when ``read_threshold`` is set;
      * the parity codecs: full rows decoded by ``decode_rows``, hamming84's
        doubles interpolated chunk by chunk (``interpolate_chunked``) when
        ``interpolate``;
      * fp16 / fp8: ``_float_values``, with scales of 1;

    attended as ``_online_attend``. Returns (acc, m, l) and the stats [B, 2]
    int32 over the valid tokens (zeros without ``collect_stats``, and for
    the float codecs): the flipped read bits in slot 0 with read injection,
    else ``count_errors``."""
    batch, head_dim = query.shape[0], query.shape[-1]
    _, _, Hkv, dw, bs = k_cache.shape
    pages = visited_pages(num_pages, pages_per_chunk)
    valid = _valid_tokens(context_lens, pages * bs)
    stats = torch.zeros((batch, 2), dtype=torch.int32, device=query.device)
    if codec in _FLOAT:
        k, v = _float_values(k_cache, v_cache, block_table, context_lens, layer_idx, num_pages,
                             pages_per_chunk)
        ones = torch.ones(k.shape[:3], device=query.device)
        state = _online_attend(query, k, v, ones, ones, context_lens, bs, sm_scale=sm_scale,
                               sliding_window=sliding_window, exact=precision == "highest")
        return state, stats
    flips = None
    if read_threshold is not None:
        flips = read_flip_mask(read_seed, read_threshold, layer_idx, batch, num_pages,
                               pages_per_chunk, Hkv, dw, bs, device=query.device)
        if collect_stats:
            v = valid[None, :, :, None, None]
            stats[:, 0] = torch.where(v, C.popcount(flips), 0).sum((0, 2, 3, 4),
                                                                   dtype=torch.int32)

    def codes(cache, parity, t):
        nonlocal stats
        rows = gather_pages(cache, block_table, layer_idx, num_pages,
                            None if codec == "int4" else parity, pages_per_chunk)
        if codec == "int4":
            nib = swar.unpack_int4(rows if flips is None else rows ^ flips[t])
        else:
            if collect_stats:
                stats = stats + count_errors(codec, rows, valid, dw, head_dim)
            nib, dbl = decode_rows(codec, rows, dw, head_dim)
            if interpolate and codec == "hamming84":
                nib = interpolate_chunked(nib, dbl, context_lens, pages_per_chunk * bs)
        return (nib[..., :head_dim].to(torch.float32) - 8.0).movedim(1, 2)

    def scales(s):
        return gather_scales(s, block_table, layer_idx, num_pages, pages_per_chunk).movedim(1, 2)

    state = _online_attend(query, codes(k_cache, k_parity, 0), codes(v_cache, v_parity, 1),
                           scales(k_scales), scales(v_scales), context_lens, bs,
                           sm_scale=sm_scale, sliding_window=sliding_window,
                           exact=precision == "highest")
    return state, stats


def _float_values(k_cache, v_cache, block_table, context_lens, layer_idx, num_pages,
                  pages_per_chunk):
    """K and V of a float cache as the TPU kernel attends them: [B, Hkv,
    tokens, D] float32 over the pages a kernel visits; V is 0 past the
    chunks the TPU kernel processes (those that start before the context
    length), so that only the slots it reads can carry a NaN into the
    output (module docstring)."""
    def vals(cache):
        return gather_pages(cache, block_table, layer_idx, num_pages,
                            pages_per_chunk=pages_per_chunk).to(torch.float32).movedim(1, 2)

    k, v = vals(k_cache), vals(v_cache)
    tpc = pages_per_chunk * k_cache.shape[4]
    processed = -(-context_lens.long() // tpc) * tpc
    seen = torch.arange(k.shape[2], device=k.device)[None, :] < processed[:, None]
    return k, torch.where(seen[:, None, :, None], v, torch.zeros_like(v))


def write_attend_plain(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                       v_scales, block_table, context_lens, layer_idx, *, sm_scale,
                       num_pages=None, precision="fast", sliding_window=None,
                       read_threshold=None, read_seed=0, pages_per_chunk=1,
                       collect_stats=False, codec="int4"):
    """K1's function in plain PyTorch: the in-place column write, then
    ``_read`` of the data words (with ``read_threshold``, XORed with
    ``read_flip_mask``; the cache keeps its clean words). Returns the
    output, or (output, stats [B, 2] int32) with ``collect_stats``: slot 0
    counts the flipped read bits over the valid tokens. With codec "fp16"
    or "fp8", K2f's: the new values are written and read raw, the scales
    are left as they are, and the stats are zeros."""
    num_pages = block_table.shape[1] if num_pages is None else num_pages
    scaled = codec not in _FLOAT
    _write_column((k_new, v_new), (k_cache, v_cache), (ks_new, vs_new) if scaled else (),
                  (k_scales, v_scales) if scaled else (), block_table, context_lens, layer_idx,
                  num_pages)
    (acc, _, l), stats = _read(
        query, k_cache, v_cache, k_scales, v_scales, block_table, context_lens, layer_idx,
        codec=codec, sm_scale=sm_scale, num_pages=num_pages, pages_per_chunk=pages_per_chunk,
        precision=precision, sliding_window=sliding_window, read_threshold=read_threshold,
        read_seed=read_seed, collect_stats=collect_stats)
    out = _normalise(acc, l, query.dtype)
    return (out, stats) if collect_stats else out


def write_decode_attend_plain(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                              k_scales, v_scales, block_table, context_lens, layer_idx,
                              k_parity, v_parity, *, codec, sm_scale, pages_per_chunk,
                              interpolate=False, num_pages=None, precision="fast",
                              sliding_window=None, collect_stats=False):
    """The decode_attend kernel's function in plain PyTorch: write the new
    full rows (data and parity columns) and scales in place, then ``_read``
    the full rows through the codec's correcting decode. Returns the output,
    or (output, stats [B, 2] int32 of ``count_errors`` over K and V) with
    ``collect_stats``."""
    num_pages = block_table.shape[1] if num_pages is None else num_pages
    dw = k_cache.shape[3]
    _write_column((k_new[..., :dw], v_new[..., :dw], k_new[..., dw:], v_new[..., dw:]),
                  (k_cache, v_cache, k_parity, v_parity), (ks_new, vs_new),
                  (k_scales, v_scales), block_table, context_lens, layer_idx, num_pages)
    (acc, _, l), stats = _read(
        query, k_cache, v_cache, k_scales, v_scales, block_table, context_lens, layer_idx,
        k_parity, v_parity, codec=codec, sm_scale=sm_scale, num_pages=num_pages,
        pages_per_chunk=pages_per_chunk, precision=precision, sliding_window=sliding_window,
        interpolate=interpolate, collect_stats=collect_stats)
    out = _normalise(acc, l, query.dtype)
    return (out, stats) if collect_stats else out


def attend_plain(query, k_cache, v_cache, k_scales, v_scales, block_table, context_lens,
                 layer_idx, k_parity=None, v_parity=None, *, codec, sm_scale, num_pages,
                 pages_per_chunk, precision="fast", sliding_window=None, read_threshold=None,
                 read_seed=0, interpolate=False, collect_stats=False,
                 return_softmax_state=False):
    """K4's function in plain PyTorch: ``_read`` without a write (codec
    "int4" reads the data words alone: int4 and the scrub-extract read).
    Returns the output in the query's dtype, or with
    ``return_softmax_state`` (acc [B, Hq, D], m [B, Hq], l [B, Hq]) float32
    unnormalised; then stats [B, 2] int32 after either with
    ``collect_stats``."""
    (acc, m, l), stats = _read(
        query, k_cache, v_cache, k_scales, v_scales, block_table, context_lens, layer_idx,
        k_parity, v_parity, codec=codec, sm_scale=sm_scale, num_pages=num_pages,
        pages_per_chunk=pages_per_chunk, precision=precision, sliding_window=sliding_window,
        read_threshold=read_threshold, read_seed=read_seed, interpolate=interpolate,
        collect_stats=collect_stats)
    out = (acc, m, l) if return_softmax_state else _normalise(acc, l, query.dtype)
    return (out, stats) if collect_stats else out


def _check(name, problems):
    bad = [msg for ok, msg in problems if not ok]
    if bad:
        raise ValueError(f"{name}: {'; '.join(bad)}")


def _common_problems(query, new, scales_new, caches, scales, block_table, context_lens,
                     layer_idx):
    """What both kernels check: devices, contiguity, dtypes, shapes (``new``
    and ``scales_new`` are empty for a read without a write)."""
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
        (not new or (new[0].shape == new[1].shape and new[0].shape[:2] == (batch, Hkv)
                     and all(s.shape == (batch, Hkv) for s in scales_new)),
         "new column or new scale shapes"),
        (block_table.dim() == 2 and block_table.shape[0] == batch and context_lens.shape == (batch,),
         "block table or context length shapes"),
        (0 <= layer_idx < L, "layer out of range"),
    ]


def _stream(query):
    return torch.cuda.current_stream(query.device).cuda_stream


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


@functools.lru_cache(maxsize=None)
def _launcher(name: str, signature: str, symbol=None):
    """The C launcher ``symbol`` (default ``<name>_launch``) of
    csrc/<name>.cu, built and loaded at first use; ``signature`` spells its
    arguments, p for a pointer (the stream last), i for an int, f for a
    float. Returns a cudaError_t."""
    fn = getattr(load(name), symbol or f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[c] for c in signature]
    return fn


def _i32(x: int) -> int:
    """An unsigned 32-bit value as the C int with the same bits."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


def _kernel_query(query, precision):
    """The query as the kernels read it: bf16 for "fast", fp32 for
    "highest"."""
    dtype = torch.float32 if precision == "highest" else torch.bfloat16
    return query if query.dtype == dtype else query.to(dtype)


def _seed_args(seed):
    """(device pointer or None, value): a tensor seed is read by the kernel
    on the device, so drawing it costs the host no sync."""
    if torch.is_tensor(seed) and seed.device.type == "cuda":
        return seed.to(torch.int32).reshape(()).contiguous(), 0
    return None, _i32(int(seed))


def _outputs(query, collect_stats, return_softmax_state):
    """The kernels' outputs: out (fp32 holding acc with the softmax state,
    else the query's dtype), stats, m and l (or None)."""
    batch, num_q_heads = query.shape[:2]
    dev = query.device
    out = torch.empty(query.shape, device=dev,
                      dtype=torch.float32 if return_softmax_state else query.dtype)
    stats = torch.zeros((batch, 2), dtype=torch.int32, device=dev) if collect_stats else None
    m = l = None
    if return_softmax_state:
        m = torch.empty((batch, num_q_heads), dtype=torch.float32, device=dev)
        l = torch.empty((batch, num_q_heads), dtype=torch.float32, device=dev)
    return out, stats, m, l


def _returns(out, stats, m, l):
    res = out if m is None else (out, m, l)
    return res if stats is None else (res, stats)


def _count(wrapper, branch):
    wrapper.launches += 1
    wrapper.launches_by[branch] += 1


def _launch(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
            v_scales, block_table, context_lens, layer_idx, *, sm_scale, num_pages,
            precision, sliding_window, read_threshold=None, read_seed=0, pages_per_chunk,
            collect_stats, return_softmax_state=False, counter=None, codec="int4"):
    """Check what csrc/write_attend.cu takes, allocate the outputs and
    launch it on the current stream; ``k_new`` None reads without writing.
    The launch counts on ``counter`` (default:
    paged_attention_ecc_write_attend). Codec "fp16" or "fp8" launches its
    float_attend (``_launch_float``)."""
    if codec in _FLOAT:
        return _launch_float(query, k_new, v_new, k_cache, v_cache, block_table, context_lens,
                             layer_idx, codec=codec, sm_scale=sm_scale, num_pages=num_pages,
                             precision=precision, sliding_window=sliding_window,
                             pages_per_chunk=pages_per_chunk, collect_stats=collect_stats,
                             return_softmax_state=return_softmax_state, counter=counter)
    batch, num_q_heads, head_dim = query.shape
    L, NB, Hkv, Wd, bs = k_cache.shape
    group = num_q_heads // Hkv
    new = () if k_new is None else (k_new, v_new)
    _check("write_attend", _common_problems(
        query, new, () if k_new is None else (ks_new, vs_new), (k_cache, v_cache),
        (k_scales, v_scales), block_table, context_lens, layer_idx) + [
        (not new or k_new.shape[2] == Wd, "new column width"),
        (group * Hkv == num_q_heads and (Wd, group, head_dim) in KERNEL_SHAPES,
         f"(data words, GQA group, head_dim) = {(Wd, group, head_dim)} has no kernel "
         f"instance; built: {KERNEL_SHAPES}"),
    ])
    q = _kernel_query(query, precision)
    out, stats, m, l = _outputs(query, collect_stats, return_softmax_state)
    seed_t, seed_v = _seed_args(read_seed)
    ptrs = (q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, v_scales,
            block_table, context_lens, out, stats, seed_t, m, l)
    rc = _launcher("write_attend", "p" * 16 + "i" * 10 + "f" + "i" * 9 + "p")(
        *(0 if t is None else t.data_ptr() for t in ptrs), batch, Hkv, group, Wd, head_dim,
        bs, NB, block_table.shape[1], num_pages, int(layer_idx), float(sm_scale),
        int(sliding_window or 0), int(out.dtype == torch.bfloat16),
        int(precision == "highest"), int(read_threshold is not None),
        _i32(read_threshold or 0), seed_v, C.cdiv(num_pages, pages_per_chunk),
        pages_per_chunk, int(bool(new)), _stream(query))
    if rc != 0:
        raise RuntimeError(f"write_attend kernel launch failed: cudaError {rc}")
    _count(counter or paged_attention_ecc_write_attend,
           "read" if read_threshold is None else "read-inject")
    return _returns(out, stats, m, l)


def _launch_float(query, k_new, v_new, k_cache, v_cache, block_table, context_lens,
                  layer_idx, *, codec, sm_scale, num_pages, precision, sliding_window,
                  pages_per_chunk, collect_stats, return_softmax_state, counter):
    """Check what csrc/write_attend.cu's float_attend takes (K2f), allocate
    the outputs and launch it on the current stream; ``k_new`` None reads
    without writing. The stats of ``collect_stats`` stay zero. The launch
    counts on ``counter`` (default: paged_attention_ecc_write_attend) under
    the codec's name."""
    batch, num_q_heads, head_dim = query.shape
    L, NB, Hkv, D, bs = k_cache.shape
    group = num_q_heads // Hkv
    new = () if k_new is None else (k_new, v_new)
    dtype = C.FLOAT_STORAGE_DTYPES[codec]
    ints = (block_table, context_lens)
    _check("float_attend", [
        (all(t.device == query.device and t.is_contiguous()
             for t in (query, k_cache, v_cache, *new, *ints)),
         "every tensor must be contiguous and on the query's device"),
        (all(t.dtype == dtype for t in (k_cache, v_cache, *new)),
         f"{codec} caches and new columns must be {dtype}"),
        (all(t.dtype == torch.int32 for t in ints), "block table and lengths must be int32"),
        (query.dtype in (torch.bfloat16, torch.float32), "query must be bf16 or float32"),
        (v_cache.shape == k_cache.shape and D == head_dim, "cache shapes"),
        (not new or new[0].shape == new[1].shape == (batch, Hkv, D), "new column shapes"),
        (block_table.dim() == 2 and block_table.shape[0] == batch and context_lens.shape == (batch,),
         "block table or context length shapes"),
        (0 <= layer_idx < L, "layer out of range"),
        (pages_per_chunk >= 1, "pages_per_chunk must be positive"),
        (group * Hkv == num_q_heads and (group, head_dim) in FLOAT_KERNEL_SHAPES,
         f"(GQA group, head_dim) = {(group, head_dim)} has no kernel instance; built: "
         f"{FLOAT_KERNEL_SHAPES}"),
    ])
    q = _kernel_query(query, precision)
    out, stats, m, l = _outputs(query, collect_stats, return_softmax_state)
    ptrs = (q, k_new, v_new, k_cache, v_cache, block_table, context_lens, out, m, l)
    rc = _launcher("write_attend", "p" * 10 + "i" * 10 + "f" + "i" * 6 + "p",
                   symbol="float_attend_launch")(
        *(0 if t is None else t.data_ptr() for t in ptrs), batch, Hkv, group, head_dim,
        int(codec == "fp8"), bs, NB, block_table.shape[1], num_pages, int(layer_idx),
        float(sm_scale), int(sliding_window or 0), int(out.dtype == torch.bfloat16),
        int(precision == "highest"), C.cdiv(num_pages, pages_per_chunk), pages_per_chunk,
        int(bool(new)), _stream(query))
    if rc != 0:
        raise RuntimeError(f"float_attend kernel launch failed: cudaError {rc}")
    _count(counter or paged_attention_ecc_write_attend, codec)
    return _returns(out, stats, m, l)


def write_attend(*args, **kw):
    """K1 (and K2r, and K2f with codec "fp16" / "fp8"): on the card
    csrc/write_attend.cu (or raise), on the CPU write_attend_plain.
    Arguments as write_attend_plain."""
    query = args[0]
    if query.device.type == "cuda":
        return _launch(*args, **kw)
    if query.device.type == "cpu":
        return write_attend_plain(*args, **kw)
    raise ValueError(f"write_attend: no kernel for device {query.device}")


def _launch_decode(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                   v_scales, block_table, context_lens, layer_idx, k_parity, v_parity, *,
                   codec, sm_scale, pages_per_chunk, interpolate, num_pages, precision,
                   sliding_window, collect_stats, return_softmax_state=False, counter=None):
    """Check what csrc/decode_attend.cu takes, allocate the outputs and
    launch it on the current stream; ``k_new`` None reads without writing.
    The launch counts on ``counter`` (default: write_decode_attend)."""
    batch, num_q_heads, head_dim = query.shape
    L, NB, Hkv, Wd, bs = k_cache.shape
    Pw = k_parity.shape[3]
    group = num_q_heads // Hkv
    shape = (codec, Wd, Pw, group, head_dim)
    new = () if k_new is None else (k_new, v_new)
    _check("decode_attend", _common_problems(
        query, new, () if k_new is None else (ks_new, vs_new),
        (k_cache, v_cache, k_parity, v_parity), (k_scales, v_scales), block_table,
        context_lens, layer_idx) + [
        (v_parity.shape[3] == Pw and (not new or k_new.shape[2] == Wd + Pw),
         "new rows hold the data and parity words"),
        (group * Hkv == num_q_heads and shape in DECODE_KERNEL_SHAPES,
         f"(codec, data words, parity words, GQA group, head_dim) = {shape} has no kernel "
         f"instance; built: {DECODE_KERNEL_SHAPES}"),
        (pages_per_chunk >= 1, "pages_per_chunk must be positive"),
    ])
    q = _kernel_query(query, precision)
    out, stats, m, l = _outputs(query, collect_stats, return_softmax_state)
    ptrs = (q, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_parity, v_parity,
            k_scales, v_scales, block_table, context_lens, out, stats, m, l)
    interp = bool(interpolate and codec == "hamming84")
    rc = _launcher("decode_attend", "p" * 17 + "i" * 13 + "f" + "i" * 6 + "p")(
        *(0 if t is None else t.data_ptr() for t in ptrs), batch, Hkv, group,
        _CODEC_IDS[codec], Wd, Pw, head_dim, bs, NB, block_table.shape[1], num_pages,
        int(layer_idx), int(sliding_window or 0), float(sm_scale),
        int(out.dtype == torch.bfloat16), int(precision == "highest"),
        int(pages_per_chunk * bs), int(interp), int(collect_stats), int(bool(new)),
        _stream(query))
    if rc != 0:
        raise RuntimeError(f"decode_attend kernel launch failed: cudaError {rc}")
    _count(counter or write_decode_attend, codec + ("-interp" if interp else ""))
    return _returns(out, stats, m, l)


def write_decode_attend(*args, **kw):
    """The correcting read of the parity codecs: on the card
    csrc/decode_attend.cu (or raise), on the CPU write_decode_attend_plain.
    Arguments as write_decode_attend_plain."""
    query = args[0]
    if query.device.type == "cuda":
        return _launch_decode(*args, **kw)
    if query.device.type == "cpu":
        return write_decode_attend_plain(*args, **kw)
    raise ValueError(f"decode_attend: no kernel for device {query.device}")


write_decode_attend.launches = 0
# launches by branch: the codec, hamming84 with interpolation apart
write_decode_attend.launches_by = dict.fromkeys(
    ("hamming84", "hamming84-interp", "hamming74", "golay"), 0)


def _check_scrub_flags(scrub, codec, use_interpolation, collect_stats, read_inject_ber):
    """The TPU wrapper's refusals of a scrubbed read: it streams the data
    words alone, so whatever must see parity or raw-bit corruption needs
    scrub off."""
    if not scrub:
        return
    if codec not in _PACKED:
        raise ValueError(f"scrub requires a packed-int codec, got '{codec}'")
    if use_interpolation:
        raise ValueError("scrub + interpolation is unsupported: scrubbing re-encodes "
                         "double-error data as valid codewords, which would erase the "
                         "doubles mask interpolation keys on")
    if collect_stats:
        raise ValueError("collect_stats counts corrections per READ; disable scrub to "
                         "collect them")
    if read_inject_ber:
        raise ValueError("read-time injection corrupts raw packed bits per attend; the "
                         "scrub fast path would not decode them - disable scrub")


def _read_threshold(read_inject_ber: float, codec: str):
    """Unsigned 32-bit Bernoulli threshold of read-time injection, or None."""
    if not read_inject_ber or read_inject_ber <= 0:
        return None
    if codec != "int4":
        raise ValueError("read-time injection is only defined for the unprotected int4 arm")
    return min(int(float(read_inject_ber) * (2.0 ** 32)), 0xFFFFFFFF)


def _common_setup(query, k_cache, block_table, codec, block_size, num_pages, sm_scale,
                  pages_per_chunk, precision):
    """What both wrappers resolve first (the JAX wrapper's ``_common_setup``):
    (num_pages, sm_scale, pages per chunk capped at num_pages, data words -
    values per row for fp16 / fp8), raising on an unknown codec, block
    size, precision, num_pages or a cache whose rows do not fit head_dim."""
    if codec not in _PACKED + _FLOAT:
        swar.unsupported(codec)
    head_dim = query.shape[-1]
    bs = k_cache.shape[4]
    if bs != block_size:
        raise ValueError(f"block_size {block_size} != the cache's {bs}")
    if precision not in ("fast", "highest"):
        raise ValueError(f"precision must be 'fast' or 'highest', got '{precision}'")
    num_pages = block_table.shape[1] if num_pages is None else int(num_pages)
    if not 1 <= num_pages <= block_table.shape[1]:
        raise ValueError(f"num_pages {num_pages} outside [1, {block_table.shape[1]}]")
    sm_scale = float(head_dim) ** -0.5 if sm_scale is None else sm_scale
    if pages_per_chunk is None:  # the TPU kernel's chunk: 512 tokens of pages
        pages_per_chunk = max(1, 512 // bs)
    dw = swar.data_words(codec, head_dim)
    if k_cache.shape[3] != dw:
        raise ValueError(f"cache has {k_cache.shape[3]} data words, "
                         f"{codec} at head_dim {head_dim} has {dw}")
    if codec in _FLOAT and k_cache.dtype != C.FLOAT_STORAGE_DTYPES[codec]:
        raise ValueError(f"a {codec} cache is {C.FLOAT_STORAGE_DTYPES[codec]}, got {k_cache.dtype}")
    return num_pages, sm_scale, min(pages_per_chunk, num_pages), dw


def paged_attention_ecc_write_attend(query, k_new, v_new, ks_new, vs_new,
                                     k_cache, v_cache, k_scales, v_scales,
                                     block_table, context_lens, layer_idx,
                                     k_parity=None, v_parity=None, *,
                                     scrub: bool = False, codec: str = "hamming84",
                                     block_size: int = 128, num_pages=None,
                                     sm_scale=None, pages_per_chunk=None,
                                     precision: str = "fast",
                                     use_interpolation: bool = False,
                                     collect_stats: bool = False,
                                     read_inject_ber: float = 0.0, read_inject_seed=0,
                                     sliding_window=None):
    """Write the new token's packed column and scales at slot ctx-1 (in
    place), then attend over the pages of the table that the kernel visits
    (``num_pages`` rounded up to whole chunks, F4). The float codecs write
    their raw values and no scales (module docstring). Returns the attention
    output [B, Hq, D] in query's dtype, or (output, stats [B, 2] int32) with
    ``collect_stats``. Signature, defaults and errors are the JAX
    function's; the caches are updated in place instead of returned.

    query [B, Hq, D] (bf16 or fp32); ks_new/vs_new [B, Hkv] fp32; caches
    [L, NB, Hkv, data_words, block_size] int32; scales [L, NB, Hkv, bs] fp32;
    block_table [B, P] int32 (an entry of -1 reads and writes page 0, as on
    the TPU); context_lens [B] int32 including the new token.

    scrub=True: the scrub-extract read of a write-scrubbed cache (kernel
    K1). k_new/v_new are the data words [B, Hkv, data_words]; parity is
    not an operand (the caller stores the new parity column).

    scrub=False: the correcting read. hamming84 (with ``use_interpolation``,
    kernel K3), hamming74 and golay stream k_parity/v_parity [L, NB, Hkv,
    parity_words, bs]; k_new/v_new are full rows (data ++ parity) and both
    columns are written (kernel K2). int4 has no parity: its read is K1's,
    and ``read_inject_ber`` > 0 flips the raw words read at every call with
    ``swar.hash_flip_mask`` from ``read_inject_seed`` (an int, or an int32
    tensor on the query's device, read there without a host sync; kernel
    K2r) - the cache keeps its clean words. ``collect_stats`` counts per
    sequence over the valid tokens (the new one included): corrected and
    detected errors of the parity codecs, the flipped read bits in slot 0
    for read injection. ``pages_per_chunk`` (default: 512 tokens of pages,
    capped at num_pages) sets where the interpolation's chunk seams fall and
    the read flips' counters, as on the TPU. ``precision`` "fast" rounds q
    and p * v_scale to bf16, "highest" keeps them in fp32.

    codec "fp16" / "fp8" (kernel K2f): caches [L, NB, Hkv, head_dim, bs]
    of bfloat16 / e4m3; k_new/v_new [B, Hkv, head_dim] (converted to the
    cache's type as JAX's astype converts, when they are not of it);
    ks_new/vs_new and the scales arrays are not touched; stats, when
    collected, are zeros."""
    num_pages, sm_scale, cp, dw = _common_setup(query, k_cache, block_table, codec, block_size,
                                                num_pages, sm_scale, pages_per_chunk, precision)
    head_dim = query.shape[-1]
    _check_scrub_flags(scrub, codec, use_interpolation, collect_stats, read_inject_ber)
    extract = scrub and swar.scrub_extract_ok(codec, head_dim)
    if extract and (k_parity is not None or v_parity is not None):
        raise ValueError("scrub-extract write_attend must not receive the parity arrays: "
                         "the caller stores the new parity column")
    threshold = _read_threshold(read_inject_ber, codec)
    common = dict(sm_scale=sm_scale, num_pages=num_pages, precision=precision,
                  sliding_window=sliding_window, collect_stats=collect_stats)
    if codec in _FLOAT:  # K2f: parity arrays, when given, are not read (as in JAX)
        if k_new.shape[-1] != dw:
            raise ValueError(f"k_new last dim {k_new.shape[-1]} != expected {dw} (values)")
        kn, vn = (x if x.dtype == k_cache.dtype else C.to_float_storage(codec, x)
                  for x in (k_new, v_new))
        return write_attend(query, kn, vn, ks_new, vs_new, k_cache, v_cache, k_scales,
                            v_scales, block_table, context_lens, layer_idx, codec=codec,
                            pages_per_chunk=cp, **common)
    args = (query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales, v_scales,
            block_table, context_lens, layer_idx)
    if extract or codec == "int4":
        if k_new.shape[-1] != dw:
            raise ValueError(f"k_new last dim {k_new.shape[-1]} != expected {dw} "
                             "(data words)")
        return write_attend(*args, read_threshold=threshold, read_seed=read_inject_seed,
                            pages_per_chunk=cp, **common)
    if k_parity is None or v_parity is None:
        raise ValueError(f"codec '{codec}' needs k_parity/v_parity operands for correcting "
                         "reads (split cache layout); only the scrub extract path runs "
                         "without them")
    pw = k_parity.shape[3]
    if k_new.shape[-1] != dw + pw:
        raise ValueError(f"k_new last dim {k_new.shape[-1]} != expected {dw + pw} "
                         "(data ++ parity rows)")
    return write_decode_attend(*args, k_parity, v_parity, codec=codec, pages_per_chunk=cp,
                               interpolate=use_interpolation, **common)


paged_attention_ecc_write_attend.launches = 0  # csrc/write_attend.cu
# its launches by branch: the reads of clean words (the scrub extract, int4
# without injection), mode int4's read-time injection and the float codecs
paged_attention_ecc_write_attend.launches_by = dict.fromkeys(
    ("read", "read-inject", "fp16", "fp8"), 0)


def paged_attention_ecc(query, k_cache, v_cache, k_scales, v_scales, block_table,
                        context_lens, layer_idx, k_parity=None, v_parity=None, *,
                        codec: str = "hamming84", block_size: int = 128, num_pages=None,
                        sm_scale=None, pages_per_chunk=None, precision: str = "fast",
                        use_interpolation: bool = False, collect_stats: bool = False,
                        read_inject_ber: float = 0.0, read_inject_seed=0,
                        sliding_window=None, return_softmax_state: bool = False,
                        scrub: bool = False):
    """K4: the decode-phase paged attention over the cache as it stands (no
    write). Arguments, defaults, returns and errors are the JAX function's
    (``qkv_ecc_tpu/kernels/paged_attention.py:828``): query [B, Hq, D] (one
    decode token per sequence) attends tokens [0, context_lens) - the query
    position is ctx - 1, so ``sliding_window`` keeps the last that many -
    of the pages the kernel visits (``num_pages``, default the table's
    width, rounded up to whole chunks of ``pages_per_chunk``; F4).

    Reads as the write+attend wrapper's: scrub=True takes the data words
    alone (the extract read; parity arrays, when given, are not read);
    scrub=False decodes full rows of hamming84 (``use_interpolation``),
    hamming74 and golay from k_parity/v_parity, and reads int4 with
    ``read_inject_ber`` flips from ``read_inject_seed``.

    Returns the output [B, Hq, D] in the query's dtype; with
    ``return_softmax_state`` (acc [B, Hq, D], m [B, Hq], l [B, Hq]) float32,
    the unnormalised online-softmax state (an empty row: 0, -1e30, 0); with
    ``collect_stats`` (that, stats [B, 2] int32). On the card it launches
    csrc/write_attend.cu or csrc/decode_attend.cu without a new column (or
    raises); on the CPU it runs ``attend_plain``. Launches count in
    ``paged_attention_ecc.launches`` and ``.launches_by`` per branch. The
    float codecs fp16 and fp8 read their raw values through float_attend
    (K2f's read; their stats are zeros)."""
    num_pages, sm_scale, cp, dw = _common_setup(query, k_cache, block_table, codec, block_size,
                                                num_pages, sm_scale, pages_per_chunk, precision)
    head_dim = query.shape[-1]
    _check_scrub_flags(scrub, codec, use_interpolation, collect_stats, read_inject_ber)
    threshold = _read_threshold(read_inject_ber, codec)
    extract = codec in ("int4",) + _FLOAT or (scrub and swar.scrub_extract_ok(codec, head_dim))
    if not extract and (k_parity is None or v_parity is None):
        raise ValueError(f"codec '{codec}' needs k_parity/v_parity operands for correcting "
                         "reads (split cache layout); only the scrub extract path runs "
                         "without them")
    args = (query, k_cache, v_cache, k_scales, v_scales, block_table, context_lens, layer_idx)
    common = dict(sm_scale=sm_scale, num_pages=num_pages, pages_per_chunk=cp,
                  precision=precision, sliding_window=sliding_window,
                  collect_stats=collect_stats, return_softmax_state=return_softmax_state)
    parity = () if extract else (k_parity, v_parity)
    read_codec = codec if codec in _FLOAT else "int4" if extract else codec
    if query.device.type == "cpu":
        return attend_plain(*args, *parity, codec=read_codec, read_threshold=threshold,
                            read_seed=read_inject_seed, interpolate=use_interpolation, **common)
    if query.device.type != "cuda":
        raise ValueError(f"paged_attention_ecc: no kernel for device {query.device}")
    none = (None,) * 4  # no new column, no new scales
    if extract:
        return _launch(query, *none, *args[1:], read_threshold=threshold,
                       read_seed=read_inject_seed, counter=paged_attention_ecc,
                       codec=read_codec, **common)
    return _launch_decode(query, *none, *args[1:], *parity, codec=codec,
                          interpolate=use_interpolation, counter=paged_attention_ecc, **common)


paged_attention_ecc.launches = 0  # K4, any kernel
# its launches by branch: write_attend.cu's clean read (the extract, int4),
# read-inject and float reads; decode_attend.cu's codecs, hamming84 with
# interpolation apart
paged_attention_ecc.launches_by = dict.fromkeys(
    ("read", "read-inject", "hamming84", "hamming84-interp", "hamming74", "golay", "fp16", "fp8"),
    0)
