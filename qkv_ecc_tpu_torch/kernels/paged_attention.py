"""Fused decode-step cache write + paged attention (counterpart of
``qkv_ecc_tpu/kernels/paged_attention.py``: ``paged_attention_ecc_write_attend``
in scrub-extract mode, ``gather_pages``, ``gather_scales`` and
``paged_attention_ecc_reference``).

``paged_attention_ecc_write_attend`` launches the hand-written CUDA kernel
``csrc/write_attend.cu`` for tensors on the card and counts each launch in
its ``launches`` attribute. For tensors on the CPU it runs
``write_attend_plain``, the same function in plain PyTorch. The caches are
updated in place (the JAX version returns updated copies).
"""

from __future__ import annotations

import ctypes

import torch

from . import swar
from ._build import load

_NEG_INF = -1e30
# (data words per row, GQA group) pairs instantiated in csrc/write_attend.cu:
# those of the registered models, tiny-llama and bench-0.9b
KERNEL_SHAPES = ((2, 2), (16, 2))


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
    float32 (golay zeroes uncorrectable codewords)."""
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


def _write_column(k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                  v_scales, block_table, context_lens, layer_idx):
    """Store each sequence's new column and scales at slot ctx-1, in place;
    rows whose slot has no page (ctx 0, beyond the table, page -1) are
    skipped, as the kernel skips them."""
    bs = k_cache.shape[4]
    tok = context_lens.long() - 1
    pidx = tok.clamp(min=0) // bs
    inside = (tok >= 0) & (pidx < block_table.shape[1])
    phys = block_table.long().gather(1, pidx.clamp(max=block_table.shape[1] - 1)[:, None])[:, 0]
    rows = torch.nonzero(inside & (phys >= 0))[:, 0]
    phys, slot = phys[rows], tok[rows] % bs
    k_cache[layer_idx][phys, :, :, slot] = k_new[rows]
    v_cache[layer_idx][phys, :, :, slot] = v_new[rows]
    k_scales[layer_idx][phys, :, slot] = ks_new[rows].to(k_scales.dtype)
    v_scales[layer_idx][phys, :, slot] = vs_new[rows].to(v_scales.dtype)


def write_attend_plain(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache,
                       k_scales, v_scales, block_table, context_lens, layer_idx,
                       *, sm_scale, sliding_window=None):
    """The kernel's function in plain PyTorch: the in-place column write,
    then gather, unpack and dequantize, and a masked softmax taken online
    page by page with the kernel's precision (bf16 q, bf16 p * v_scale
    against the running maximum, fp32 sums)."""
    _write_column(k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
                  v_scales, block_table, context_lens, layer_idx)
    batch, num_q_heads, head_dim = query.shape
    num_kv_heads, bs = k_cache.shape[2], k_cache.shape[4]
    group = num_q_heads // num_kv_heads
    num_pages = block_table.shape[1]

    def nibbles(cache):
        rows = gather_pages(cache, block_table, layer_idx, num_pages)
        nib = swar.unpack_int4(rows)[..., :head_dim].to(torch.float32) - 8.0
        return nib.movedim(1, 2)  # [batch, kv_heads, tokens, D]

    kn, vn = nibbles(k_cache), nibbles(v_cache)
    ks = gather_scales(k_scales, block_table, layer_idx, num_pages).movedim(1, 2)
    vs = gather_scales(v_scales, block_table, layer_idx, num_pages).movedim(1, 2)
    q = query.to(torch.bfloat16).to(torch.float32).reshape(
        batch, num_kv_heads, group, head_dim)
    ctx = context_lens.long()[:, None]
    tokens = torch.arange(num_pages * bs, device=q.device)[None, :]
    live = tokens < ctx
    if sliding_window is not None:
        live = live & (tokens >= ctx - sliding_window)
    live = live[:, None, None, :]  # [batch, 1, 1, tokens]
    m = torch.full((batch, num_kv_heads, group, 1), _NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, num_kv_heads, group, head_dim), device=q.device)
    for pg in range(num_pages):
        t = slice(pg * bs, (pg + 1) * bs)
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


def _launch(query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
            v_scales, block_table, context_lens, layer_idx, sm_scale,
            sliding_window):
    """Check what the kernel takes, allocate the output and launch
    csrc/write_attend.cu on the current stream."""
    batch, num_q_heads, head_dim = query.shape
    L, NB, Hkv, Wd, bs = k_cache.shape
    group = num_q_heads // Hkv
    ints = (k_new, v_new, k_cache, v_cache, block_table, context_lens)
    floats = (ks_new, vs_new, k_scales, v_scales)
    problems = [msg for ok, msg in (
        (all(t.device == query.device and t.is_contiguous() for t in ints + floats),
         "every tensor must be contiguous and on the query's device"),
        (all(t.dtype == torch.int32 for t in ints), "words, block table and lengths must be int32"),
        (all(t.dtype == torch.float32 for t in floats), "scales must be float32"),
        (query.dtype in (torch.bfloat16, torch.float32), "query must be bf16 or float32"),
        (v_cache.shape == k_cache.shape and k_scales.shape == v_scales.shape == (L, NB, Hkv, bs),
         "cache or scale shapes"),
        (k_new.shape == v_new.shape == (batch, Hkv, Wd) and ks_new.shape == vs_new.shape == (batch, Hkv),
         "new column or new scale shapes"),
        (block_table.dim() == 2 and block_table.shape[0] == batch and context_lens.shape == (batch,),
         "block table or context length shapes"),
        (head_dim == 8 * Wd and group * Hkv == num_q_heads and (Wd, group) in KERNEL_SHAPES,
         f"(data words, GQA group) = {(Wd, group)} has no kernel instance; built: {KERNEL_SHAPES}"),
        (0 <= layer_idx < L, "layer out of range"),
    ) if not ok]
    if problems:
        raise ValueError(f"write_attend: {'; '.join(problems)}")

    q = query if query.dtype == torch.bfloat16 else query.to(torch.bfloat16)
    out = torch.empty(query.shape, dtype=query.dtype, device=query.device)
    fn = load("write_attend").write_attend_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), ks_new.data_ptr(),
            vs_new.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_scales.data_ptr(), v_scales.data_ptr(), block_table.data_ptr(),
            context_lens.data_ptr(), out.data_ptr(), batch, Hkv, group, Wd, bs,
            NB, block_table.shape[1], int(layer_idx), float(sm_scale),
            int(sliding_window or 0), int(query.dtype == torch.bfloat16),
            torch.cuda.current_stream(query.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"write_attend kernel launch failed: cudaError {rc}")
    paged_attention_ecc_write_attend.launches += 1
    return out


def paged_attention_ecc_write_attend(query, k_new, v_new, ks_new, vs_new,
                                     k_cache, v_cache, k_scales, v_scales,
                                     block_table, context_lens, layer_idx, *,
                                     codec: str, sm_scale=None,
                                     sliding_window=None):
    """Write the new token's packed data column and scales at slot ctx-1 (in
    place), then attend over the int4-packed data nibbles of the scrubbed
    cache.

    query [B, Hq, D] (bf16 or fp32); k_new/v_new [B, Hkv, data_words] int32;
    ks_new/vs_new [B, Hkv] fp32; caches [L, NB, Hkv, data_words, bs] int32;
    scales [L, NB, Hkv, bs] fp32; block_table [B, P] int32; context_lens [B]
    int32 including the new token. Returns the attention output [B, Hq, D]
    in query's dtype.

    On the card this launches csrc/write_attend.cu or raises; on the CPU it
    runs write_attend_plain."""
    head_dim = query.shape[-1]
    if codec not in ("int4", "golay"):
        swar.unsupported(codec)
    if not swar.scrub_extract_ok(codec, head_dim):
        raise NotImplementedError(
            f"golay at head_dim {head_dim} needs the correcting read (kernel K2)")
    if k_cache.shape[3] != swar.data_words(codec, head_dim):
        raise ValueError(f"cache has {k_cache.shape[3]} data words, "
                         f"{codec} at head_dim {head_dim} has {swar.data_words(codec, head_dim)}")
    sm_scale = float(head_dim) ** -0.5 if sm_scale is None else sm_scale
    args = (query, k_new, v_new, ks_new, vs_new, k_cache, v_cache, k_scales,
            v_scales, block_table, context_lens, layer_idx)
    if query.device.type == "cuda":
        return _launch(*args, sm_scale, sliding_window)
    if query.device.type == "cpu":
        return write_attend_plain(*args, sm_scale=sm_scale, sliding_window=sliding_window)
    raise ValueError(f"write_attend: no kernel for device {query.device}")


paged_attention_ecc_write_attend.launches = 0
