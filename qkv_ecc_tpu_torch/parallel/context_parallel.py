"""Context-parallel (sharded-KV) decode attention (counterpart of
``qkv_ecc_tpu/parallel/context_parallel.py``).

The paged cache's page axis is split over the ranks of a group: each rank
reads its own pages through the port's K4 (paged_attention_ecc with
return_softmax_state, any codec, the inline ECC decode on the rank), and
the ranks' online-softmax states merge with one all_reduce MAX and two
SUMs: flash-decoding across ranks. Only [batch, heads, head_dim] partials
cross the group. Composable with tensor parallelism: heads on the model
group, pages on another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.paged_attention import _normalise, merge_softmax_states, paged_attention_ecc
from .mesh import all_reduce


def merge_softmax_shards(acc, m, l, group):
    """The exact attention output from the group's unnormalised states.

    acc [b, Hq, D], m and l [b, Hq] of each rank (an empty shard: m -1e30,
    l 0, adding nothing): kernels/paged_attention.py merge_softmax_states
    with its split axis over the group (an all_reduce MAX, then two SUMs),
    normalised to acc / l, 0 where l is 0. float32."""
    acc, _, l = merge_softmax_states(
        acc, m, l, reduce_max=lambda t: all_reduce(t.clone(), group, "max"),
        reduce_sum=lambda t: all_reduce(t, group))
    return _normalise(acc, l, torch.float32)


def cp_paged_attention_ecc(query, k_cache, v_cache, k_scales, v_scales, block_table_local,
                           context_lens_local, layer_idx, k_parity=None, v_parity=None, *,
                           group=None, **kernel_kwargs):
    """Sharded-KV decode attention of one rank: its own cache shard (with
    the split parity shards for correcting reads), a block table of its
    own physical pages and the count of context tokens it holds; the query
    whole on every rank of ``group``. Codec, interpolation and window
    options go to the kernel. Returns [batch, Hq, head_dim] in the query's
    dtype."""
    acc, m, l = paged_attention_ecc(
        query, k_cache, v_cache, k_scales, v_scales, block_table_local, context_lens_local,
        layer_idx, k_parity, v_parity, return_softmax_state=True, **kernel_kwargs)
    return merge_softmax_shards(acc, m, l, group).to(query.dtype)


def shard_context(context_lens, num_shards: int, block_size: int):
    """Contiguous whole-page split of each sequence's context over the
    shards: [num_shards, batch] int32 local lengths, shard s holding tokens
    from s x ceil(pages / num_shards) pages on (a page never straddles
    shards, so local block tables stay dense)."""
    context_lens = np.asarray(context_lens)
    pages = -(-context_lens // block_size)
    per_shard_pages = -(-pages // num_shards)
    local = np.zeros((num_shards, len(context_lens)), np.int32)
    for b, ctx in enumerate(context_lens):
        remaining = int(ctx)
        for s in range(num_shards):
            take = min(remaining, int(per_shard_pages[b]) * block_size)
            local[s, b] = take
            remaining -= take
    return local


def make_cp_attention(mesh, axis_name: str = "context", with_parity: bool = False,
                      **kernel_kwargs):
    """Sharded-KV attention over the ranks of ``mesh``'s ``axis_name`` group
    ("context" or "data": the data group; "model": the model group). The
    returned fn(query, k, v, ks, vs, bt_sharded, ctx_sharded, layer[,
    k_parity, v_parity] with with_parity=True) takes this rank's cache
    shard and the per-shard block tables and context lengths with the
    shard axis leading ([shards, batch, ...], as JAX's in_specs split
    them), and returns the merged [batch, Hq, head_dim] on every rank."""
    if axis_name == "model":
        group, index = mesh.model_group, mesh.model_index
    else:
        group, index = mesh.data_group, mesh.data_index

    def fn(q, k, v, ks, vs, bt, cl, layer, *parity):
        if len(parity) != (2 if with_parity else 0):
            raise TypeError(f"expected {'k_parity, v_parity' if with_parity else 'no parity'}")
        return cp_paged_attention_ecc(q, k, v, ks, vs, bt[index], cl[index], layer, *parity,
                                      group=group, **kernel_kwargs)

    return fn
