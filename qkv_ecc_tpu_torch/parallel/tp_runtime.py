"""Tensor- and data-parallel generation over the paged ECC cache
(counterpart of ``qkv_ecc_tpu/parallel/tp_runtime.py``), one process per
rank of a (data, model) mesh (parallel/mesh.py).

The step is the runtime's own (models/runtime.py prefill and decode_step,
given the rank's mesh). Per layer of a decode step (Megatron tensor
parallelism):

    x (whole on every model rank; the batch split over data ranks)
      -> column-sharded q/k/v (the rank's heads; no collective)
      -> RoPE, the write chain, and the fused write+attend kernel on the
         rank's own cache shard (its KV heads): the port's
         paged_attention_ecc_write_attend, K1 / K2 / K2r / K3 / K2f
      -> row-sharded o_proj -> all_reduce over the model group
      -> column-sharded gate/up -> row-sharded down -> all_reduce

so two sums a layer cross the model group (gpt2's c_proj and mlp_proj
biases added once after them); the untied LM head is vocab-sharded and
gathered. gpt2's packed c_attn is permuted head-blockwise at shard time
(sharding.permute_gpt2_qkv).

Masks: every rank draws the single-device run's mask stream at its full
[B_global, S, Hkv_full, ...] shape from its own generator (seeded alike on
every rank) and keeps its (data rows, KV heads) slice, so the sharded
caches and ECC counts are those of the port's single-device run
(models/runtime.py) on the same draws. Mode int4's read flips hash the
rank's local head index, as JAX's do, and differ from the single-device
run's.
"""

from __future__ import annotations

import torch

from ..models import runtime
from ..models.config import ModelConfig, refuse_latent
from ..models.kv_policy import KVCachePolicy
from ..models.runtime import _check_slice, _local_cfg, init_generation_state
from .mesh import Mesh, all_gather_cat
from .sharding import shard_params


def make_tp_functions(cfg: ModelConfig, policy: KVCachePolicy, mesh: Mesh,
                      block_size: int = 128, collect_ecc_stats: bool = False):
    """(init_state, prefill, decode_step) of this rank, closed over the
    mesh (JAX's, one process per rank in place of shard_map): the
    runtime's prefill and decode_step with ``mesh``.

      * init_state(batch, max_tokens) -> (state, block_table): the cache of
        the rank's KV heads over every page of the global batch
        (num_blocks = batch x pages, sequence b owning pages [b P, (b+1)
        P)), and the rows of the rank's data index of the sequential block
        table;
      * prefill(params, ids, state, block_table, generator, logit_pos,
        true_len, *, read_masks=None, batch_split=True) -> (logits, state)
        on the rank's rows [B_local, S] (its shards of the parameters,
        shard_params); with batch_split=False every data index prefills
        the same rows (the TP server's admission);
      * decode_step(params, tokens, state, block_table, generator=None, *,
        hoisted_masks=None, read_inject_seed=None) -> (logits, state).

    The masks and read seeds come from ``generator`` (seeded alike on every
    rank) at the full shape, or are given at it: ``read_masks`` [L, 2,
    B_global, S, Hkv, D'] and ``hoisted_masks`` [L, 2, B_global, 1, Hkv,
    D'] as models/runtime takes them. Logits are [B_local, V] float32.
    collect_ecc_stats: as the runtime's decode_step, the counts summed over
    the model group."""
    refuse_latent(cfg, "tensor parallelism")
    _check_slice(cfg, policy)  # NotImplementedError for an unknown architecture
    cfgl = _local_cfg(cfg, mesh.model)

    def init_state(batch: int, max_tokens: int):
        if batch % mesh.data:
            raise ValueError(f"batch {batch} does not split over {mesh.data} data ranks")
        state, bt, _ = init_generation_state(cfgl, policy, batch, max_tokens, block_size,
                                             device=mesh.device)
        b = batch // mesh.data
        rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
        state["context_len"] = state["context_len"][rows].contiguous()
        return state, bt[rows].contiguous()

    def prefill(params, input_ids, state, block_table, generator=None, logit_pos=None,
                true_len=None, *, read_masks=None, batch_split=True):
        return runtime.prefill(params, input_ids, state, block_table, cfg, policy, generator,
                               logit_pos, true_len, read_masks=read_masks, mesh=mesh,
                               batch_split=batch_split)

    def decode_step(params, token_ids, state, block_table, generator=None, *,
                    hoisted_masks=None, read_inject_seed=None):
        return runtime.decode_step(params, token_ids, state, block_table, cfg, policy,
                                   generator, block_size, collect_ecc_stats,
                                   hoisted_masks=hoisted_masks,
                                   read_inject_seed=read_inject_seed, mesh=mesh)

    return init_state, prefill, decode_step


def local_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rows of a global batch that this rank's data index holds."""
    b = x.shape[0] // mesh.data
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every data index's rows (on every rank)."""
    return all_gather_cat(x, mesh.data_group, dim=0)


@torch.no_grad()
def generate_tp(params, input_ids, cfg: ModelConfig, policy: KVCachePolicy, mesh: Mesh,
                max_new_tokens: int = 16, block_size: int = 128):
    """Greedy generation on the mesh: ``params`` whole (sharded here),
    ``input_ids`` the global [B, S] batch; masks from a generator seeded
    with policy.seed on the rank's device (the single-device generate's
    stream). Every rank returns the global [B, S + max_new_tokens] tokens,
    the new ones kept on the device between steps and gathered once over
    the data group at the end."""
    refuse_latent(cfg, "tensor parallelism")
    device = mesh.device
    params = shard_params(params, cfg, mesh)
    input_ids = torch.as_tensor(input_ids).to(device=device, dtype=torch.long)
    B, S = input_ids.shape
    init_state, prefill, decode_step = make_tp_functions(cfg, policy, mesh, block_size)
    state, bt = init_state(B, S + max_new_tokens)
    generator = torch.Generator(device=device).manual_seed(policy.seed)
    logits, state = prefill(params, local_rows(input_ids, mesh), state, bt, generator)
    toks = []
    for step in range(max_new_tokens):
        toks.append(torch.argmax(logits, dim=-1))
        if step == max_new_tokens - 1:
            break
        logits, state = decode_step(params, toks[-1], state, bt, generator)
    return torch.cat([input_ids, gather_rows(torch.stack(toks, dim=1), mesh)], dim=1)
