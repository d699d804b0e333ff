"""Tensor-parallel continuous-batching servers (counterpart of
``qkv_ecc_tpu/serving/tp_server.py``).

Every rank of a (data, model) mesh (parallel/mesh.py) runs the same server
loop: the same requests, the same scheduler decisions, the same block
manager. The cache holds the rank's KV heads (the model axis) over every
page; the batch slots are split over the data axis. Per decode step each
rank runs parallel/tp_runtime's step on its slots' rows (two all_reduces a
layer over its model group, the attention kernels on its own heads) and
samples its rows; one gather of the token vector over the data group gives
every rank the whole step's tokens, which keeps the bookkeeping identical
everywhere.

Admission prefills the admitted sequence on every rank (each data index
holds the pages of every slot, so that any slot can decode from its own
copy), with the single-device server's masks for that sequence: the
sharded caches and ECC counts are then those of the single-device server on
the same draws, at any mesh shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.kv_policy import KVCachePolicy
from ..models.runtime import sample_tokens
from ..parallel.mesh import Mesh, all_reduce
from ..parallel.sharding import shard_params
from ..parallel.tp_runtime import gather_rows, make_tp_functions
from .scheduler import ContinuousBatchingServer


class TPContinuousBatchingServer(ContinuousBatchingServer):
    """Continuous batching on this rank of ``mesh``: llama or gpt2, heads
    dividing over the model axis, max_batch over the data axis. Keyword
    arguments are ContinuousBatchingServer's; the device is the mesh's."""

    def __init__(self, params, cfg: ModelConfig, policy: KVCachePolicy, mesh: Mesh, **kw):
        self.mesh = mesh
        self.dp, self.tp = mesh.data, mesh.model
        kw["device"] = mesh.device
        super().__init__(params, cfg, policy, **kw)
        if self.max_batch % self.dp:
            raise ValueError(f"max_batch {self.max_batch} must be divisible by the data-axis "
                             f"size {self.dp}")
        self._tp_params = shard_params(params, cfg, mesh)
        self.params = None  # the rank decodes from its shards alone
        _, self._tp_prefill, self._tp_decode = make_tp_functions(
            cfg, policy, mesh, block_size=self.block_size,
            collect_ecc_stats=self.collect_ecc_stats)
        b = self.max_batch // self.dp
        self._rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)

    def _cache_kv_heads(self) -> int:
        return self.cfg.num_kv_heads // self.mesh.model

    def _run_prefill(self, ids, row, logit_pos, true_len):
        self.state["context_len"] = torch.zeros((ids.shape[0],), dtype=torch.int32,
                                                device=self.device)
        logits, self.state = self._tp_prefill(self._tp_params, ids, self.state, row, self._gen,
                                              logit_pos, true_len, batch_split=False)
        return logits

    def _run_decode(self, tokens, block_table):
        """The rank's rows' logits [max_batch / data, V]."""
        r = self._rows
        self.state["context_len"] = torch.from_numpy(self._context_lens()[r]).to(self.device)
        self.state.pop("ecc_corrected", None)
        self.state.pop("ecc_detected", None)
        logits, self.state = self._tp_decode(self._tp_params, tokens[r], self.state,
                                             block_table[r].contiguous(), self._gen)
        self._harvest_ecc()
        return logits

    def _harvest_ecc(self):
        """The step's counts of every row: the rank's rows (already summed
        over the model group) summed over the data group."""
        if self.collect_ecc_stats:
            counts = torch.stack([self.state.pop("ecc_corrected").sum(),
                                  self.state.pop("ecc_detected").sum()])
            counts = all_reduce(counts, self.mesh.data_group).tolist()
            self._ecc_corrected += int(counts[0])
            self._ecc_detected += int(counts[1])

    def _decode_tokens(self, tokens, requests_by_row):
        """Decode the rank's rows, sample them (with their rows of the
        single-device server's uniforms), and gather the token vector over
        the data group."""
        logits = self._run_decode(torch.from_numpy(tokens).to(self.device), self._block_table())
        temps = np.zeros(self.max_batch, np.float32)
        for row, req in requests_by_row.items():
            temps[row] = req.temperature
        if (temps > 0).any():
            local = sample_tokens(logits, torch.from_numpy(temps[self._rows]), self._sample_gen,
                                  row_offset=self._rows.start, full_batch=self.max_batch)
        else:
            local = torch.argmax(logits, dim=-1)
        return gather_rows(local, self.mesh).cpu().numpy()


# Across hosts every rank is a process of its own already, as on one host
# (parallel/multihost.py lays the model axis within a host and the data axis
# across hosts), so the multi-host server is the TP server under JAX's name
MultihostTPContinuousBatchingServer = TPContinuousBatchingServer
