"""Continuous-batching scheduler over the paged ECC KV cache (counterpart of
``qkv_ecc_tpu/serving/scheduler.py``).

  * A fixed number of batch slots. Each active slot owns pages of the
    shared paged cache through the host-side ``BlockManager``.
  * Admission prefills one sequence into the shared cache (the decoder
    waits meanwhile). Prompts are padded to ``prefill_bucket`` tokens;
    logits are taken at the true last prompt position and the context
    length excludes the pad tail, which decode overwrites before any read.
  * One decode step advances every slot: per layer, the new tokens' K/V are
    quantized, encoded and fault-injected, then written and attended by the
    fused write+attend kernel (``models/runtime.decode_step``).
  * An inactive slot's block-table row is -1 and its context 0: it decodes
    into physical block 0, the trash page reserved at construction (row 0
    of the manager), and never touches a live sequence's pages.
  * A finished sequence releases its pages at once; the next admission
    reuses them first in, first out.

Sampling: greedy rows take the argmax; a row with a temperature takes the
Gumbel-max of its scaled logits, drawn from a ``torch.Generator`` seeded
with ``policy.seed + 1`` (deterministic per seed; not the bits of
``jax.random.categorical``). The write masks of admissions and decode
steps, and the read seeds of the read-inject arm, come from the server's
generator, seeded with ``policy.seed``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..cache.block_manager import BlockManager
from ..cache.layout import ECCCacheConfig, allocate_ecc_kv_cache
from ..device import resolve_device
from ..models.config import ModelConfig, refuse_latent
from ..models.kv_policy import KVCachePolicy
from ..models.runtime import _check_slice, decode_step, prefill, sample_tokens


@dataclasses.dataclass
class Request:
    request_id: int
    prompt_ids: np.ndarray  # [S] int
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    temperature: float = 0.0  # 0 = greedy


@dataclasses.dataclass
class RequestOutput:
    request_id: int
    prompt_ids: np.ndarray
    token_ids: List[int]  # generated tokens (excluding the prompt)
    finish_reason: str = "length"  # "length" | "eos"


@dataclasses.dataclass
class _SlotState:
    request: Request
    context_len: int  # tokens written to the cache (prompt + generated)
    generated: List[int]
    next_token: int  # sampled but not yet written/decoded


class ContinuousBatchingServer:
    """Admit/decode/retire loop over a shared paged ECC cache on ``device``
    (None: the card)."""

    def __init__(self, params, cfg: ModelConfig, policy: KVCachePolicy, *, max_batch: int = 8,
                 max_seq_len: int = 2048, num_blocks: Optional[int] = None,
                 block_size: int = 128, prefill_bucket: int = 128,
                 collect_ecc_stats: bool = True, device=None):
        _check_slice(cfg, policy)
        refuse_latent(cfg, "the continuous-batching server")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.policy = policy
        self.max_batch = max_batch
        self.block_size = block_size
        # per-read correction/detection counts; costs the correcting read
        # (scrub off) - disable for pure-throughput serving
        self.collect_ecc_stats = collect_ecc_stats
        # corrected, detected: the decode steps' sums, kept on the device
        self._ecc_counts = torch.zeros(2, dtype=torch.int64, device=self.device)
        self.prefill_bucket = max(1, prefill_bucket)
        self.max_pages_per_seq = -(-max_seq_len // block_size)
        if num_blocks is None:
            num_blocks = max_batch * self.max_pages_per_seq + 1
        self.cache_cfg = ECCCacheConfig(
            num_blocks=num_blocks, block_size=block_size, num_layers=cfg.num_layers,
            num_kv_heads=self._cache_kv_heads(), head_dim=cfg.head_dim, codec=policy.codec,
            max_seqs=max_batch)
        self.state = allocate_ecc_kv_cache(self.cache_cfg, device=self.device)
        self.state["context_len"] = torch.zeros((max_batch,), dtype=torch.int32,
                                                device=self.device)
        # +1 manager row: row 0 owns the trash page, slots are rows 1..B
        self.manager = BlockManager(num_blocks, block_size, max_seqs=max_batch + 1,
                                    device=self.device)
        self.manager.allocate(seq_id=0, num_tokens=1)  # physical block 0
        self.slots: List[Optional[_SlotState]] = [None] * max_batch
        self.waiting: List[Request] = []
        self.finished: List[RequestOutput] = []
        self._step_counter = 0
        self._gen = torch.Generator(device=self.device).manual_seed(policy.seed)
        self._sample_gen = torch.Generator(device=self.device).manual_seed(policy.seed + 1)

    # -- step functions (the tensor-parallel server's hooks) ----------------

    def _cache_kv_heads(self) -> int:
        """The KV heads of the cache this server holds."""
        return self.cfg.num_kv_heads

    def _run_prefill(self, ids, row, logit_pos, true_len):
        self.state["context_len"] = torch.zeros((ids.shape[0],), dtype=torch.int32,
                                                device=self.device)
        logits, self.state = prefill(self.params, ids, self.state, row, self.cfg, self.policy,
                                     self._gen, logit_pos=logit_pos, true_len=true_len)
        return logits

    def _run_decode(self, tokens, block_table):
        self.state["context_len"] = torch.from_numpy(self._context_lens()).to(self.device)
        self.state.pop("ecc_corrected", None)
        self.state.pop("ecc_detected", None)
        logits, self.state = decode_step(self.params, tokens, self.state, block_table, self.cfg,
                                         self.policy, self._gen, block_size=self.block_size,
                                         collect_ecc_stats=self.collect_ecc_stats)
        self._harvest_ecc()
        return logits

    def _harvest_ecc(self):
        """Pop the decode step's counters and add their sums into the
        device totals, with no host sync."""
        if self.collect_ecc_stats:
            self._ecc_counts += torch.stack([self.state.pop("ecc_corrected").sum(),
                                             self.state.pop("ecc_detected").sum()])

    @property
    def ecc_stats(self) -> dict:
        """Cumulative decode-phase ECC counters across all served steps,
        read from the device when asked."""
        corrected, detected = self._ecc_counts.tolist()
        return {"errors_corrected": corrected, "errors_detected": detected}

    # -- host-side bookkeeping -------------------------------------------

    def _mgr_id(self, slot: int) -> int:
        return slot + 1  # manager seq 0 is the trash page owner

    def _block_table(self) -> torch.Tensor:
        """[max_batch, max_pages_per_seq] int32 on the device, -1 for
        unallocated (manager rows are offset by one)."""
        full = self.manager.block_table(self.max_pages_per_seq)
        return full[1:self.max_batch + 1].contiguous()

    def _context_lens(self) -> np.ndarray:
        lens = np.zeros(self.max_batch, np.int32)
        for s, st in enumerate(self.slots):
            if st is not None:
                lens[s] = st.context_len
        return lens

    @property
    def num_active(self) -> int:
        return sum(st is not None for st in self.slots)

    @property
    def has_work(self) -> bool:
        return self.num_active > 0 or len(self.waiting) > 0

    def add_request(self, request: Request):
        total = len(request.prompt_ids) + request.max_new_tokens
        if total > self.max_pages_per_seq * self.block_size:
            raise ValueError(f"request {request.request_id} needs {total} tokens > "
                             f"max_seq_len {self.max_pages_per_seq * self.block_size}")
        pages = -(-total // self.block_size)
        if pages > self.manager.num_blocks - 1:  # block 0 is the trash page
            raise ValueError(f"request {request.request_id} needs {pages} pages > "
                             f"{self.manager.num_blocks - 1} allocatable blocks")
        self.waiting.append(request)

    # -- admission (prefill) ---------------------------------------------

    def _try_admit(self):
        limit = self.max_pages_per_seq * self.block_size
        for slot in range(self.max_batch):
            if not self.waiting or self.slots[slot] is not None:
                continue
            req = self.waiting[0]
            S = int(len(req.prompt_ids))
            # pad the prompt to a bucket boundary; reserve the whole
            # lifetime (prompt + generation) up front, so decode never runs
            # out of blocks mid-serve
            S_pad = min(-(-max(S, 1) // self.prefill_bucket) * self.prefill_bucket, limit)
            total = min(max(S + req.max_new_tokens, S_pad), limit)
            if -(-total // self.block_size) > self.manager.num_free_blocks:
                break  # no memory; retry after something finishes
            self.waiting.pop(0)
            padded = np.zeros(S_pad, np.int64)
            padded[:S] = req.prompt_ids
            self.manager.allocate(self._mgr_id(slot), total)
            row = self._block_table()[slot:slot + 1]
            ids = torch.from_numpy(padded)[None, :].to(self.device)
            dev_int = dict(dtype=torch.int32, device=self.device)
            logits = self._run_prefill(ids, row, torch.tensor([S - 1], **dev_int),
                                       torch.tensor([S], **dev_int))
            next_tok = int(self._pick_tokens(logits, {0: req})[0])
            self.slots[slot] = _SlotState(request=req, context_len=S, generated=[],
                                          next_token=next_tok)
            self._note_token(slot, next_tok)

    def _pick_tokens(self, logits, requests_by_row) -> np.ndarray:
        """Per-row sampling on the device: temperature 0 is the argmax,
        above 0 the Gumbel-max of logits / temperature."""
        temps = np.zeros(logits.shape[0], np.float32)
        for row, req in requests_by_row.items():
            temps[row] = req.temperature
        if (temps > 0).any():
            tokens = sample_tokens(logits, torch.from_numpy(temps), self._sample_gen)
        else:
            tokens = torch.argmax(logits, dim=-1)
        return tokens.cpu().numpy()

    def _decode_tokens(self, tokens: np.ndarray, requests_by_row) -> np.ndarray:
        """One decode step of every slot's next token [max_batch], and the
        tokens sampled from its logits."""
        logits = self._run_decode(torch.from_numpy(tokens).to(self.device), self._block_table())
        return self._pick_tokens(logits, requests_by_row)

    def _note_token(self, slot: int, token: int):
        st = self.slots[slot]
        st.generated.append(token)
        done_len = len(st.generated) >= st.request.max_new_tokens
        done_eos = st.request.eos_token_id is not None and token == st.request.eos_token_id
        if done_len or done_eos:
            self.finished.append(RequestOutput(
                request_id=st.request.request_id, prompt_ids=st.request.prompt_ids,
                token_ids=list(st.generated), finish_reason="eos" if done_eos else "length"))
            self.manager.free_seq(self._mgr_id(slot))
            self.slots[slot] = None

    # -- decode ------------------------------------------------------------

    def step(self) -> List[RequestOutput]:
        """Admit waiting requests, run one decode step for all active slots,
        and return the newly finished requests."""
        already_done = len(self.finished)
        self._try_admit()
        if self.num_active:
            tokens = np.zeros(self.max_batch, np.int64)
            for s, st in enumerate(self.slots):
                if st is not None:
                    tokens[s] = st.next_token
            next_tokens = self._decode_tokens(
                tokens, {i: st.request for i, st in enumerate(self.slots) if st is not None})
            self._step_counter += 1
            for s in range(self.max_batch):
                st = self.slots[s]
                if st is None:
                    continue
                st.context_len += 1
                st.next_token = int(next_tokens[s])
                self._note_token(s, st.next_token)
        return self.finished[already_done:]

    def run(self) -> List[RequestOutput]:
        """Drain all queued work; returns every finished request."""
        while self.has_work:
            self.step()
        return self.finished
