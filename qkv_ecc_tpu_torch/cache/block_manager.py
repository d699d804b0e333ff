"""Host-side paged block allocator (counterpart of
``qkv_ecc_tpu/cache/block_manager.py``).

The bookkeeping (free list, blocks per sequence, the table) stays on the
host in numpy: it changes by a few blocks per step. ``block_table()`` and
``context_lens()`` hand the kernels int32 tensors on the manager's device;
the table is copied there again only after a new block or a release
changed it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int, max_seqs: int = 32, device=None):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_seqs = max_seqs
        self.max_blocks_per_seq = num_blocks
        self.device = resolve_device(device)
        self._free = list(range(num_blocks))
        self._seq_blocks: dict[int, list[int]] = {}
        self._seq_len: dict[int, int] = {}
        self._table = np.full((max_seqs, num_blocks), -1, dtype=np.int32)
        self._dirty = True
        self._table_dev = None

    def allocate(self, seq_id: int, num_tokens: int):
        """Grow seq to num_tokens, allocating blocks first in, first out."""
        if seq_id >= self.max_seqs:
            raise ValueError(f"seq_id {seq_id} >= max_seqs {self.max_seqs}")
        needed = -(-num_tokens // self.block_size)
        blocks = self._seq_blocks.setdefault(seq_id, [])
        new = needed - len(blocks)
        if new > len(self._free):
            raise RuntimeError(f"Out of blocks: need {new}, have {len(self._free)}")
        for _ in range(max(0, new)):
            b = self._free.pop(0)
            self._table[seq_id, len(blocks)] = b
            blocks.append(b)
            self._dirty = True  # only a new block changes the device table
        self._seq_len[seq_id] = num_tokens

    def free_seq(self, seq_id: int):
        blocks = self._seq_blocks.pop(seq_id, [])
        self._free.extend(blocks)
        self._seq_len.pop(seq_id, None)
        self._table[seq_id, :] = -1
        self._dirty = True

    def get_context_len(self, seq_id: int) -> int:
        return self._seq_len.get(seq_id, 0)

    @property
    def num_free_blocks(self) -> int:
        return len(self._free)

    @property
    def allocated_blocks(self) -> int:
        return sum(len(b) for b in self._seq_blocks.values())

    @property
    def num_seqs(self) -> int:
        return len(self._seq_blocks)

    def block_table(self, max_blocks: int | None = None) -> torch.Tensor:
        """Device snapshot of the logical -> physical table [max_seqs,
        max_blocks or num_blocks], int32, -1 for unallocated."""
        if self._dirty or self._table_dev is None:
            self._table_dev = torch.from_numpy(self._table).to(self.device)
            self._dirty = False
        if max_blocks is not None:
            return self._table_dev[:, :max_blocks]
        return self._table_dev

    def context_lens(self) -> torch.Tensor:
        lens = np.zeros(self.max_seqs, dtype=np.int32)
        for s, ln in self._seq_len.items():
            lens[s] = ln
        return torch.from_numpy(lens).to(self.device)

    def physical_slots(self, seq_id: int, positions):
        """(physical_block, slot) int32 numpy arrays for token positions of
        a sequence."""
        positions = np.asarray(positions)
        blocks = np.asarray(self._seq_blocks.get(seq_id, []), dtype=np.int32)
        logical = positions // self.block_size
        if logical.size and logical.max() >= len(blocks):
            raise ValueError("positions exceed allocated blocks")
        phys = blocks[logical] if logical.size else np.zeros(0, np.int32)
        return phys, (positions % self.block_size).astype(np.int32)

    def reset(self):
        for blocks in self._seq_blocks.values():
            self._free.extend(blocks)
        self._seq_blocks.clear()
        self._seq_len.clear()
        self._table[:] = -1
        self._dirty = True
