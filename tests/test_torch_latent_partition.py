"""The latent read's partition of work (kernels/paged_attention.py
latent_blocks, latent_workers and latent_partition: the plain model of what
csrc/latent_attend.cu computes on the card from the context lengths), on
the CPU:

  * every tile of every row is taken by exactly one worker, in order;
  * at DeepSeek-V2-Lite's cell (256 rows of 6144-8064 tokens on 63 pages of
    128, 132 SMs) every SM holds within 1% of the mean number of tiles;
  * the tiny model's shape, batch 1 and rows without tokens get a valid
    grid: at least one block, at most one an SM, every worker at least
    LATENT_MIN_TILES tiles (or all of them);
  * the parts of a row cut over workers meet in distinct scratch slots,
    listed in merge order by the rule the kernel's last worker follows
    (merge_slots, the kernel's worker_of and slot_of);
  * the wrapper's constants are the kernel source's.
"""

import random
import re
from pathlib import Path

import pytest

from qkv_ecc_tpu_torch.kernels import paged_attention as pa

H100_SMS = 132
PAGES, BS = 63, 128  # the cell's block table: 8064 positions a row


def row_tiles(ctxs):
    return [-(-c // pa.LATENT_TILE) for c in ctxs]


def cell_contexts(seed):
    rng = random.Random(seed)
    return [rng.randint(6144, 8064) for _ in range(256)]


CASES = {
    "cell": (cell_contexts(0), PAGES, H100_SMS),
    "cell-seed-1": (cell_contexts(1), PAGES, H100_SMS),
    "four-rows": ([8064, 6144, 7001, 6500], PAGES, H100_SMS),
    "short-rows": ([1, 63, 64, 65, 128, 129, 8064], PAGES, H100_SMS),
    "batch-1": ([5000], PAGES, H100_SMS),
    "batch-1-one-token": ([1], PAGES, H100_SMS),
    "empty-rows": ([0, 300, 0, 0, 4097, 0], PAGES, H100_SMS),
    "all-empty": ([0, 0], PAGES, H100_SMS),
    "tiny": ([100, 37, 108], 2, 8),  # tiny-deepseek-v2 in the card test: pages of 64
}


def merge_slots(row_start, row_tiles, total_tiles, workers):
    """The scratch slots, in merge order, of the parts of the row whose tiles
    are [row_start, row_start + row_tiles) of the launch's: worker k writes
    slot 2k when the row is its first, else 2k + 1; the workers run from the
    one holding the row's first tile to the one holding its last (the last
    k with k T // W <= x)."""
    T, W = total_tiles, workers

    def worker_of(x):
        return -(-(x + 1) * W // T) - 1

    return [2 * k + (0 if k * T // W >= row_start else 1)
            for k in range(worker_of(row_start), worker_of(row_start + row_tiles - 1) + 1)]


def partition(ctxs, pages, sms):
    blocks = pa.latent_blocks(len(ctxs), pages * BS // pa.LATENT_TILE, sms)
    return blocks, pa.latent_partition(row_tiles(ctxs), blocks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_tile_is_taken_once_in_order(case):
    ctxs, pages, sms = CASES[case]
    blocks, parts = partition(ctxs, pages, sms)
    tiles = row_tiles(ctxs)
    seen = [[0] * n for n in tiles]
    flat = []
    for mine in parts:
        for b, lo, hi in mine:
            assert 0 <= lo < hi <= tiles[b]
            for t in range(lo, hi):
                seen[b][t] += 1
                flat.append((b, t))
    assert all(c == 1 for row in seen for c in row), case
    assert flat == sorted(flat)  # worker k's range follows worker k - 1's
    assert 1 <= blocks <= sms and len(parts) <= pa.LATENT_GROUPS * blocks


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_worker_takes_enough_tiles(case):
    ctxs, pages, sms = CASES[case]
    _, parts = partition(ctxs, pages, sms)
    total = sum(row_tiles(ctxs))
    sizes = [sum(hi - lo for _, lo, hi in mine) for mine in parts]
    assert max(sizes) - min(sizes) <= 1  # the same to one tile
    assert min(sizes) >= min(pa.LATENT_MIN_TILES, total)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cell_balances_the_sms(seed):
    """At the cell every block holds two workers, and no SM takes more than
    1% over the mean of its tiles (the rows' lengths differ by 31%)."""
    ctxs = cell_contexts(seed)
    blocks, parts = partition(ctxs, PAGES, H100_SMS)
    assert blocks == H100_SMS and len(parts) == pa.LATENT_GROUPS * H100_SMS
    per_sm = [0] * blocks
    for k, mine in enumerate(parts):
        per_sm[k % blocks] += sum(hi - lo for _, lo, hi in mine)
    mean = sum(per_sm) / blocks
    assert max(per_sm) <= 1.01 * mean and min(per_sm) >= 0.99 * mean


def test_small_batches_keep_blocks_busy():
    """Fewer rows than SMs: blocks enough for LATENT_MIN_TILES tiles a worker
    at the table's width, never more than the SMs, never none."""
    width = PAGES * BS // pa.LATENT_TILE
    assert pa.latent_blocks(1, width, H100_SMS) == -(-width // (2 * pa.LATENT_MIN_TILES))
    assert pa.latent_blocks(4, width, H100_SMS) == 32
    assert pa.latent_blocks(256, width, H100_SMS) == H100_SMS
    assert pa.latent_blocks(1, 1, H100_SMS) == 1
    assert pa.latent_workers(0, 5) == 1 and pa.latent_workers(7, 5) == 1
    assert pa.latent_workers(10 ** 6, 5) == 10


@pytest.mark.parametrize("case", sorted(CASES))
def test_parts_of_a_row_meet_in_distinct_slots(case):
    ctxs, pages, sms = CASES[case]
    blocks, parts = partition(ctxs, pages, sms)
    tiles = row_tiles(ctxs)
    total = sum(tiles)
    workers = pa.latent_workers(total, blocks)
    assert workers == len(parts)
    start = [sum(tiles[:b]) for b in range(len(tiles))]
    written = {}
    for k, mine in enumerate(parts):
        for i, (b, lo, hi) in enumerate(mine):
            if hi - lo == tiles[b]:
                continue  # a whole row: written at once, no slot
            slot = 2 * k + (0 if i == 0 else 1)
            assert slot not in written
            written[slot] = b
    for b, n in enumerate(tiles):
        if n == 0:
            continue
        slots = merge_slots(start[b], n, total, workers)
        if len(slots) == 1:
            assert all(written.get(s) != b for s in written)
            continue
        assert sorted(s for s, row in written.items() if row == b) == slots


def test_constants_are_the_kernel_source():
    """The wrapper's tile, workers a block, fewest tiles a worker and scratch
    size are csrc/latent_attend.cu's."""
    src = (Path(pa.__file__).resolve().parent.parent / "csrc" / "latent_attend.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kTile") == pa.LATENT_TILE
    assert const("kGroups") == pa.LATENT_GROUPS
    assert const("kMinTiles") == pa.LATENT_MIN_TILES
    assert const("kGroupWarps") * const("kNTW") * 32 * 4 == pa.LATENT_PART_FLOATS
