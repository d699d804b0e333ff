"""The port's BlockManager (qkv_ecc_tpu_torch.cache.block_manager) against
the JAX package's: the same operations on both give equal tables, context
lengths, physical slots, free counts and errors (the operations of
tests/test_engine.py's TestBlockManager, and a random sequence of them)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.cache.block_manager import BlockManager as JManager  # noqa: E402
from qkv_ecc_tpu.cache import layout as jl  # noqa: E402
from qkv_ecc_tpu_torch.cache.block_manager import BlockManager as TManager  # noqa: E402
from qkv_ecc_tpu_torch.cache import layout as tl  # noqa: E402

torch.set_num_threads(1)


def managers(num_blocks, block_size, max_seqs=32):
    return (JManager(num_blocks, block_size, max_seqs),
            TManager(num_blocks, block_size, max_seqs, device="cpu"))


def same_state(j, t, max_blocks=None):
    jt = np.asarray(j.block_table(max_blocks))
    tt = t.block_table(max_blocks)
    assert tt.dtype == torch.int32 and tt.device.type == "cpu"
    np.testing.assert_array_equal(jt, tt.numpy())
    lens = t.context_lens()
    assert lens.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j.context_lens()), lens.numpy())
    for name in ("num_free_blocks", "allocated_blocks", "num_seqs"):
        assert getattr(j, name) == getattr(t, name), name


def both(pair, op, *args):
    """Run op on both managers: equal results, or the same exception type
    and message."""
    outs = []
    for m in pair:
        try:
            outs.append(("ok", getattr(m, op)(*args)))
        except (ValueError, RuntimeError) as e:
            outs.append((type(e), str(e)))
    (ka, a), (kb, b) = outs
    assert ka == kb, (op, args, outs)
    if ka == "ok" and a is not None:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    elif ka != "ok":
        assert a == b
    return ka


@pytest.mark.parametrize("case", ["basic", "growth", "multi", "oom", "reset", "free",
                                  "slots", "bad_seq"])
def test_operations_match_jax(case):
    j, t = managers(8 if case not in ("oom",) else 2, 4 if case == "slots" else 16)
    pair = (j, t)
    if case == "basic":
        both(pair, "allocate", 0, 20)
    elif case == "growth":
        both(pair, "allocate", 0, 10)
        both(pair, "allocate", 0, 30)
        both(pair, "allocate", 0, 5)  # shrinking keeps the blocks
    elif case == "multi":
        both(pair, "allocate", 0, 16)
        both(pair, "allocate", 1, 32)
        both(pair, "allocate", 3, 1)
    elif case == "oom":
        assert both(pair, "allocate", 0, 100) is RuntimeError
    elif case == "reset":
        both(pair, "allocate", 0, 64)
        both(pair, "allocate", 2, 17)
        both(pair, "reset")
    elif case == "free":
        both(pair, "allocate", 0, 32)
        both(pair, "allocate", 1, 16)
        both(pair, "free_seq", 0)
        both(pair, "allocate", 2, 40)  # reuses the freed blocks first in, first out
    elif case == "slots":
        both(pair, "allocate", 0, 10)
        both(pair, "physical_slots", 0, np.arange(10))
        assert both(pair, "physical_slots", 0, np.arange(13)) is ValueError
        both(pair, "physical_slots", 5, np.arange(0))
    elif case == "bad_seq":
        assert both(pair, "allocate", 32, 1) is ValueError
    same_state(j, t)
    same_state(j, t, max_blocks=3)
    for s in range(4):
        assert j.get_context_len(s) == t.get_context_len(s)


def test_random_operations_match_jax():
    """200 random allocations, growths and releases over 6 sequences and 24
    blocks of 16 tokens: after every operation the tables, lengths and
    counts are equal, and so are the errors (out of blocks)."""
    rng = np.random.default_rng(0)
    j, t = managers(24, 16, max_seqs=6)
    pair = (j, t)
    for _ in range(200):
        seq = int(rng.integers(0, 6))
        if rng.random() < 0.3:
            both(pair, "free_seq", seq)
        else:
            both(pair, "allocate", seq, int(j.get_context_len(seq) + rng.integers(1, 60)))
        same_state(j, t)
        if j.get_context_len(seq):
            both(pair, "physical_slots", seq, np.arange(j.get_context_len(seq)))


def test_device_table_follows_changes():
    """block_table() is re-copied only after a change, and always shows the
    host table: the same tensor while nothing changed, a new one after a
    block is added or freed."""
    t = TManager(8, 16, 4, device="cpu")
    t.allocate(0, 10)
    a = t.block_table()
    assert t.block_table() is a
    t.allocate(0, 12)  # same block: no change
    assert t.block_table() is a
    t.allocate(0, 20)
    b = t.block_table()
    assert b is not a and int(b[0, 1]) == 1
    t.free_seq(0)
    assert (t.block_table()[0] == -1).all()


def test_layout_helpers_match_jax():
    """create_block_table, compute_slot_mapping, cache_dtype_for,
    storage_bits_per_value and the cache configuration of all six codecs."""
    np.testing.assert_array_equal(np.asarray(jl.create_block_table(3, 5)),
                                  tl.create_block_table(3, 5, device="cpu").numpy())
    pos = np.arange(40)
    for a, b in zip(jl.compute_slot_mapping(pos, 16), tl.compute_slot_mapping(pos, 16)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert jl.CODEC_CHOICES == tl.CODEC_CHOICES
    for codec in tl.CODEC_CHOICES:
        assert jl.storage_bits_per_value(codec) == tl.storage_bits_per_value(codec)
        jc = jl.ECCCacheConfig(num_blocks=6, block_size=16, num_layers=2, num_kv_heads=2,
                               head_dim=32, codec=codec)
        tc = tl.ECCCacheConfig(num_blocks=6, block_size=16, num_layers=2, num_kv_heads=2,
                               head_dim=32, codec=codec)
        for f in ("row_words", "data_words", "parity_words", "padded_head_dim", "needs_scales"):
            assert getattr(jc, f) == getattr(tc, f), (codec, f)
        assert (jc.cache_shape(), jc.parity_shape(), jc.scales_shape()) == (
            tc.cache_shape(), tc.parity_shape(), tc.scales_shape())
        cache = tl.allocate_ecc_kv_cache(tc, device="cpu")
        assert cache["k_cache"].dtype == tl.cache_dtype_for(codec)
    # the float codecs store JAX's types: fp8 e4m3, fp16 bfloat16 (F6)
    assert np.dtype(jl.cache_dtype_for("fp8")).name == "float8_e4m3fn"
    assert tl.cache_dtype_for("fp8") == torch.float8_e4m3fn
    assert np.dtype(jl.cache_dtype_for("fp16")).name == "bfloat16"
    assert tl.cache_dtype_for("fp16") == torch.bfloat16
    with pytest.raises(ValueError):
        tl.ECCCacheConfig(codec="int3")
    with pytest.raises(ValueError):
        jl.ECCCacheConfig(codec="int3")
