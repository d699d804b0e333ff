"""The port's decode slice (qkv_ecc_tpu_torch.models.runtime) against the JAX
runtime with the same weights (params_from_jax): on tiny-gpt2 (GPT-2's
layout and tied head, 4/4 heads: group 1) in bench.py's five arms, int4,
fp16, fp8 and a statistics run (hamming84 with interpolation), and on
tiny-llama in every mode: the five of bench.py, mode int4 (read-time
injection), the float arms fp16 (bfloat16 values, never injected) and fp8
(e4m3, write injection of its bytes), the unscrubbed reads (scrub=False) of hamming84, golay,
hamming74 and int4, and collect_ecc_stats in golay, hamming74, hamming84
(with and without interpolation) and int4. Prefill runs at BER 0 (int4: at the mode's BER,
with the read flips JAX draws from its layer keys), then decode steps on the
same masks: numpy-made raw masks passed as hoisted_masks - folded by each
package in the scrubbed modes, raw in the others (BER 1e-2; 5e-2 for the
correcting reads, so that doubles reach the interpolation) - or, where JAX
draws per layer from its keys (golay unscrubbed, every step that collects
statistics, and fp8, whose masks JAX never hoists), those very masks; and
JAX's per-step read seed for int4.

Stored words (data nibbles and parity; the float codecs' values, bit for
bit) must be equal after prefill and after every decode step, and so must
the ECC counters: none differs on these inputs. Words could, because the
two frameworks' float32 matmuls differ by an ulp, and a K/V value on a
quantization (or bfloat16, e4m3 rounding) boundary would then land on the
neighbouring code; the test would report the count. That happens to fp16,
whose bfloat16 values have 2^8 times more rounding boundaries than the
int4 codes: one K value of prefill and one V value of step 4 (of 4096 each)
come out one bfloat16 ulp apart, so fp16's stored values are held to at
most 2 values per array one ulp apart and the rest bit for bit (and
test_float_write_tokens_matches_jax holds the same write chain bit for bit
on equal K/V).

Tolerances, with their reasons:
  * scales are absmax / 7 of the K/V projections, so those ulps show in them
    directly: within 4 float32 ulps (rtol 4.8e-7) after prefill;
  * in decode both attentions round p * v_scale to bf16, and an ulp of
    difference in a scale can move one such weight across a bf16 rounding
    boundary (one bf16 ulp, 2^-8 relative, in one weight). That moves the
    layer's output by about 1e-4 here (measured up to 1.1e-4 in the logits),
    so logits agree within atol 1e-3 and the scales that later layers write
    within rtol 1e-3 (measured up to 1.8e-4);
  * greedy tokens must be identical.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.codecs.fault_injection import flip_mask_for  # noqa: E402
from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu.models import runtime as jr  # noqa: E402
from qkv_ecc_tpu.models.config import TINY_LLAMA as J_TINY  # noqa: E402
from qkv_ecc_tpu.models.config import TINY_GPT2 as J_GPT2  # noqa: E402
from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy  # noqa: E402
from qkv_ecc_tpu.models.registry import init_params as j_init  # noqa: E402
from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc_write_attend  # noqa: E402
from qkv_ecc_tpu_torch.kernels.paged_attention import write_decode_attend  # noqa: E402
from qkv_ecc_tpu_torch.kernels import swar  # noqa: E402
from qkv_ecc_tpu_torch.kernels.common import hamming84_decode_i32  # noqa: E402
from qkv_ecc_tpu_torch.models import runtime as tr  # noqa: E402
from qkv_ecc_tpu_torch.models.config import TINY_LLAMA as T_TINY  # noqa: E402
from qkv_ecc_tpu_torch.models.config import TINY_GPT2 as T_GPT2  # noqa: E402
from qkv_ecc_tpu_torch.models.kv_policy import N_BITS, hoisted_write_deltas  # noqa: E402
from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode as t_policy  # noqa: E402
from qkv_ecc_tpu_torch.models.llama import params_from_jax  # noqa: E402

torch.set_num_threads(1)
B, PROMPT, STEPS, BS = 2, 21, 6, 16
CACHE_NAMES = ("k_cache", "v_cache", "k_scales", "v_scales", "k_parity", "v_parity")


@pytest.fixture(scope="module")
def weights():
    jparams = j_init(J_TINY, 0)
    np_params = jax.tree.map(np.asarray, jparams)
    return jparams, params_from_jax(np_params, T_TINY, device="cpu")


@pytest.fixture(scope="module")
def gpt2_weights():
    jparams = j_init(J_GPT2, 0)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), T_GPT2, device="cpu")


def numpy_masks(rng, shape, ber, n_bits):
    flips = rng.random((n_bits,) + tuple(shape)) < ber
    return (flips.astype(np.int64) << np.arange(n_bits).reshape((n_bits,) + (1,) * len(shape))
            ).sum(0).astype(np.int32)


def stored_bits(a):
    """Stored words as integers: the float codecs' bfloat16 / e4m3 values
    as their bits (JAX and torch arrays alike)."""
    if isinstance(a, torch.Tensor):
        if a.dtype in (torch.bfloat16, torch.float8_e4m3fn):
            a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.uint8)
        return a.numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 1: np.uint8}[a.itemsize]) if a.dtype.name in (
        "bfloat16", "float8_e4m3fn") else a


def compare_caches(jstate, tstate, where, scale_rtol):
    """Stored words equal, reporting how many differ (bfloat16 values: at
    most 2 per array, each one ulp apart); scales within scale_rtol (see the
    module docstring)."""
    words = {}
    for n in ("k_cache", "v_cache", "k_parity", "v_parity"):
        if n not in tstate:
            continue
        a, b = stored_bits(jstate[n]).astype(np.int32), stored_bits(tstate[n]).astype(np.int32)
        if tstate[n].dtype == torch.bfloat16 and (a != b).sum() <= 2 and (
                np.abs(a - b) <= 1).all():
            continue
        words[n] = int((a != b).sum())
    assert sum(words.values()) == 0, f"{where}: differing stored words {words}"
    for n in ("k_scales", "v_scales"):
        np.testing.assert_allclose(tstate[n].numpy(), np.asarray(jstate[n]), rtol=scale_rtol,
                                   atol=0, err_msg=f"{where}: {n}")


def test_config_copied():
    for f in ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
              "head_dim", "intermediate_size", "rope_theta", "rms_norm_eps",
              "tie_word_embeddings", "sliding_window", "dtype", "rope_scaling_llama3"):
        assert getattr(J_TINY, f) == getattr(T_TINY, f), f


NO_SCRUB = "int4-hamming84/scrub=False"
READ = 0x52454144  # JAX's "READ" stream: jax.random.fold_in(key, READ)
SLICE_MODES = ["int4-write-inject", "int12-golay", "int4-hamming", "int4-hamming84",
               "int4-hamming84-interp", NO_SCRUB, "int4", "fp16", "fp8", "int12-golay/scrub=False",
               "int4-hamming/scrub=False", "int4-write-inject/scrub=False", "int12-golay/stats",
               "int4-hamming/stats", "int4-hamming84/stats", "int4-hamming84-interp/stats",
               "int4/stats"]


def policies(mode, ber=0.0):
    """(JAX policy, port policy) of a mode name, with "/scrub=False" for a
    policy without scrub (a "/stats" suffix changes the run, not the
    policy)."""
    base = mode.split("/")[0]
    jpol, tpol = j_policy(base, ber=ber), t_policy(base, ber=ber)
    if mode.endswith("/scrub=False"):
        jpol, tpol = dataclasses.replace(jpol, scrub=False), dataclasses.replace(tpol, scrub=False)
    return jpol, tpol


def key_masks(jpol, step_key, shape, num_layers=J_TINY.num_layers):
    """The write masks JAX draws per layer from its keys when it hoists
    none (golay unscrubbed, or collecting statistics): [L, 2, *shape]."""
    kv_key = jax.random.fold_in(step_key, 1000000)
    n_bits = N_BITS[jpol.codec]
    return np.stack([np.stack([np.asarray(flip_mask_for(k, shape, jpol.ber, n_bits))
                               for k in jr._layer_kv_key(jpol, i, kv_key)])
                     for i in range(num_layers)]).astype(np.int32)


def prefill_read_masks(jpol, key, shape, num_layers=J_TINY.num_layers):
    """The read flips of JAX's int4 prefill: per layer, K and V, from the
    layer keys folded with READ, [L, 2, *shape]."""
    return np.stack([np.stack([np.asarray(flip_mask_for(jax.random.fold_in(k, READ), shape,
                                                        jpol.ber, 4))
                               for k in jr._layer_kv_key(jpol, i, key)])
                     for i in range(num_layers)]).astype(np.int32)


@pytest.mark.parametrize("mode", SLICE_MODES)
def test_slice_matches_jax(weights, mode):
    run_slice(weights, mode, J_TINY, T_TINY, 4.8e-7)


def run_slice(weights, mode, jcfg, tcfg, prefill_scale_rtol):
    """Prefill and STEPS decode steps of one mode on (jcfg, tcfg) in both
    packages, compared as the module docstring says, the scales after
    prefill within prefill_scale_rtol."""
    jparams, tparams = weights
    L = tcfg.num_layers
    stats = mode.endswith("/stats")
    jpol0, tpol0 = policies(mode)
    codec = tpol0.codec
    read = tpol0.inject_at == "read"
    floats = codec in ("fp16", "fp8")
    scrubbed = (tpol0.scrub and not tpol0.use_interpolation and not stats and not read
                and not floats)
    ber = 1e-2 if scrubbed or floats else 5e-2
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (B, PROMPT))
    T = PROMPT + STEPS + 2

    jstate, jbt, _ = jr.init_generation_state(jcfg, jpol0, B, T, block_size=BS)
    tstate, tbt, _ = tr.init_generation_state(tcfg, tpol0, B, T, block_size=BS, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbt), tbt.numpy())
    key = jax.random.key(7)
    jpol, tpol = policies(mode, ber)
    if read:  # the int4 arm reads its prompt through fresh flips
        rm = prefill_read_masks(jpol, key, (B, PROMPT, tcfg.num_kv_heads, tcfg.head_dim), L)
        jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jbt, jcfg, jpol, key)
        tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, tcfg, tpol,
                                     read_masks=torch.from_numpy(rm))
        assert int(np.count_nonzero(rm)) > 0
    else:
        jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jbt, jcfg, jpol0, key)
        tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, tcfg, tpol0)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    compare_caches(jstate, tstate, "prefill", prefill_scale_rtol)

    shape = tr.write_mask_shape(tpol, B, tcfg)
    assert shape == jr._write_mask_shape(jpol, B, jcfg)
    launches = paged_attention_ecc_write_attend.launches, write_decode_attend.launches
    for step in range(STEPS):
        step_key = jax.random.fold_in(key, step)
        raw = numpy_masks(rng, (L, 2) + shape, ber, N_BITS.get(codec, 8))
        seed = None
        if read:
            jh = th = None
            seed = int(np.asarray(jax.random.bits(jax.random.fold_in(step_key, READ), (),
                                                  "uint32")).astype(np.int32))
        elif codec == "fp16":  # never injected
            jh = th = None
        elif stats or codec == "fp8" or (codec == "golay" and not scrubbed):  # JAX draws per layer
            jh, th = None, torch.from_numpy(key_masks(jpol, step_key, shape, L))
        elif scrubbed:
            jh = js.scrub_fold_mask(codec, jnp.asarray(raw)).astype(jnp.uint8)
            th = hoisted_write_deltas(tpol, L, shape, raw_masks=torch.from_numpy(raw))
            np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        else:  # raw logical masks, XORed into the codewords
            jh, th = jnp.asarray(raw.astype(np.uint8)), torch.from_numpy(raw.astype(np.uint8))
        jtok, ttok = jnp.argmax(jlogits, axis=-1), torch.argmax(tlogits, dim=-1)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy(), err_msg=f"step {step}")
        jlogits, jstate = jr.decode_step(jparams, jtok, jstate, jbt, jcfg, jpol, step_key,
                                         block_size=BS, hoisted_masks=jh,
                                         collect_ecc_stats=stats)
        tlogits, tstate = tr.decode_step(tparams, ttok, tstate, tbt, tcfg, tpol,
                                         block_size=BS, hoisted_masks=th, collect_ecc_stats=stats,
                                         read_inject_seed=seed)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-3,
                                   err_msg=f"step {step}")
        compare_caches(jstate, tstate, f"step {step}", 1e-3)
        if stats:
            for n in ("ecc_corrected", "ecc_detected"):
                assert tstate[n].dtype == torch.int32
                np.testing.assert_array_equal(np.asarray(jstate[n]), tstate[n].numpy(),
                                              err_msg=f"step {step}: {n}")
    np.testing.assert_array_equal(np.asarray(jstate["context_len"]), tstate["context_len"].numpy())
    # the CPU path never launches
    assert (paged_attention_ecc_write_attend.launches, write_decode_attend.launches) == launches
    if stats:
        assert (tstate["ecc_corrected"] > 0).all()
        if codec in ("golay", "hamming84"):
            assert (tstate["ecc_detected"] > 0).all()
    if codec == "hamming84" and not scrubbed:  # the cache holds doubles the read decoded
        rows = torch.cat([tstate["k_cache"], tstate["k_parity"]], dim=3).movedim(3, -1)
        _, et = hamming84_decode_i32(swar.unpack_codewords("hamming84", rows, tcfg.head_dim))
        assert int((et == 2).sum()) > 0


@pytest.mark.parametrize("mode", ["int4-write-inject", "int12-golay", "int4-hamming",
                                  "int4-hamming84", "int4-hamming84-interp", NO_SCRUB, "int4",
                                  "int12-golay/scrub=False", "int4-hamming/scrub=False", "fp16",
                                  "fp8"])
def test_decode_loop_and_generate(weights, mode):
    """decode_loop feeds argmax tokens step by step (same as decode_step in
    a loop); generate = prefill + greedy decode; both deterministic per
    seed."""
    _, tparams = weights
    pol = dataclasses.replace(policies(mode, 1e-2)[1], seed=3)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (B, PROMPT)))
    out1 = tr.generate(tparams, ids, T_TINY, pol, max_new_tokens=5, block_size=BS, device="cpu")
    out2 = tr.generate(tparams, ids, T_TINY, pol, max_new_tokens=5, block_size=BS, device="cpu")
    assert out1.shape == (B, PROMPT + 5) and torch.equal(out1, out2)
    assert torch.equal(out1[:, :PROMPT], ids)

    def run(loop):
        state, bt, _ = tr.init_generation_state(T_TINY, pol, B, 40, BS, device="cpu")
        g = torch.Generator().manual_seed(5)
        logits, state = tr.prefill(tparams, ids, state, bt, T_TINY, pol, g)
        if loop:
            return tr.decode_loop(tparams, logits, state, bt, T_TINY, pol, g, 4, BS)
        toks = []
        for _ in range(4):
            toks.append(torch.argmax(logits, -1))
            logits, state = tr.decode_step(tparams, toks[-1], state, bt, T_TINY, pol, g, BS)
        return logits, state, torch.stack(toks)

    a, b = run(True), run(False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    for n in CACHE_NAMES:
        if n in a[1]:
            assert torch.equal(a[1][n], b[1][n]), n


def test_negative_page_raises(weights):
    """F5 (the name is the test's from before the repair, when such a step
    raised): a decode step with an inactive row - block-table row -1,
    context 0, as the server leaves a free slot - decodes into the trash
    page 0 instead of raising, in int12-golay and int4-hamming84-interp."""
    for mode in ("int12-golay", "int4-hamming84-interp"):
        decode_with_inactive_row(weights, mode)


def decode_with_inactive_row(weights, mode):
    """Decode with row 1 inactive against JAX's decode_step on the same inputs (BER
    1e-2, numpy-made masks): int12-golay scatters its parity columns at the
    end of the step (the r-th -1 row's to slot r % block_size of page 0),
    interp's kernel writes them. The table's pages start at 1, and the last
    physical page belongs to no row. Logits within atol 1e-3 (the module
    docstring's bound), pages 1 .. NB-2 bit-equal to JAX's after each of two
    steps, page 0 is trash, and the last page stays as it was (a torch index
    of -1 would wrap to it)."""
    jparams, tparams = weights
    jpol, tpol = policies(mode, 1e-2)
    jpol0, tpol0 = policies(mode)
    codec = tpol.codec
    scrubbed = tpol.scrub and not tpol.use_interpolation
    Bn, P = 3, 3
    rng = np.random.default_rng(3)
    ids = rng.integers(0, J_TINY.vocab_size, (Bn, PROMPT))
    from qkv_ecc_tpu.cache.layout import ECCCacheConfig as JCfg, allocate_ecc_kv_cache as jalloc
    from qkv_ecc_tpu_torch.cache.layout import ECCCacheConfig as TCfg, allocate_ecc_kv_cache as talloc

    dims = dict(num_blocks=Bn * P + 2, block_size=BS, num_layers=J_TINY.num_layers,
                num_kv_heads=J_TINY.num_kv_heads, head_dim=J_TINY.head_dim, codec=codec)
    jstate, tstate = jalloc(JCfg(**dims)), talloc(TCfg(**dims), device="cpu")
    bt = (np.arange(Bn * P, dtype=np.int32) + 1).reshape(Bn, P)
    key = jax.random.key(5)
    jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jnp.asarray(bt), J_TINY,
                                 jpol0, key)
    tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, torch.from_numpy(bt),
                                 T_TINY, tpol0)
    bt[1] = -1  # row 1 retired: no pages, context 0
    ctx = np.asarray(jstate["context_len"]).copy()
    ctx[1] = 0
    jstate["context_len"] = jnp.asarray(ctx)
    tstate["context_len"] = torch.from_numpy(ctx)
    last = {n: tstate[n][:, -1].clone() for n in CACHE_NAMES if n in tstate}
    shape = tr.write_mask_shape(tpol, Bn, T_TINY)
    for step in range(2):
        raw = numpy_masks(rng, (T_TINY.num_layers, 2) + shape, 1e-2, N_BITS[codec])
        if scrubbed:
            jh = js.scrub_fold_mask(codec, jnp.asarray(raw)).astype(jnp.uint8)
            th = hoisted_write_deltas(tpol, T_TINY.num_layers, shape,
                                      raw_masks=torch.from_numpy(raw))
        else:
            jh, th = jnp.asarray(raw.astype(np.uint8)), torch.from_numpy(raw.astype(np.uint8))
        jtok, ttok = jnp.argmax(jlogits, axis=-1), torch.argmax(tlogits, dim=-1)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy(), err_msg=f"step {step}")
        jlogits, jstate = jr.decode_step(jparams, jtok, jstate, jnp.asarray(bt), J_TINY, jpol,
                                         jax.random.fold_in(key, step), block_size=BS,
                                         hoisted_masks=jh)
        tlogits, tstate = tr.decode_step(tparams, ttok, tstate, torch.from_numpy(bt), T_TINY,
                                         tpol, block_size=BS, hoisted_masks=th)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-3,
                                   err_msg=f"step {step}")
        live = {n: jstate[n] for n in jstate if n in CACHE_NAMES}
        compare_caches({n: np.asarray(a)[:, 1:-1] for n, a in live.items()},
                       {n: tstate[n][:, 1:-1] for n in live}, f"step {step}", 1e-3)
        for n, before in last.items():
            assert torch.equal(tstate[n][:, -1], before), f"step {step}: {n} of the last page"
    # the -1 row's token went to page 0: its data column at slot 0 (ctx 1)
    assert tstate["k_cache"][:, 0, :, :, 0].any()
    np.testing.assert_array_equal(tstate["context_len"].numpy(), ctx + 2)


def test_batch_above_block_size_matches_jax(weights):
    """F13: a scrubbed decode step at a batch above block_size - tiny-llama,
    int4-hamming84 at BER 0, pages of 16, batch 17, max_tokens 32, a
    4-token prompt of zeros, one decode_step - against JAX's: logits within
    the module docstring's atol 1e-3, the stored data and parity words
    equal bit for bit (scales within its decode rtol 1e-3)."""
    jparams, tparams = weights
    jpol, tpol = policies("int4-hamming84")
    batch = 17
    ids = np.zeros((batch, 4), dtype=np.int64)
    jstate, jbt, _ = jr.init_generation_state(J_TINY, jpol, batch, 32, block_size=BS)
    tstate, tbt, _ = tr.init_generation_state(T_TINY, tpol, batch, 32, BS, device="cpu")
    key = jax.random.key(0)
    jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jbt, J_TINY, jpol, key)
    tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, T_TINY, tpol)
    jtok, ttok = jnp.argmax(jlogits, axis=-1), torch.argmax(tlogits, dim=-1)
    np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
    jlogits, jstate = jr.decode_step(jparams, jtok, jstate, jbt, J_TINY, jpol, key,
                                     block_size=BS)
    tlogits, tstate = tr.decode_step(tparams, ttok, tstate, tbt, T_TINY, tpol, block_size=BS)
    assert tlogits.shape == (batch, T_TINY.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-3)
    compare_caches(jstate, tstate, "batch 17 > block_size 16", 1e-3)


def test_inactive_rows_above_block_size(weights):
    """F13: a scrubbed decode step (int12-golay, BER 0, pages of 16) at
    batch 19, rows 2, 5 and 11 inactive - block-table row -1, context 0, as
    the server leaves a free slot - against the same step on the 16 live
    rows alone: each live row's logits and its pages (data, parity, scales)
    equal bit for bit, and the inactive rows' tokens land on the trash page
    0, which no live row owns."""
    _, tparams = weights
    _, tpol = policies("int12-golay")
    batch, pages, dead = 19, 3, [2, 5, 11]
    live = [b for b in range(batch) if b not in dead]
    ids = np.random.default_rng(11).integers(0, J_TINY.vocab_size, (batch, PROMPT))

    def step(rows):
        n = len(rows)
        dims = dict(num_blocks=batch * pages + 1, block_size=BS, num_layers=T_TINY.num_layers,
                    num_kv_heads=T_TINY.num_kv_heads, head_dim=T_TINY.head_dim,
                    codec=tpol.codec)
        from qkv_ecc_tpu_torch.cache.layout import ECCCacheConfig, allocate_ecc_kv_cache

        state = allocate_ecc_kv_cache(ECCCacheConfig(**dims), device="cpu")
        # row b's pages are 1 + b * pages ..., the same in both runs
        bt = torch.tensor([[1 + b * pages + i for i in range(pages)] for b in rows],
                          dtype=torch.int32)
        logits, state = tr.prefill(tparams, torch.from_numpy(ids[rows]), state, bt, T_TINY,
                                   tpol)
        ctx = state["context_len"].clone()
        for i, b in enumerate(rows):
            if b in dead:
                bt[i] = -1
                ctx[i] = 0
        state["context_len"] = ctx
        logits, state = tr.decode_step(tparams, torch.argmax(logits, -1), state, bt, T_TINY,
                                       tpol, block_size=BS)
        return logits, state

    full_logits, full = step(list(range(batch)))
    live_logits, alone = step(live)
    assert torch.equal(full_logits[live], live_logits)
    for b in live:
        p = slice(1 + b * pages, 1 + (b + 1) * pages)
        for n in CACHE_NAMES:
            assert torch.equal(full[n][:, p], alone[n][:, p]), (b, n)
    # each inactive row's parity went to its own trash slot of page 0
    assert full["k_parity"][:, 0, :, :, :len(dead)].any()
    assert not alone["k_parity"][:, 0].any()


def test_prefill_logit_pos_true_len(weights):
    """prefill(logit_pos, true_len) against JAX: a bucket-padded prompt
    gives the logits at each row's true last position (rtol 1e-4, atol
    1e-5, as test_slice_matches_jax) and stores true_len as the context
    length; the stored words are equal, pad tail included, and the scales
    within 8 float32 ulps (rtol 9.6e-7: at this 32-token prompt the two
    frameworks' K/V projections differ by up to 5.9e-7 relative)."""
    jparams, tparams = weights
    jpol, tpol = policies("int4-hamming84")
    rng = np.random.default_rng(4)
    ids = rng.integers(0, J_TINY.vocab_size, (B, 32))
    pos = np.asarray([10, 20], np.int32)
    jstate, jbt, _ = jr.init_generation_state(J_TINY, jpol, B, 40, block_size=BS)
    tstate, tbt, _ = tr.init_generation_state(T_TINY, tpol, B, 40, block_size=BS, device="cpu")
    jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jbt, J_TINY, jpol,
                                 jax.random.key(0), logit_pos=jnp.asarray(pos),
                                 true_len=jnp.asarray(pos + 1))
    tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, T_TINY, tpol,
                                 logit_pos=torch.from_numpy(pos),
                                 true_len=torch.from_numpy(pos + 1))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(tstate["context_len"].numpy(), pos + 1)
    compare_caches(jstate, tstate, "prefill", 9.6e-7)
    full, _ = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, T_TINY, tpol)
    assert not torch.equal(full, tlogits)  # the last position's logits differ


def test_unported_paths_raise(weights, gpt2_weights):
    """What stays to come raises: an architecture the port does not know.
    (The name is from before the float arms and gpt2 were ported, when
    fp16, fp8 and gpt2 raised here.) The float arms run:
    init_generation_state, prefill and decode_step of the default
    KVCachePolicy() (fp16) and of fp8 take a step; so does gpt2
    (tiny-gpt2) in int4-write-inject and int4-hamming84, its logits
    finite; a codec outside JAX's FUSED_CODECS raises NotImplementedError,
    as JAX's generate does."""
    _, tparams = weights
    state, bt, _ = tr.init_generation_state(T_TINY, t_policy("int4-write-inject"), B, 40, BS,
                                            device="cpu")
    ids = torch.zeros((B, 4), dtype=torch.long)
    assert tr.FUSED_CODECS == jr.FUSED_CODECS
    for pol in (tr.KVCachePolicy(), t_policy("fp8", ber=1e-2)):
        fstate, fbt, _ = tr.init_generation_state(T_TINY, pol, B, 40, BS, device="cpu")
        g = torch.Generator().manual_seed(0)
        logits, fstate = tr.prefill(tparams, ids, fstate, fbt, T_TINY, pol, g)
        logits, fstate = tr.decode_step(tparams, logits.argmax(-1), fstate, fbt, T_TINY, pol, g,
                                        BS)
        assert logits.shape == (B, T_TINY.vocab_size) and fstate["context_len"].tolist() == [5, 5]
    with pytest.raises(NotImplementedError, match="the runtime supports"):
        tr.prefill(tparams, ids, state, bt, T_TINY, dataclasses.replace(t_policy("fp16"),
                                                                          codec="int3"))
    for mode in ("int4-write-inject", "int4-hamming84"):
        pol = t_policy(mode, ber=1e-2)
        gstate, gbt, _ = tr.init_generation_state(T_GPT2, pol, B, 40, BS, device="cpu")
        g = torch.Generator().manual_seed(0)
        logits, gstate = tr.prefill(gpt2_weights[1], ids, gstate, gbt, T_GPT2, pol, g)
        logits, gstate = tr.decode_step(gpt2_weights[1], logits.argmax(-1), gstate, gbt, T_GPT2,
                                        pol, g, BS)
        assert logits.shape == (B, T_GPT2.vocab_size) and torch.isfinite(logits).all()
        assert gstate["context_len"].tolist() == [5, 5]
    other = dataclasses.replace(T_TINY, arch="mamba")
    with pytest.raises(NotImplementedError, match="mamba"):
        tr.prefill(tparams, ids, state, bt, other, t_policy("int4-write-inject"))
    with pytest.raises(NotImplementedError, match="mamba"):
        tr.decode_loop(tparams, torch.zeros((B, 256)), state, bt, other,
                       t_policy("int4-write-inject"), None, 1)


GPT2_MODES = ["int12-golay", "int4-hamming84", "int4-hamming", "int4-hamming84-interp",
              "int4-write-inject", "int4", "fp16", "fp8", "int4-hamming84-interp/stats"]


@pytest.mark.parametrize("mode", GPT2_MODES)
def test_gpt2_slice_matches_jax(gpt2_weights, mode):
    """gpt2's decode (tiny-gpt2: absolute positions at each row's context
    length, the tied head, group 1) against JAX's runtime in the eight arms
    and a statistics run, as test_slice_matches_jax: stored words and
    counts exact, logits within its tolerances, the same greedy tokens.
    The scales after prefill within 8 float32 ulps (rtol 9.6e-7, as
    test_prefill_logit_pos_true_len): gpt2's combined projection with its
    bias sums in another order in each framework, and its K/V come out up
    to 7.1e-7 relative apart here."""
    run_slice(gpt2_weights, mode, J_GPT2, T_GPT2, 9.6e-7)


@pytest.mark.parametrize("mode", ["int12-golay", "int4-hamming84", "int4-hamming",
                                  "int4-hamming84-interp", "int4-write-inject", "int4", "fp16",
                                  "fp8"])
def test_gpt2_generate_matches_jax(gpt2_weights, mode):
    """generate() on tiny-gpt2 at BER 0 against JAX's generate: the same
    greedy tokens (prompt 21, 3 new)."""
    jparams, tparams = gpt2_weights
    ids = np.random.default_rng(11).integers(0, J_GPT2.vocab_size, (B, PROMPT))
    want = np.asarray(jr.generate(jparams, ids, J_GPT2, j_policy(mode), max_new_tokens=3,
                                  block_size=BS))
    got = tr.generate(tparams, torch.from_numpy(ids), T_GPT2, t_policy(mode), max_new_tokens=3,
                      block_size=BS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_float_generate_matches_jax(weights, mode):
    """generate() of the default KVCachePolicy() (fp16) and of fp8 at BER 0
    against JAX's generate: the same greedy tokens (prompt 21, 6 new)."""
    jparams, tparams = weights
    ids = np.random.default_rng(9).integers(0, J_TINY.vocab_size, (B, PROMPT))
    tpol = tr.KVCachePolicy() if mode == "fp16" else t_policy("fp8")
    jpol = jr.KVCachePolicy() if mode == "fp16" else j_policy("fp8")
    want = np.asarray(jr.generate(jparams, ids, J_TINY, jpol, max_new_tokens=6, block_size=BS))
    got = tr.generate(tparams, torch.from_numpy(ids), T_TINY, tpol, max_new_tokens=6,
                      block_size=BS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_float_write_tokens_matches_jax(mode):
    """The runtime's write of the float codecs (encode_kv, pack_kv and
    _write_tokens, as prefill runs them) against JAX's on the same K/V,
    values past fp8's range and +-inf among them: stored bits equal, the
    scales arrays untouched (zeros)."""
    from qkv_ecc_tpu.models import kv_policy as jkv
    from qkv_ecc_tpu_torch.models import kv_policy as tkv

    rng = np.random.default_rng(10)
    x = (rng.normal(size=(2, B, PROMPT, 2, 16)) * 10.0 ** rng.integers(-2, 3, (2, B, PROMPT, 2, 1))
         ).astype(np.float32)
    x[0, 0, 0, 0, :6] = [500.0, -500.0, 1e4, np.inf, -np.inf, 464.0]
    jpol, tpol = j_policy(mode), t_policy(mode)
    jstate, jbt, _ = jr.init_generation_state(J_TINY, jpol, B, 40, block_size=BS)
    tstate, tbt, _ = tr.init_generation_state(T_TINY, tpol, B, 40, block_size=BS, device="cpu")
    pos = np.broadcast_to(np.arange(PROMPT), (B, PROMPT))
    jk, jv = (jkv.encode_kv(jnp.asarray(a), jpol, None)[0] for a in x)
    (tk, ks, _), (tv, vs, _) = (tkv.encode_kv(torch.from_numpy(a), tpol) for a in x)
    assert ks is None and vs is None
    jstate = jr._write_tokens(jstate, 1, jbt, jnp.asarray(pos), jk, jv, None, None)
    tr._write_tokens(tstate, 1, tbt, torch.from_numpy(pos.copy()), tkv.pack_kv(tk, tpol, 16),
                     tkv.pack_kv(tv, tpol, 16), None, None)
    for n in ("k_cache", "v_cache", "k_scales", "v_scales"):
        np.testing.assert_array_equal(stored_bits(jstate[n]), stored_bits(tstate[n]), err_msg=n)
    assert not tstate["k_scales"].any()


STATS_MODES = ["int12-golay", "int4-hamming", "int4-hamming84", "int4-hamming84-interp", "int4"]


@pytest.mark.parametrize("mode", STATS_MODES)
def test_ecc_stats_add_up(weights, mode):
    """decode_loop(collect_ecc_stats=True) starts the counters at 0 and adds
    each step's counts: equal to decode_step run step by step from the same
    generator, counter by counter after every step (which never decrease and
    rise for the protected codecs at BER 5e-2); generate(return_ecc_stats=
    True) is deterministic per seed and counts the same decode steps."""
    _, tparams = weights
    pol = policies(mode, 5e-2)[1].with_seed(4)
    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (B, PROMPT)))

    def start():
        state, bt, _ = tr.init_generation_state(T_TINY, pol, B, 40, BS, device="cpu")
        g = torch.Generator().manual_seed(6)
        logits, state = tr.prefill(tparams, ids, state, bt, T_TINY, pol, g)
        return logits, state, bt, g

    logits, state, bt, g = start()
    _, loop_state, _ = tr.decode_loop(tparams, logits, state, bt, T_TINY, pol, g, 4,
                                      block_size=BS, collect_ecc_stats=True)
    logits, state, bt, g = start()
    assert "ecc_corrected" not in state
    seen = [torch.zeros(B, dtype=torch.int32)] * 2
    for _ in range(4):
        logits, state = tr.decode_step(tparams, torch.argmax(logits, -1), state, bt, T_TINY,
                                       pol, g, BS, collect_ecc_stats=True)
        now = [state["ecc_corrected"], state["ecc_detected"]]
        assert all(bool((a >= b).all()) for a, b in zip(now, seen))
        seen = now
    for n, want in zip(("ecc_corrected", "ecc_detected"), seen):
        assert torch.equal(loop_state[n], want), n
    assert (seen[0] > 0).all()
    out1, st1 = tr.generate(tparams, ids, T_TINY, pol, max_new_tokens=4, block_size=BS,
                            device="cpu", return_ecc_stats=True)
    out2, st2 = tr.generate(tparams, ids, T_TINY, pol, max_new_tokens=4, block_size=BS,
                            device="cpu", return_ecc_stats=True)
    assert torch.equal(out1, out2) and st1.keys() == {"errors_corrected", "errors_detected"}
    for n in st1:
        assert torch.equal(st1[n], st2[n]) and st1[n].shape == (B,), n
    assert (st1["errors_corrected"] > 0).all()
    assert torch.equal(out1, tr.generate(tparams, ids, T_TINY, pol, max_new_tokens=4,
                                         block_size=BS, device="cpu"))


@pytest.mark.parametrize("llama3", [False, True])
@pytest.mark.parametrize("window", [None, 5])
def test_layers_match_jax(llama3, window):
    """RoPE (with Llama-3.1 scaling), RMSNorm and causal GQA attention with a
    sliding window, on the same inputs: float32, rtol 1e-5 / atol 1e-6 for
    summation order and transcendental ulps."""
    from qkv_ecc_tpu.models import layers as jl
    from qkv_ecc_tpu_torch.models import layers as tl

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 4, 128)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    g = rng.normal(size=(128,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 3000, (2, 9)).astype(np.int32)
    jf = jl.rope_frequencies(128, 500000.0, llama3)
    tf = tl.rope_frequencies(128, 500000.0, llama3)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    close = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tf).numpy(),
        np.asarray(jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf)), **close)
    np.testing.assert_allclose(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)), **close)
    np.testing.assert_allclose(
        tl.causal_attention(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(v), 2,
                            sliding_window=window).numpy(),
        np.asarray(jl.causal_attention(jnp.asarray(x), jnp.asarray(k), jnp.asarray(v), 2,
                                       sliding_window=window)), **close)


def test_jax_positional_decode_loop(weights):
    """F9: JAX's positional call decode_loop(params, logits, state, bt, cfg,
    pol, key, 4, 16) - 16 is block_size - on tiny-llama in int4-hamming84
    (batch 2, prompt 21, pages of 16). At BER 0 the port's call with a
    generator in the key's place stores the words JAX stores, bit for bit
    (scales within the module docstring's decode tolerance), gives its
    tokens and adds no ECC counters (collect_ecc_stats stays off, so scrub
    stays on); at BER 1e-2 the positional call stores the bits of the
    port's keyword call block_size=16 from the same generator seed (the two
    packages draw different masks, so that comparison stays in the port).
    A block_size other than the cache's raises, in decode_loop and
    decode_step; generate takes JAX's positions, sampling's (temperature,
    seed) among them: a sampled call from its seed gives the same tokens
    twice."""
    jparams, tparams = weights
    ids = np.random.default_rng(3).integers(0, J_TINY.vocab_size, (B, PROMPT))
    jpol, tpol = policies("int4-hamming84")
    jstate, jbt, _ = jr.init_generation_state(J_TINY, jpol, B, PROMPT + 8, block_size=BS)
    tstate, tbt, _ = tr.init_generation_state(T_TINY, tpol, B, PROMPT + 8, BS, device="cpu")
    key = jax.random.key(0)
    jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jbt, J_TINY, jpol, key)
    tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, T_TINY, tpol,
                                 torch.Generator().manual_seed(0))
    jlogits, jstate, jtoks = jr.decode_loop(jparams, jlogits, jstate, jbt, J_TINY, jpol, key,
                                            4, 16)
    tlogits, tstate, ttoks = tr.decode_loop(tparams, tlogits, tstate, tbt, T_TINY, tpol,
                                            torch.Generator().manual_seed(1), 4, 16)
    np.testing.assert_array_equal(np.asarray(jtoks), ttoks.numpy())
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-3)
    assert "ecc_corrected" not in tstate and "ecc_corrected" not in jstate
    compare_caches(jstate, tstate, "decode_loop(..., 4, 16)", 1e-3)

    pol = t_policy("int4-hamming84", ber=1e-2)

    def run(**kw):
        state, bt, _ = tr.init_generation_state(T_TINY, pol, B, PROMPT + 8, BS, device="cpu")
        g = torch.Generator().manual_seed(7)
        logits, state = tr.prefill(tparams, torch.from_numpy(ids), state, bt, T_TINY, pol, g)
        args = (tparams, logits, state, bt, T_TINY, pol, g, 4)
        return tr.decode_loop(*args, 16) if not kw else tr.decode_loop(*args, **kw)

    (la, sa, ta), (lb, sb, tb) = run(), run(block_size=16)
    assert torch.equal(la, lb) and torch.equal(ta, tb) and sa.keys() == sb.keys()
    assert "ecc_corrected" not in sa
    for n in CACHE_NAMES:
        assert torch.equal(sa[n], sb[n]), n
    state, bt, _ = tr.init_generation_state(T_TINY, pol, B, PROMPT + 8, BS, device="cpu")
    with pytest.raises(ValueError, match="block_size 128"):
        tr.decode_loop(tparams, la, state, bt, T_TINY, pol, torch.Generator(), 1)
    with pytest.raises(ValueError, match="block_size 32"):
        tr.decode_step(tparams, ta[0], state, bt, T_TINY, pol, torch.Generator(), 32)
    sampled = [tr.generate(tparams, torch.from_numpy(ids), T_TINY, pol, 2, BS, 0.7, 3,
                           device="cpu") for _ in range(2)]
    assert sampled[0].shape == (B, PROMPT + 2) and torch.equal(*sampled)
    out = tr.generate(tparams, torch.from_numpy(ids), T_TINY, pol, 2, BS, 0.0, 5, False,
                      device="cpu")
    assert out.shape == (B, PROMPT + 2)


def test_runtime_signatures_follow_jax():
    """F9: the entry points' parameters in JAX's order - the port's
    generator in the place of JAX's key - with every parameter the port
    adds after them, keyword-only."""
    import inspect

    renamed = {"step_key": "generator", "base_key": "generator"}
    jax_fns = {"prefill": jr.prefill, "decode_step": jr._decode_step_impl,
               "decode_loop": jr.decode_loop, "generate": jr.generate}
    for name, jfn in jax_fns.items():
        jparams = [renamed.get(p, p) for p in inspect.signature(jfn).parameters]
        tsig = inspect.signature(getattr(tr, name)).parameters
        positional = [p for p, v in tsig.items() if v.kind != v.KEYWORD_ONLY]
        extra = [p for p, v in tsig.items() if v.kind == v.KEYWORD_ONLY]
        if name == "decode_step":  # JAX's hoisted_masks is the port's keyword
            jparams.remove("hoisted_masks")
        assert positional == jparams, name
        assert set(extra) <= {"read_masks", "hoisted_masks", "read_inject_seed", "device"}, name
