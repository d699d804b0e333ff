"""The port's decode slice (qkv_ecc_tpu_torch.models.runtime) against the JAX
runtime on tiny-llama with the same weights (params_from_jax), in the five
modes of bench.py and hamming84 without scrub: prefill at BER 0, then decode
steps on the same numpy-made raw masks, passed as hoisted_masks - folded by
each package in the scrubbed modes, raw in the others (BER 1e-2; 5e-2 for
the hamming84 correcting reads, so that doubles reach the interpolation).

Stored words (data nibbles and parity) must be equal after prefill and
after every decode step: none differs on these inputs. They could, because
the two frameworks' float32 matmuls differ by an ulp, and a K/V value on a
quantization boundary would then land on the neighbouring nibble; the test
would report the count.

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

from qkv_ecc_tpu.kernels import swar as js  # noqa: E402
from qkv_ecc_tpu.models import runtime as jr  # noqa: E402
from qkv_ecc_tpu.models.config import TINY_LLAMA as J_TINY  # noqa: E402
from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy  # noqa: E402
from qkv_ecc_tpu.models.registry import init_params as j_init  # noqa: E402
from qkv_ecc_tpu_torch.kernels.paged_attention import paged_attention_ecc_write_attend  # noqa: E402
from qkv_ecc_tpu_torch.kernels.paged_attention import write_decode_attend  # noqa: E402
from qkv_ecc_tpu_torch.kernels import swar  # noqa: E402
from qkv_ecc_tpu_torch.kernels.common import hamming84_decode_i32  # noqa: E402
from qkv_ecc_tpu_torch.models import runtime as tr  # noqa: E402
from qkv_ecc_tpu_torch.models.config import TINY_LLAMA as T_TINY  # noqa: E402
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


def numpy_masks(rng, shape, ber, n_bits):
    flips = rng.random((n_bits,) + tuple(shape)) < ber
    return (flips.astype(np.int64) << np.arange(n_bits).reshape((n_bits,) + (1,) * len(shape))
            ).sum(0).astype(np.int32)


def compare_caches(jstate, tstate, where, scale_rtol):
    """Stored words equal, reporting how many differ; scales within
    scale_rtol (see the module docstring)."""
    words = {n: int((np.asarray(jstate[n]) != tstate[n].numpy()).sum())
             for n in ("k_cache", "v_cache", "k_parity", "v_parity") if n in tstate}
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


def policies(mode, ber=0.0):
    """(JAX policy, port policy) of a bench.py mode, or of NO_SCRUB."""
    base = mode.split("/")[0]
    jpol, tpol = j_policy(base, ber=ber), t_policy(base, ber=ber)
    if mode == NO_SCRUB:
        jpol, tpol = dataclasses.replace(jpol, scrub=False), dataclasses.replace(tpol, scrub=False)
    return jpol, tpol


@pytest.mark.parametrize("mode", ["int4-write-inject", "int12-golay", "int4-hamming",
                                  "int4-hamming84", "int4-hamming84-interp", NO_SCRUB])
def test_slice_matches_jax(weights, mode):
    jparams, tparams = weights
    jpol0, tpol0 = policies(mode)
    codec = tpol0.codec
    scrubbed = mode != NO_SCRUB and not tpol0.use_interpolation
    ber = 1e-2 if scrubbed else 5e-2
    rng = np.random.default_rng(0)
    ids = rng.integers(0, J_TINY.vocab_size, (B, PROMPT))
    T = PROMPT + STEPS + 2

    jstate, jbt, _ = jr.init_generation_state(J_TINY, jpol0, B, T, block_size=BS)
    tstate, tbt, _ = tr.init_generation_state(T_TINY, tpol0, B, T, block_size=BS, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbt), tbt.numpy())
    key = jax.random.key(7)
    jlogits, jstate = jr.prefill(jparams, jnp.asarray(ids), jstate, jbt, J_TINY, jpol0, key)
    tlogits, tstate = tr.prefill(tparams, torch.from_numpy(ids), tstate, tbt, T_TINY, tpol0)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-5)
    compare_caches(jstate, tstate, "prefill", 4.8e-7)

    jpol, tpol = policies(mode, ber)
    shape = tr.write_mask_shape(tpol, B, T_TINY)
    assert shape == jr._write_mask_shape(jpol, B, J_TINY)
    launches = paged_attention_ecc_write_attend.launches, write_decode_attend.launches
    for step in range(STEPS):
        raw = numpy_masks(rng, (T_TINY.num_layers, 2) + shape, ber, N_BITS[codec])
        if scrubbed:
            jh = js.scrub_fold_mask(codec, jnp.asarray(raw)).astype(jnp.uint8)
            th = hoisted_write_deltas(tpol, T_TINY.num_layers, shape,
                                      raw_masks=torch.from_numpy(raw))
            np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        else:  # raw logical masks, XORed into the codewords
            jh, th = jnp.asarray(raw.astype(np.uint8)), torch.from_numpy(raw.astype(np.uint8))
        jtok, ttok = jnp.argmax(jlogits, axis=-1), torch.argmax(tlogits, dim=-1)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy(), err_msg=f"step {step}")
        jlogits, jstate = jr.decode_step(jparams, jtok, jstate, jbt, J_TINY, jpol,
                                         jax.random.fold_in(key, step), block_size=BS,
                                         hoisted_masks=jh)
        tlogits, tstate = tr.decode_step(tparams, ttok, tstate, tbt, T_TINY, tpol,
                                         hoisted_masks=th)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-3,
                                   err_msg=f"step {step}")
        compare_caches(jstate, tstate, f"step {step}", 1e-3)
    np.testing.assert_array_equal(np.asarray(jstate["context_len"]), tstate["context_len"].numpy())
    # the CPU path never launches
    assert (paged_attention_ecc_write_attend.launches, write_decode_attend.launches) == launches
    if not scrubbed:  # the cache holds doubles, which the correcting read decoded
        rows = torch.cat([tstate["k_cache"], tstate["k_parity"]], dim=3).movedim(3, -1)
        _, et = hamming84_decode_i32(swar.unpack_codewords("hamming84", rows, 16))
        assert int((et == 2).sum()) > 0


@pytest.mark.parametrize("mode", ["int4-write-inject", "int12-golay", "int4-hamming",
                                  "int4-hamming84", "int4-hamming84-interp", NO_SCRUB])
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
            return tr.decode_loop(tparams, logits, state, bt, T_TINY, pol, g, 4)
        toks = []
        for _ in range(4):
            toks.append(torch.argmax(logits, -1))
            logits, state = tr.decode_step(tparams, toks[-1], state, bt, T_TINY, pol, g)
        return logits, state, torch.stack(toks)

    a, b = run(True), run(False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
    for n in CACHE_NAMES:
        if n in a[1]:
            assert torch.equal(a[1][n], b[1][n]), n


def test_negative_page_raises(weights):
    _, tparams = weights
    pol = t_policy("int12-golay", ber=1e-2)
    state, bt, _ = tr.init_generation_state(T_TINY, pol, B, 40, BS, device="cpu")
    g = torch.Generator().manual_seed(0)
    logits, state = tr.prefill(tparams, torch.zeros((B, 4), dtype=torch.long), state, bt,
                               T_TINY, pol, g)
    bt[1] = -1  # an inactive slot, as serving will have
    before = {n: state[n].clone() for n in CACHE_NAMES}
    with pytest.raises(ValueError, match="no page"):
        tr.decode_step(tparams, torch.argmax(logits, -1), state, bt, T_TINY, pol, g)
    for n in CACHE_NAMES:
        assert torch.equal(before[n], state[n]), n


def test_unported_paths_raise(weights):
    """What stays to come: int4 read-time injection (K2r), the golay and
    hamming74 correcting reads and per-read statistics (K2)."""
    _, tparams = weights
    state, bt, _ = tr.init_generation_state(T_TINY, t_policy("int4-write-inject"), B, 40, BS,
                                            device="cpu")
    ids = torch.zeros((B, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="K2r"):
        tr.prefill(tparams, ids, state, bt, T_TINY, t_policy("int4", ber=1e-2))
    for mode in ("int12-golay", "int4-hamming"):
        pol = dataclasses.replace(t_policy(mode, ber=1e-2), scrub=False)
        with pytest.raises(NotImplementedError, match="K2"):
            tr.prefill(tparams, ids, state, bt, T_TINY, pol)
    pol = t_policy("int4-hamming84-interp", ber=1e-2)
    with pytest.raises(NotImplementedError, match="K2"):
        tr.decode_step(tparams, ids[:, 0], state, bt, T_TINY, pol, collect_ecc_stats=True)


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
