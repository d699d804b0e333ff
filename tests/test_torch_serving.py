"""The port's continuous-batching server (qkv_ecc_tpu_torch.serving) on
tiny-llama on the CPU: staggered admission reproduces isolated generation
exactly (greedy, BER 0), pages are recycled, oversized requests are
refused, generation pages are reserved at admission, sampling is
deterministic per seed, and one run gives the JAX server's tokens.

These run in the tier-1 suite, at the sizes of the JAX package's own
(slow-marked) tests/test_serving.py: max_batch 3, block 16, max_seq_len 96.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.models.config import TINY_LLAMA as J_TINY  # noqa: E402
from qkv_ecc_tpu.models.kv_policy import policy_for_mode as j_policy  # noqa: E402
from qkv_ecc_tpu.models.registry import init_params as j_init  # noqa: E402
from qkv_ecc_tpu.serving import ContinuousBatchingServer as JServer  # noqa: E402
from qkv_ecc_tpu.serving import Request as JRequest  # noqa: E402
from qkv_ecc_tpu_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_ecc_write_attend, write_decode_attend)
from qkv_ecc_tpu_torch.models.config import TINY_LLAMA as CFG  # noqa: E402
from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode  # noqa: E402
from qkv_ecc_tpu_torch.models.llama import params_from_jax  # noqa: E402
from qkv_ecc_tpu_torch.models.runtime import generate  # noqa: E402
from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def weights():
    jparams = j_init(J_TINY, 0)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams), CFG, device="cpu")


def make_server(params, mode="int4-hamming84", ber=0.0, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("block_size", 16)
    return ContinuousBatchingServer(params, CFG, policy_for_mode(mode, ber=ber, seed=42),
                                    device="cpu", **kw)


def isolated(params, prompt, new, mode="int4-hamming84"):
    out = generate(params, torch.from_numpy(prompt)[None], CFG,
                   policy_for_mode(mode, ber=0.0, seed=42), max_new_tokens=new, block_size=16,
                   device="cpu")
    return out[0, len(prompt):].tolist()


def test_staggered_batching_matches_isolated_generation(weights):
    """Three requests admitted at different times (mixed batches, an
    inactive slot decoding into the trash page) give exactly the tokens of
    generate() on each prompt alone."""
    params = weights[1]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)) for n in (7, 13, 5)]
    expected = [isolated(params, p, 6) for p in prompts]
    server = make_server(params)
    server.add_request(Request(0, prompts[0], max_new_tokens=6))
    server.add_request(Request(1, prompts[1], max_new_tokens=6))
    server.step()  # admits both, decodes one step with slot 2 inactive
    assert server.num_active == 2
    server.add_request(Request(2, prompts[2], max_new_tokens=6))
    outs = server.run()
    assert len(outs) == 3
    by_id = {o.request_id: o for o in outs}
    for i in range(3):
        assert by_id[i].token_ids == expected[i], f"request {i} diverged"
        assert by_id[i].finish_reason == "length"
    # the CPU never launches a kernel
    assert paged_attention_ecc_write_attend.launches == write_decode_attend.launches == 0


def test_pages_recycled_and_more_requests_than_slots(weights):
    """Five requests through two slots all finish with their lengths, and
    every page returns to the pool (the trash page stays allocated)."""
    params = weights[1]
    rng = np.random.default_rng(1)
    server = make_server(params, max_batch=2, max_seq_len=64)
    free0 = server.manager.num_free_blocks
    assert free0 == server.manager.num_blocks - 1
    for i in range(5):
        server.add_request(Request(i, rng.integers(0, CFG.vocab_size, (4 + i,)),
                                   max_new_tokens=3 + i % 2))
    outs = server.run()
    assert sorted(o.request_id for o in outs) == list(range(5))
    assert all(len(o.token_ids) == 3 + o.request_id % 2 for o in outs)
    assert server.manager.num_free_blocks == free0 and not server.has_work


def test_eos_stops_early(weights):
    params = weights[1]
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, (8,))
    second = isolated(params, prompt, 8)[1]  # the second generated token
    server = make_server(params)
    server.add_request(Request(0, prompt, max_new_tokens=8, eos_token_id=second))
    out = server.run()[0]
    assert out.finish_reason == "eos" and out.token_ids[-1] == second
    assert len(out.token_ids) <= 8


def test_per_request_temperature_sampling(weights):
    """A temperature row samples, deterministically per server seed, while a
    temperature-0 row in the same batch stays greedy."""
    params = weights[1]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab_size, (6,)) for _ in range(2)]
    greedy = isolated(params, prompts[0], 5, mode="int4")

    def serve():
        server = make_server(params, mode="int4")
        server.add_request(Request(0, prompts[0], max_new_tokens=5))
        server.add_request(Request(1, prompts[1], max_new_tokens=5, temperature=1.5))
        return {o.request_id: o.token_ids for o in server.run()}

    a, b = serve(), serve()
    assert a[0] == greedy and len(a[1]) == 5
    assert a[1] == b[1]
    assert a[1] != isolated(params, prompts[1], 5, mode="int4")  # it did sample


def test_oversized_request_rejected(weights):
    params = weights[1]
    rng = np.random.default_rng(4)
    server = make_server(params, max_seq_len=64)
    with pytest.raises(ValueError, match="max_seq_len"):
        server.add_request(Request(0, rng.integers(0, CFG.vocab_size, (60,)), max_new_tokens=10))
    small = make_server(params, max_seq_len=64, num_blocks=3)
    with pytest.raises(ValueError, match="allocatable blocks"):
        small.add_request(Request(1, rng.integers(0, CFG.vocab_size, (40,)), max_new_tokens=1))
    with pytest.raises(NotImplementedError, match="the runtime supports"):
        ContinuousBatchingServer(params, CFG, dataclasses.replace(policy_for_mode("fp16"),
                                                                  codec="int3"), device="cpu")


def test_admission_reserves_generation_pages(weights):
    """Admission reserves prompt + max_new pages up front: two requests of 2
    pages each on a pool of 3 allocatable blocks run one after the other."""
    params = weights[1]
    rng = np.random.default_rng(5)
    server = make_server(params, max_batch=2, max_seq_len=48, num_blocks=4, prefill_bucket=16)
    for i in range(2):
        server.add_request(Request(i, rng.integers(0, CFG.vocab_size, (17,)), max_new_tokens=15))
    server.step()
    assert server.num_active == 1 and len(server.waiting) == 1
    assert server.manager.num_free_blocks == 1
    outs = server.run()
    assert sorted(o.request_id for o in outs) == [0, 1]
    assert all(len(o.token_ids) == 15 for o in outs)


def test_bucketed_prefill_and_fault_injection(weights):
    """A prompt padded to a 64-token bucket gives generate()'s tokens (BER
    0); under golay at BER 1e-2 three requests finish with their lengths and
    the decode reads count corrections."""
    params = weights[1]
    rng = np.random.default_rng(6)
    p = rng.integers(0, CFG.vocab_size, (11,))
    server = make_server(params, prefill_bucket=64)
    server.add_request(Request(0, p, max_new_tokens=5))
    assert server.run()[0].token_ids == isolated(params, p, 5)
    noisy = make_server(params, mode="int12-golay", ber=1e-2)
    for i in range(3):
        noisy.add_request(Request(i, rng.integers(0, CFG.vocab_size, (6,)), max_new_tokens=5))
    outs = noisy.run()
    assert len(outs) == 3 and all(len(o.token_ids) == 5 for o in outs)
    assert noisy.ecc_stats["errors_corrected"] > 0


def test_server_matches_jax(weights):
    """One served stream on the JAX server and on the port's, same weights,
    int4-hamming84 at BER 0, max_batch 3, block 16, staggered admission of
    three requests of 6 new tokens: identical tokens and finish reasons, and
    equal ECC counters (0 at BER 0)."""
    jparams, tparams = weights
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)) for n in (9, 14, 5)]
    jserver = JServer(jparams, J_TINY, j_policy("int4-hamming84", ber=0.0, seed=42),
                      max_batch=3, max_seq_len=96, block_size=16, prefill_bucket=32)
    tserver = make_server(tparams, prefill_bucket=32)
    outs = []
    for server, req in ((jserver, JRequest), (tserver, Request)):
        server.add_request(req(0, prompts[0], max_new_tokens=6))
        server.add_request(req(1, prompts[1], max_new_tokens=6))
        server.step()
        server.add_request(req(2, prompts[2], max_new_tokens=6))
        outs.append({o.request_id: ([int(t) for t in o.token_ids], o.finish_reason)
                     for o in server.run()})
    assert outs[0] == outs[1]
    assert tserver.ecc_stats == jserver.ecc_stats


@pytest.mark.parametrize("mode", ["fp16", "fp8"])
def test_float_server_matches_jax(weights, mode):
    """The float arms served: fp16 (the default codec) and fp8 at BER 0, the
    same stream as test_server_matches_jax on both servers: identical tokens
    and finish reasons; a float read counts no ECC errors."""
    jparams, tparams = weights
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, CFG.vocab_size, (n,)) for n in (9, 14, 5)]
    jserver = JServer(jparams, J_TINY, j_policy(mode, ber=0.0, seed=42), max_batch=3,
                      max_seq_len=96, block_size=16, prefill_bucket=32)
    tserver = make_server(tparams, mode=mode, prefill_bucket=32)
    outs = []
    for server, req in ((jserver, JRequest), (tserver, Request)):
        server.add_request(req(0, prompts[0], max_new_tokens=6))
        server.add_request(req(1, prompts[1], max_new_tokens=6))
        server.step()
        server.add_request(req(2, prompts[2], max_new_tokens=6))
        outs.append({o.request_id: ([int(t) for t in o.token_ids], o.finish_reason)
                     for o in server.run()})
    assert outs[0] == outs[1]
    assert tserver.ecc_stats == jserver.ecc_stats == {"errors_corrected": 0,
                                                       "errors_detected": 0}


def test_request_dataclasses_match_jax():
    from qkv_ecc_tpu.serving import RequestOutput as JOut
    from qkv_ecc_tpu_torch.serving import RequestOutput as TOut

    for j, t in ((JRequest, Request), (JOut, TOut)):
        jf = [(f.name, f.default) for f in dataclasses.fields(j)]
        tf = [(f.name, f.default) for f in dataclasses.fields(t)]
        assert jf == tf
