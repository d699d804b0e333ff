"""The port's span recorder (qkv_ecc_tpu_torch.tracing) and its spans in
models/runtime.py, on the CPU, with the port's own tiny gpt2 and tiny llama
(random weights; nothing here is compared with the JAX package):

  * off, ``span`` is one shared no-op, and prefill and decode_step read no
    clock, make no CUDA event and leave the recorder empty;
  * on, the spans of prefill and of each decode step come in the runtime's
    order, the per-layer ones once a layer, and no two overlap (they are
    leaves), in a scrubbed mode and in golay with ECC statistics;
  * tracing changes no bit of the logits or of the state;
  * ``drain`` empties the recorder, and ``disable`` keeps what was recorded;
  * the server keeps its ECC totals on the device, with no host read a step.
"""

import time

import numpy as np
import pytest
import torch

from qkv_ecc_tpu_torch import tracing
from qkv_ecc_tpu_torch.models import runtime
from qkv_ecc_tpu_torch.models.config import TINY_DEEPSEEK_V2, TINY_GPT2, TINY_LLAMA
from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode
from qkv_ecc_tpu_torch.models.registry import init_params
from qkv_ecc_tpu_torch.serving import ContinuousBatchingServer, Request

torch.set_num_threads(1)
B, PROMPT, STEPS, BS = 2, 19, 3, 16
CFGS = {"gpt2": TINY_GPT2, "llama": TINY_LLAMA}
# (mode, collect_ecc_stats): hamming84 scrubbed (the extract read and the
# parity scatter) and golay counting its corrections (the correcting read)
ARMS = [("int4-hamming84", False), ("int12-golay", True)]

PREFILL_LAYER = ["prefill.qkv", "prefill.write", "prefill.codec_read", "prefill.attention",
                 "prefill.out_mlp"]
DECODE_LAYER = ["decode.qkv", "decode.write_chain", "decode.attend", "decode.out_mlp"]


def prefill_names(layers):
    return ["prefill.embed"] + PREFILL_LAYER * layers + ["prefill.lm_head"]


def decode_names(layers):
    return (["decode.masks", "decode.embed"] + DECODE_LAYER * layers
            + ["decode.parity_scatter", "decode.ecc_counts", "decode.lm_head"])


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def params():
    return {arch: init_params(cfg, seed=0, device="cpu") for arch, cfg in CFGS.items()}


def run(params, cfg, mode, stats):
    """Prefill a seeded prompt, then STEPS greedy decode steps at BER 1e-2:
    (every logits tensor, the final state)."""
    pol = policy_for_mode(mode, ber=1e-2, seed=7)
    state, table, _ = runtime.init_generation_state(cfg, pol, B, PROMPT + STEPS, BS,
                                                    device="cpu")
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=torch.Generator().manual_seed(3))
    logits, state = runtime.prefill(params, ids, state, table, cfg, pol, gen)
    out = [logits]
    for _ in range(STEPS):
        logits, state = runtime.decode_step(params, torch.argmax(logits, dim=-1), state, table,
                                            cfg, pol, gen, BS, stats)
        out.append(logits)
    return out, state


def test_off_span_is_one_shared_noop():
    a, b = tracing.span("decode.qkv"), tracing.span("prefill.write")
    assert a is b
    with a as entered:
        assert entered is a
    assert tracing.drain() == []


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_off_reads_no_clock_and_makes_no_event(params, arch, monkeypatch):
    """A run with tracing off calls nothing of the recorder past its off
    check: no span object, no clock read, no CUDA event."""
    def refuse(*a, **k):
        raise AssertionError("tracing code ran while tracing was off")

    class NoClock:
        perf_counter_ns = staticmethod(refuse)

    monkeypatch.setattr(tracing, "_Span", refuse)
    monkeypatch.setattr(tracing, "_event", refuse)
    monkeypatch.setattr(tracing, "time", NoClock)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    run(params[arch], CFGS[arch], "int12-golay", True)
    assert tracing.drain() == []


@pytest.mark.parametrize("mode,stats", ARMS)
@pytest.mark.parametrize("arch", sorted(CFGS))
def test_spans_order_and_leaves(params, arch, mode, stats):
    cfg = CFGS[arch]
    tracing.enable(device_events=True)  # no card here: host times alone
    run(params[arch], cfg, mode, stats)
    spans = tracing.drain()
    names = [s[0] for s in spans]
    assert names == prefill_names(cfg.num_layers) + decode_names(cfg.num_layers) * STEPS
    assert all(dev is None for *_, dev in spans)
    assert all(t0 <= t1 for _, t0, t1, _ in spans)
    for (_, _, end, _), (name, start, _, _) in zip(spans, spans[1:]):
        assert start >= end, f"{name} opens before the span ahead of it closes"


@pytest.mark.parametrize("mode,stats", ARMS)
@pytest.mark.parametrize("arch", sorted(CFGS))
def test_tracing_changes_no_bit(params, arch, mode, stats):
    off_logits, off_state = run(params[arch], CFGS[arch], mode, stats)
    tracing.enable()
    on_logits, on_state = run(params[arch], CFGS[arch], mode, stats)
    assert len(tracing.drain()) > 0
    for a, b in zip(off_logits, on_logits):
        assert torch.equal(a, b)
    assert sorted(off_state) == sorted(on_state)
    if stats:
        assert "ecc_corrected" in on_state and "ecc_detected" in on_state
    for name in off_state:
        assert torch.equal(off_state[name], on_state[name]), name


def test_drain_empties_and_disable_keeps():
    tracing.enable()
    with tracing.span("a"):
        pass
    tracing.disable()
    with tracing.span("b"):  # off: not recorded
        pass
    first = tracing.drain()
    assert [s[0] for s in first] == ["a"]
    assert tracing.drain() == []
    tracing.enable()
    with tracing.span("c"):
        pass
    assert [s[0] for s in tracing.drain()] == ["c"]
    assert tracing.drain() == []


def test_server_keeps_ecc_counts_on_the_device(params, monkeypatch):
    """The server adds each decode step's counts into a device tensor with
    no host read, and ``ecc_stats`` reads the totals as ints when asked."""
    server = ContinuousBatchingServer(params["llama"], TINY_LLAMA,
                                      policy_for_mode("int12-golay", ber=1e-2, seed=5),
                                      max_batch=2, max_seq_len=64, block_size=BS,
                                      prefill_bucket=16, device="cpu")
    for r in range(2):
        server.add_request(Request(request_id=r, prompt_ids=np.arange(3, 12 + r),
                                   max_new_tokens=4))
    want = [0, 0]
    harvest = server._harvest_ecc

    def counted():
        want[0] += int(server.state["ecc_corrected"].sum())
        want[1] += int(server.state["ecc_detected"].sum())
        with monkeypatch.context() as m:
            for name in ("__int__", "__index__", "__bool__", "item", "tolist", "cpu", "numpy"):
                m.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail("host read"))
            harvest()

    server._harvest_ecc = counted
    server.run()
    assert want[0] > 0
    stats = server.ecc_stats
    assert stats == {"errors_corrected": want[0], "errors_detected": want[1]}
    assert all(type(v) is int for v in stats.values())


# DeepSeek-V2 (the latent read, the expert layer): its leaves per layer, the
# expert layer's after out_mlp in every MoE layer
DS_PREFILL_LAYER = ["prefill.qkv", "prefill.write", "prefill.codec_read", "prefill.attention",
                    "prefill.out_mlp"]
DS_DECODE_LAYER = ["decode.qkv", "decode.absorb", "decode.write_chain", "decode.attend",
                   "decode.out_mlp"]


def ds_names(phase_layer, moe_prefix, cfg):
    out = []
    for i in range(cfg.num_layers):
        out += phase_layer
        if i >= cfg.first_k_dense_replace:
            out += [f"{moe_prefix}.moe_route", f"{moe_prefix}.moe_experts",
                    f"{moe_prefix}.moe_shared"]
    return out


@pytest.fixture(scope="module")
def ds_params():
    return init_params(TINY_DEEPSEEK_V2, seed=0, device="cpu")


@pytest.mark.parametrize("mode,stats", ARMS[1:] + [("int12-golay", False)])
def test_deepseek_spans_are_leaves_in_order(ds_params, mode, stats):
    """The latent model's prefill and decode leaves in the runtime's order,
    none opening before the one ahead closes, so that summed they stay
    within the step; the expert counter adds B * num_experts_per_tok tokens
    a MoE layer and step (and the prompt's tokens in prefill)."""
    cfg = TINY_DEEPSEEK_V2
    tracing.enable(device_events=True)
    t0 = time.perf_counter_ns()
    run(ds_params, cfg, mode, stats)
    t1 = time.perf_counter_ns()
    spans = tracing.drain()
    counts = tracing.drain_counts()
    names = [s[0] for s in spans]
    prefill = (["prefill.embed"] + ds_names(DS_PREFILL_LAYER, "prefill", cfg)
               + ["prefill.lm_head"])
    decode = (["decode.masks", "decode.embed"] + ds_names(DS_DECODE_LAYER, "decode", cfg)
              + ["decode.parity_scatter", "decode.lm_head", "decode.ecc_counts"])
    assert names == prefill + decode * STEPS
    for (_, _, end, _), (name, start, _, _) in zip(spans, spans[1:]):
        assert start >= end, f"{name} opens before the span ahead of it closes"
    assert sum(e - s for _, s, e, _ in spans) <= t1 - t0
    k = cfg.num_experts_per_tok
    moe = range(cfg.first_k_dense_replace, cfg.num_layers)
    assert sorted(counts) == sorted([f"decode.moe_tokens.{i}" for i in moe]
                                    + [f"prefill.moe_tokens.{i}" for i in moe])
    for i in moe:
        assert int(counts[f"decode.moe_tokens.{i}"].sum()) == B * k * STEPS
        assert int(counts[f"prefill.moe_tokens.{i}"].sum()) == B * PROMPT * k
        assert counts[f"decode.moe_tokens.{i}"].shape == (cfg.n_routed_experts,)


def test_deepseek_counter_off_and_no_bit_changed(ds_params, monkeypatch):
    """Off, the counter is not touched and nothing is recorded; on, no
    logit or cache word changes."""
    cfg = TINY_DEEPSEEK_V2
    off_logits, off_state = run(ds_params, cfg, "int12-golay", True)
    assert tracing.drain_counts() == {}
    tracing.enable()
    on_logits, on_state = run(ds_params, cfg, "int12-golay", True)
    assert len(tracing.drain_counts()) == 2 * (cfg.num_layers - cfg.first_k_dense_replace)
    for a, b in zip(off_logits, on_logits):
        assert torch.equal(a, b)
    for name in off_state:
        assert torch.equal(off_state[name], on_state[name]), name
