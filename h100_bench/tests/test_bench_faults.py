"""The check sees a broken timed path: a run with the decode step broken
underneath comes out not correct, once for each fault a served cell can
have (on one chip there is no exchange between chips, and a decode batch
takes no mean over its rows)."""

import pytest
import torch

from h100_bench.tests import tiny
from qkv_ecc_tpu_torch.models import runtime

torch.set_num_threads(1)
CASES = [(tiny.TINY_LLAMA, "int4-hamming84-interp", False), (tiny.TINY_GPT2, "int12-golay", True),
         (tiny.TINY_LLAMA, "int4-hamming84", False)]
IDS = [f"{c['port_model']}-{m}" for c, m, _ in CASES]


def unchanged_state(params, tokens, state, *args, **kw):
    """A step that computes its logits on a copy and returns the state it
    was given, unchanged."""
    copy = {k: v.clone() for k, v in state.items()}
    logits, _ = runtime.decode_step(params, tokens, copy, *args, **kw)
    return logits, state


def altered_token(params, tokens, state, *args, **kw):
    """A step whose logits put another token first in one row."""
    logits, state = runtime.decode_step(params, tokens, state, *args, **kw)
    logits = logits.clone()
    row = int(state["context_len"][0]) % logits.shape[0]
    logits[row, (logits[row].argmax() + 1) % logits.shape[1]] = logits[row].max() + 1.0
    return logits, state


@pytest.mark.parametrize("config,mode,stats", CASES, ids=IDS)
def test_sound_run_is_correct(config, mode, stats):
    assert tiny.run(config, tiny.traffic(mode, stats))[2]


@pytest.mark.parametrize("config,mode,stats", CASES, ids=IDS)
@pytest.mark.parametrize("fault", [unchanged_state, altered_token])
def test_fault_is_not_correct(config, mode, stats, fault):
    out, nums, correct = tiny.run(config, tiny.traffic(mode, stats),
                                  hooks={"decode_step": fault})
    assert not correct, nums
