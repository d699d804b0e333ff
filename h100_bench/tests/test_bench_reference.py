"""The reference against the port's plain path: each arm on tiny-llama and
tiny-gpt2, driven through the harness's window on the CPU (where the port's
kernels run their plain PyTorch versions, float32): every served token is
the reference's best, every stored word holds the flips the reference
draws again, and the ECC counters are the reference's counts."""

import pytest
import torch

from h100_bench.reference import codecs as cd
from h100_bench.tests import tiny

torch.set_num_threads(1)

ARMS = [
    (tiny.TINY_LLAMA, "int4-hamming84-interp", False),
    (tiny.TINY_LLAMA, "int4-hamming84", False),
    (tiny.TINY_LLAMA, "int4-hamming84", True),
    (tiny.TINY_LLAMA, "int4-write-inject", False),
    (tiny.TINY_GPT2, "int12-golay", True),
    (tiny.TINY_GPT2, "int12-golay", False),
    (tiny.TINY_GPT2, "int4-hamming84-interp", False),
]


@pytest.mark.parametrize("config,mode,stats", ARMS,
                         ids=[f"{c['port_model']}-{m}-{'counts' if s else 'plain'}"
                              for c, m, s in ARMS])
def test_reference_holds_the_port(config, mode, stats):
    out, nums, correct = tiny.run(config, tiny.traffic(mode, stats))
    assert out.served.rounds >= 2
    assert nums["logit_gap"] == 0.0
    assert nums["bad_codewords"] == 0
    assert nums["far_value_pct"] == 0.0
    if stats:
        assert nums["ecc_count_diff"] == 0
        assert sum(c + d for c, d in out.served.counts.values()) > 0
    assert correct


def test_chunk_seams_are_the_port_s():
    """Contexts past 512 tokens put a seam of the interpolation's chunks
    (512 tokens of pages) inside the read."""
    config = tiny.register_mid_llama("float32")
    tf = tiny.traffic("int4-hamming84-interp", batch=2, prompt_min=505, prompt_max=530,
                      prefill_tokens_sq=2 * 530 * 530, new_tokens=12, check_rows=2)
    out, nums, correct = tiny.run(config, tf)
    assert out.served.chunk_tokens == 512
    assert nums["logit_gap"] == 0.0 and nums["bad_codewords"] == 0 and correct


def test_golay_table_from_definition():
    """The reference's Golay code: distance 8 (every nonzero codeword of
    weight >= 8), and its table corrects each pattern of weight <= 3."""
    parity, leader = cd.golay_tables("cpu")
    d = torch.arange(1, 4096, dtype=torch.int32)
    cw = d | parity[d.long()] << 12
    weight = sum(((cw >> b) & 1) for b in range(24))
    assert int(weight.min()) == 8
    assert int((leader >= 0).sum()) == 2325


def test_hamming_tables_from_definition():
    """SECDED: every single flip of a codeword is corrected, every double
    is detected."""
    delta, klass, _, _ = cd.hamming_tables("cpu")
    for i in range(8):
        assert int(delta[1 << i]) == 0 and int(klass[1 << i]) in (1, 3)
        for j in range(i + 1, 8):
            assert int(klass[(1 << i) | (1 << j)]) == 2
