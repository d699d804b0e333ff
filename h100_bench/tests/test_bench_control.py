"""The control comes out not correct: the reference put in the program's
place at the next precision below the configuration's.

On the CPU at a size a test run holds (a bfloat16 llama of hidden 256 over
4 layers, 300-400-token prompts, its fp8 control), with limits set between
the program's readings and the control's at this size, as the cells'
limits are at theirs (PERF.md). TF32 moves nothing at that size, so the
float32 cell's control is held on the card, at the cell's own size."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100_bench.core import check, spec
from h100_bench.tests import tiny

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[2]


def test_fp8_control_fails_where_the_bfloat16_program_passes():
    config = tiny.register_mid_llama("bfloat16")
    limits = {"logit_gap_mean": 6e-4, "far_value_pct": 0.05, "bad_codewords": 0}
    tf = tiny.traffic("int4-hamming84-interp", batch=3, prompt_min=300, prompt_max=400,
                      prefill_tokens_sq=3 * 400 * 400, new_tokens=16, check_rows=3,
                      limits=limits)
    out, nums, correct = tiny.run(config, tf, control=True)
    control = nums.pop("control")
    assert correct, nums
    assert not check.verdict(dict(nums, **control), limits, 0)[0], control


@pytest.mark.card
def test_tf32_control_fails_the_gpt2_cell(card):
    cell = "gpt2-golay-counts-1k"
    done = subprocess.run([sys.executable, str(ROOT / "h100_bench" / "control.py"),
                           "--workload", cell, "--seeds", "5100000001"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    reading = json.loads(done.stdout.strip().splitlines()[-1])
    limits = spec.load_cell(cell, ROOT).traffic["limits"]
    assert check.verdict(reading["program"], limits, 0)[0], reading
    assert not check.verdict(dict(reading["program"], **reading["control"]), limits, 0)[0], reading
