"""Tiny cells for the CPU tests: the port's tiny-llama and tiny-gpt2 (and a
mid-sized llama registered for the control test) under the cell's traffic
generator, window and check, on the CPU."""

from __future__ import annotations

import dataclasses
import time

from h100_bench.core import check, spec
from h100_bench.core.session import run_cell

TINY_LLAMA = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
              "intermediate_size": 128, "num_hidden_layers": 2, "rms_norm_eps": 1e-5,
              "rope_theta": 10000.0, "tie_word_embeddings": False, "sliding_window": None,
              "vocab_size": 256, "torch_dtype": "float32", "port_model": "tiny-llama",
              "reference": "llama"}
TINY_GPT2 = {"n_embd": 64, "n_head": 4, "n_layer": 2, "n_positions": 128,
             "layer_norm_epsilon": 1e-5, "vocab_size": 256, "n_inner": 128,
             "torch_dtype": "float32", "port_model": "tiny-gpt2", "reference": "gpt2"}
LIMITS = {"logit_gap_mean": 1e-3, "far_value_pct": 1e-3, "bad_codewords": 0}


def traffic(mode, stats=False, **kw):
    t = {"mode": mode, "ber": 0.01, "page": 16, "collect_ecc_stats": stats,
         "batch": 5, "prompt_min": 20, "prompt_max": 40, "new_tokens": 6,
         "prefill_tokens_sq": 2 * 40 * 40, "prefill_rows_max": 4, "trace_steps": 2,
         "check_rows": 3, "limits": dict(LIMITS, **({"ecc_count_diff": 0} if stats else {}))}
    t.update(kw)
    return t


def cell(config, tf):
    return spec.Cell("tiny", 1, "tiny", config, "tiny", tf, [], [])


def run(config, tf, seed=20260101, hooks=None, seconds=0.2, control=False):
    """(outcome, numbers, correct) of one CPU run of a tiny cell."""
    out = run_cell(cell(config, tf), seed, seconds, False, "cpu", time.perf_counter(),
                   hooks=hooks)
    nums = check.numbers(out.served, with_control=control)
    correct, _ = check.verdict(nums, tf["limits"], out.failed)
    return out, nums, correct


def register_mid_llama(dtype: str) -> dict:
    """A llama of hidden 256 over 4 layers in ``dtype``, registered with the
    port's configs; returns its configuration file."""
    from qkv_ecc_tpu_torch.models import config as C

    name = f"bench-test-llama-{dtype}"
    C.MODEL_CONFIGS[name] = dataclasses.replace(
        C.get_model_config("tiny-llama"), name=name, hidden_size=256, num_layers=4, num_heads=8,
        num_kv_heads=2, head_dim=32, intermediate_size=512, vocab_size=1024,
        max_position_embeddings=1024, rope_theta=1e6, dtype=dtype)
    return dict(TINY_LLAMA, hidden_size=256, num_hidden_layers=4, num_attention_heads=8,
                num_key_value_heads=2, intermediate_size=512, vocab_size=1024,
                rope_theta=1e6, torch_dtype=dtype, port_model=name)
