"""The two halves of an architecture agree: what archs/<name>.py tells the
counts of each layer's cache rows and window is what reference/<name>.py's
model stores and attends, for every configuration the benchmark keeps and
the tiny ones its CPU tests run."""

import importlib
import json

import pytest

from h100_bench.core import spec
from h100_bench.tests import tiny

CONFIGS = {p.stem: json.loads(p.read_text())
           for p in sorted((spec.BENCH_DIR / "configs").glob("*.json"))}
CONFIGS.update({"tiny-llama": tiny.TINY_LLAMA, "tiny-gpt2": tiny.TINY_GPT2})


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_archs_and_reference_state_the_same_cache(name):
    config = CONFIGS[name]
    layers = spec.arch_module(config).layers(config)
    reference = importlib.import_module(f"h100_bench.reference.{config['reference']}")
    model = reference.Model(config, None, None)
    assert len(layers) == model.L
    for i, layer in enumerate(layers):
        assert [tuple(r) for r in layer["rows"]] == [tuple(r) for r in model.cache(i)], i
        assert layer["window"] == model.window(i), i
        assert layer["heads"] == model.H, i
