"""Every registered model's attention shape has its kernel instances: for
each configuration of models/config.py and each codec, the (data words,
GQA group, head_dim) of its reads is in KERNEL_SHAPES, DECODE_KERNEL_SHAPES
or FLOAT_KERNEL_SHAPES (kernels/paged_attention.py) and is instantiated in
the CUDA sources the wrappers launch (csrc/write_attend.cu,
csrc/decode_attend.cu), so that no registered model raises on the card. A
model sharded over the model axis keeps its group and head_dim
(models/runtime._local_cfg), so its ranks need no other instance."""

import re
from pathlib import Path

import pytest

from qkv_ecc_tpu_torch.kernels import paged_attention as pa
from qkv_ecc_tpu_torch.kernels import swar
from qkv_ecc_tpu_torch.models.config import MODEL_CONFIGS
from qkv_ecc_tpu_torch.models.runtime import _local_cfg

CSRC = Path(pa.__file__).resolve().parent.parent / "csrc"
CODECS = {"H84": "hamming84", "H74": "hamming74", "Golay": "golay"}


def packed_instances():
    src = (CSRC / "write_attend.cu").read_text()
    return {tuple(map(int, m)) for m in re.findall(r"WA_LAUNCH\((\d+), (\d+), (\d+)\);", src)}


def float_instances():
    src = (CSRC / "write_attend.cu").read_text()
    return {tuple(map(int, m)) for m in re.findall(r"FA_LAUNCH\((\d+), (\d+)\);", src)}


def decode_instances():
    """(codec, data words, parity words, group, head_dim) of every launch<>
    in decode_attend_launch, the group-parametrised macros expanded."""
    src = (CSRC / "decode_attend.cu").read_text()
    body = src[src.index('extern "C" int decode_attend_launch'):]
    launch = r"launch<k(H84|H74|Golay), (\d+), (\d+), (\w+), (\d+),"
    out = {(CODECS[c], int(w), int(p), int(g), int(h))
           for c, w, p, g, h in re.findall(launch, body) if g.isdigit()}
    macros = {}
    for name, text in re.findall(r"#define (DA_\w+)\(G\)((?:.*\\\n)*.*)", body):
        macros[name] = [(CODECS[c], int(w), int(p), int(h))
                        for c, w, p, g, h in re.findall(launch, text) if g == "G"]
    for name, g in re.findall(r"\b(DA_\w+)\((\d+)\);", body):
        out |= {(c, w, p, int(g), h) for c, w, p, h in macros[name]}
    return out


def test_parsers_find_the_instances():
    assert (16, 2, 128) in packed_instances() and (2, 16) in float_instances()
    assert ("golay", 16, 17, 4, 128) in decode_instances()
    assert ("hamming84", 8, 8, 1, 64) in decode_instances()


def test_tuples_are_the_sources():
    assert set(pa.KERNEL_SHAPES) == packed_instances()
    assert set(pa.FLOAT_KERNEL_SHAPES) == float_instances()
    assert set(pa.DECODE_KERNEL_SHAPES) == decode_instances()


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
@pytest.mark.parametrize("tp", [1, 2])
def test_every_registered_model_has_its_instances(name, tp):
    cfg = _local_cfg(MODEL_CONFIGS[name], tp)
    group, hd = cfg.num_kv_groups, cfg.head_dim
    assert (group, hd) in pa.FLOAT_KERNEL_SHAPES, (name, "fp16/fp8")
    for codec in ("int4", "hamming74", "hamming84", "golay"):
        dw = swar.data_words(codec, hd)
        assert (dw, group, hd) in pa.KERNEL_SHAPES, (name, codec)
        if codec != "int4":
            shape = (codec, dw, swar.parity_words(codec, hd), group, hd)
            assert shape in pa.DECODE_KERNEL_SHAPES, (name, shape)
