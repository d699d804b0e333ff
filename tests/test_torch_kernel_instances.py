"""Every registered model's attention shape has its kernel instances: for
each configuration of models/config.py and each codec, the (data words,
GQA group, head_dim) of its reads is in KERNEL_SHAPES, DECODE_KERNEL_SHAPES
or FLOAT_KERNEL_SHAPES (kernels/paged_attention.py) and is instantiated in
the CUDA sources the wrappers launch (csrc/write_attend.cu,
csrc/decode_attend.cu), so that no registered model raises on the card. A
model sharded over the model axis keeps its group and head_dim
(models/runtime._local_cfg), so its ranks need no other instance. A
latent-attention model (deepseek_v2) reads its one latent row through
csrc/latent_attend.cu alone (LATENT_KERNEL_SHAPES) and is not sharded."""

import re
from pathlib import Path

import pytest

from qkv_ecc_tpu_torch.kernels import paged_attention as pa
from qkv_ecc_tpu_torch.kernels import swar
from qkv_ecc_tpu_torch.models.config import MODEL_CONFIGS, is_latent
from qkv_ecc_tpu_torch.models.runtime import _local_cfg
from qkv_ecc_tpu_torch.parallel.sharding import param_specs

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


def latent_instances():
    """(data words, parity words, heads, p.v width) of every launch<> in
    latent_attend_launch (its rows hold as many parity as data words)."""
    src = (CSRC / "latent_attend.cu").read_text()
    body = src[src.index('extern "C" int latent_attend_launch'):]
    return {(int(w), int(w), int(h), int(v))
            for w, h, v in re.findall(r"launch<(\d+), (\d+), (\d+), (?:true|false)>", body)}


def test_latent_tuples_are_the_source():
    assert (72, 72, 16, 512) in latent_instances()
    assert set(pa.LATENT_KERNEL_SHAPES) == latent_instances()


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
    if is_latent(MODEL_CONFIGS[name]):
        cfg = MODEL_CONFIGS[name]
        if tp > 1:  # the latent cache is not sharded
            with pytest.raises(NotImplementedError, match="tensor parallelism"):
                param_specs(cfg)
            return
        shape = (swar.data_words("golay", cfg.head_dim), swar.parity_words("golay", cfg.head_dim),
                 cfg.num_heads, cfg.kv_lora_rank)
        assert shape in pa.LATENT_KERNEL_SHAPES, (name, shape)
        return
    cfg = _local_cfg(MODEL_CONFIGS[name], tp)
    group, hd = cfg.num_kv_groups, cfg.head_dim
    assert (group, hd) in pa.FLOAT_KERNEL_SHAPES, (name, "fp16/fp8")
    for codec in ("int4", "hamming74", "hamming84", "golay"):
        dw = swar.data_words(codec, hd)
        assert (dw, group, hd) in pa.KERNEL_SHAPES, (name, codec)
        if codec != "int4":
            shape = (codec, dw, swar.parity_words(codec, hd), group, hd)
            assert shape in pa.DECODE_KERNEL_SHAPES, (name, shape)
