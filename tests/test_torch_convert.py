"""The port's HF converters (qkv_ecc_tpu_torch.models.convert) and the HF
branch of evaluation.models.load_model against the JAX package, on
synthetic state dicts with HF's parameter names (no checkpoint is
downloaded: neither machine has the network). The converted trees are
equal: float32 values carried as they are, bfloat16 configurations rounded
from float32 as JAX rounds them.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu.models import config as jconfig  # noqa: E402
from qkv_ecc_tpu.models import convert as jconvert  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import data as tdata  # noqa: E402
from qkv_ecc_tpu_torch.evaluation import models as tmodels  # noqa: E402
from qkv_ecc_tpu_torch.models import config as tconfig  # noqa: E402
from qkv_ecc_tpu_torch.models import convert as tconvert  # noqa: E402
from qkv_ecc_tpu_torch.models.kv_policy import KVCachePolicy  # noqa: E402
from qkv_ecc_tpu_torch.models import registry as treg  # noqa: E402

torch.set_num_threads(1)


def gpt2_state_dict(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    E, I, V, P = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.max_position_embeddings

    def r(*shape):
        return torch.randn(shape, generator=g)

    sd = {"transformer.wte.weight": r(V, E), "transformer.wpe.weight": r(P, E),
          "transformer.ln_f.weight": r(E), "transformer.ln_f.bias": r(E)}
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        sd.update({p + "ln_1.weight": r(E), p + "ln_1.bias": r(E), p + "ln_2.weight": r(E),
                   p + "ln_2.bias": r(E), p + "attn.c_attn.weight": r(E, 3 * E),
                   p + "attn.c_attn.bias": r(3 * E), p + "attn.c_proj.weight": r(E, E),
                   p + "attn.c_proj.bias": r(E), p + "mlp.c_fc.weight": r(E, I),
                   p + "mlp.c_fc.bias": r(I), p + "mlp.c_proj.weight": r(I, E),
                   p + "mlp.c_proj.bias": r(E)})
    return sd


def llama_state_dict(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    Q, KV = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def r(*shape):
        return torch.randn(shape, generator=g)

    sd = {"model.embed_tokens.weight": r(V, E), "model.norm.weight": r(E),
          "lm_head.weight": r(V, E)}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": r(E), p + "post_attention_layernorm.weight": r(E),
                   p + "self_attn.q_proj.weight": r(Q, E), p + "self_attn.k_proj.weight": r(KV, E),
                   p + "self_attn.v_proj.weight": r(KV, E), p + "self_attn.o_proj.weight": r(E, Q),
                   p + "mlp.gate_proj.weight": r(I, E), p + "mlp.up_proj.weight": r(I, E),
                   p + "mlp.down_proj.weight": r(E, I)})
    return sd


def assert_trees_equal(got, want):
    """The port's tree of tensors equal to JAX's tree of arrays, leaf for
    leaf, dtypes included (bfloat16 compared through float32)."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    seen = 0
    for kp, arr in flat:
        node = got
        for k in kp:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        arr = np.asarray(arr)
        assert str(node.dtype).split(".")[-1] == str(arr.dtype), kp
        assert np.array_equal(node.float().numpy(), arr.astype(np.float32)), kp
        seen += 1
    assert seen == sum(1 for _ in _leaves(got))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_gpt2_converter_matches_jax():
    cfg = tconfig.get_model_config("tiny-gpt2")
    sd = gpt2_state_dict(cfg)
    got = tconvert.convert_gpt2_state_dict(sd, cfg)
    assert_trees_equal(got, jconvert.convert_gpt2_state_dict(sd, jconfig.get_model_config("tiny-gpt2")))
    # the tree is the port's gpt2 parameter tree: it runs the forward
    logits, _ = treg.forward(got, np.zeros((1, 4), np.int32), cfg, KVCachePolicy(codec="fp16"))
    assert logits.shape == (1, 4, cfg.vocab_size)


@pytest.mark.parametrize("tie,dtype", [(True, "float32"), (False, "float32"),
                                       (False, "bfloat16")])
def test_llama_converter_matches_jax(tie, dtype):
    """tiny-llama as it is and untied (an lm_head, transposed) and in
    bfloat16 (each value rounded from float32)."""
    tc = dataclasses.replace(tconfig.get_model_config("tiny-llama"), tie_word_embeddings=tie,
                             dtype=dtype)
    jc = dataclasses.replace(jconfig.get_model_config("tiny-llama"), tie_word_embeddings=tie,
                             dtype=dtype)
    sd = llama_state_dict(tc, seed=1)
    got = tconvert.convert_llama_state_dict(sd, tc)
    assert ("lm_head" in got) is (not tie)
    assert_trees_equal(got, jconvert.convert_llama_state_dict(sd, jc))


def test_convert_hf_model_dispatches_on_arch():
    class Model:
        def __init__(self, sd):
            self.sd = sd

        def state_dict(self):
            return self.sd

    for name, make in (("tiny-gpt2", gpt2_state_dict), ("tiny-llama", llama_state_dict)):
        tc, jc = tconfig.get_model_config(name), jconfig.get_model_config(name)
        sd = make(tc, seed=2)
        assert_trees_equal(tconvert.convert_hf_model(Model(sd), tc),
                           jconvert.convert_hf_model(Model(sd), jc))


def test_load_hf_checkpoint_raises_without_transformers(monkeypatch):
    """Without transformers both packages raise RuntimeError (the import is
    patched away; no hub id is ever asked for)."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    for module, cfg in ((tconvert, tconfig.get_model_config("gpt2")),
                        (jconvert, jconfig.get_model_config("gpt2"))):
        with pytest.raises(RuntimeError, match="transformers is required"):
            module.load_hf_checkpoint("gpt2", cfg)


def test_load_model_hf_branch_takes_the_converted_checkpoint(monkeypatch):
    """load_model on an HF model returns what the converter loads, on the
    asked device, with get_tokenizer's tokenizer (the converter patched to
    return a converted synthetic checkpoint); a gated model without
    HF_TOKEN never asks it and takes random weights (init_params patched:
    the 8B model is not built here)."""
    cfg = tconfig.get_model_config("gpt2")
    small = tconvert.convert_gpt2_state_dict(gpt2_state_dict(tconfig.get_model_config(
        "tiny-gpt2")), tconfig.get_model_config("tiny-gpt2"))
    asked = []

    def fake(name, c):
        asked.append((name, c.name))
        return small

    monkeypatch.setattr(tconvert, "load_hf_checkpoint", fake)
    params, got_cfg, tok = tmodels.load_model("gpt2", allow_random_init=False, device="cpu")
    assert asked == [("gpt2", "gpt2")] and got_cfg == cfg
    assert torch.equal(params["wte"], small["wte"]) and params["wte"].device.type == "cpu"
    assert type(tok) is tdata.ByteTokenizer
    monkeypatch.delenv("HF_TOKEN", raising=False)
    monkeypatch.setattr(tmodels, "init_params", lambda c, seed, device: ("random", c.name))
    params, got_cfg, _ = tmodels.load_model("llama-3.1-8b", device="cpu")
    assert asked == [("gpt2", "gpt2")] and params == ("random", "llama-3.1-8b")
