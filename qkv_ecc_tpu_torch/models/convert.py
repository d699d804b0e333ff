"""HF checkpoint -> the port's parameter trees (counterpart of
``qkv_ecc_tpu/models/convert.py``).

Converts a ``transformers`` model instance or a torch state dict (HF
parameter names) into the trees of ``gpt2.init_params`` and
``llama.init_params``, tensors taken as they are, without a numpy copy.
Loading from the hub needs ``transformers`` and the network or a local
cache; where ``transformers`` is missing, ``load_hf_checkpoint`` raises.

Weight layout notes:
  * GPT-2 Conv1D stores [in, out], which matches our convention directly.
  * HF Llama Linear stores [out, in]; we transpose to [in, out].
  * HF Llama q/k_proj use the interleaved rotary layout that matches
    `rotate_half`; our apply_rope uses the same convention, so no
    permutation is needed.
"""

from __future__ import annotations

import torch

from .config import ModelConfig


def _t(t, dtype=torch.float32):
    """A tensor (any device, any float dtype) as a contiguous tensor of
    ``dtype``, detached."""
    return torch.as_tensor(t).detach().to(dtype=dtype).contiguous()


def convert_gpt2_state_dict(sd: dict, cfg: ModelConfig) -> dict:
    """HF GPT2LMHeadModel state dict -> gpt2.init_params structure
    (float32, as JAX's)."""
    g = lambda name: _t(sd[name])  # noqa: E731
    params = {
        "wte": g("transformer.wte.weight"),
        "wpe": g("transformer.wpe.weight"),
        "ln_f": {"g": g("transformer.ln_f.weight"), "b": g("transformer.ln_f.bias")},
        "layers": [],
    }
    for i in range(cfg.num_layers):
        p = f"transformer.h.{i}."
        params["layers"].append(
            {
                "ln_1": {"g": g(p + "ln_1.weight"), "b": g(p + "ln_1.bias")},
                "ln_2": {"g": g(p + "ln_2.weight"), "b": g(p + "ln_2.bias")},
                "c_attn": {"w": g(p + "attn.c_attn.weight"), "b": g(p + "attn.c_attn.bias")},
                "c_proj": {"w": g(p + "attn.c_proj.weight"), "b": g(p + "attn.c_proj.bias")},
                "c_fc": {"w": g(p + "mlp.c_fc.weight"), "b": g(p + "mlp.c_fc.bias")},
                "mlp_proj": {"w": g(p + "mlp.c_proj.weight"), "b": g(p + "mlp.c_proj.bias")},
            }
        )
    return params


def convert_llama_state_dict(sd: dict, cfg: ModelConfig) -> dict:
    """HF LlamaForCausalLM / MistralForCausalLM state dict -> llama params
    in the config's dtype (each value rounded from float32, as JAX's)."""
    dtype = cfg.torch_dtype
    g = lambda name: _t(_t(sd[name]), dtype)  # noqa: E731
    gt = lambda name: _t(_t(sd[name]).T, dtype)  # noqa: E731
    params = {
        "embed": g("model.embed_tokens.weight"),
        "final_norm": g("model.norm.weight"),
        "layers": [],
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = gt("lm_head.weight")
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        params["layers"].append(
            {
                "input_norm": g(p + "input_layernorm.weight"),
                "post_attn_norm": g(p + "post_attention_layernorm.weight"),
                "q_proj": gt(p + "self_attn.q_proj.weight"),
                "k_proj": gt(p + "self_attn.k_proj.weight"),
                "v_proj": gt(p + "self_attn.v_proj.weight"),
                "o_proj": gt(p + "self_attn.o_proj.weight"),
                "gate_proj": gt(p + "mlp.gate_proj.weight"),
                "up_proj": gt(p + "mlp.up_proj.weight"),
                "down_proj": gt(p + "mlp.down_proj.weight"),
            }
        )
    return params


def convert_hf_model(hf_model, cfg: ModelConfig) -> dict:
    """Convert from an in-memory transformers model."""
    sd = hf_model.state_dict()
    if cfg.arch == "gpt2":
        return convert_gpt2_state_dict(sd, cfg)
    return convert_llama_state_dict(sd, cfg)


def load_hf_checkpoint(name_or_path: str, cfg: ModelConfig) -> dict:
    """Load + convert an HF checkpoint (requires ``transformers`` and the
    network or a local cache), on the CPU."""
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError("transformers is required for HF conversion") from e
    model = transformers.AutoModelForCausalLM.from_pretrained(name_or_path)
    return convert_hf_model(model, cfg)
