"""Model zoo (counterpart of ``qkv_ecc_tpu/models/registry.py``): dispatch
between the architectures, random init, the conversion of JAX parameters,
the forward and its loss."""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import deepseek_v2, gpt2, llama
from .config import ModelConfig
from .kv_policy import KVCachePolicy

_ARCH = {"gpt2": gpt2, "llama": llama, "deepseek_v2": deepseek_v2}


def arch_module(cfg: ModelConfig):
    """The module of cfg's architecture (init_params, forward, and the
    pieces the decode runtime shares)."""
    if cfg.arch not in _ARCH:
        raise NotImplementedError(
            f"architecture '{cfg.arch}' is not ported; known: {sorted(_ARCH)}")
    return _ARCH[cfg.arch]


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (None: the card)."""
    module = arch_module(cfg)
    generator = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    return module.init_params(cfg, generator, dtype=dtype)


def map_tree(fn, node, path=()):
    """A parameter tree (nested dicts and lists) with each leaf replaced by
    fn(its path "/"-joined, leaf): the key of the leaf in an ``.npz``
    checkpoint, e.g. ``layers/0/c_attn/w``."""
    if isinstance(node, dict):
        return {k: map_tree(fn, v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [map_tree(fn, v, path + (str(i),)) for i, v in enumerate(node)]
    return fn("/".join(path), node)


def tree_leaves(tree) -> dict:
    """{path: leaf} of a parameter tree, in its order (map_tree's paths)."""
    out = {}
    map_tree(out.__setitem__, tree)
    return out


def params_from_jax(np_params, cfg: ModelConfig, device=None):
    """The JAX ``init_params`` pytree, as numpy arrays (nested dicts and
    lists, either architecture), -> the same tree of tensors with the same
    dtypes on ``device`` (None: the card)."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.tensor(np.asarray(node), device=device)

    out = conv(np_params)
    if len(out["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(out['layers'])} layers given, {cfg.name} has {cfg.num_layers}")
    return out


def _params_device(params) -> torch.device:
    return (params["wte"] if "wte" in params else params["embed"]).device


def forward(params, input_ids, cfg: ModelConfig, policy: KVCachePolicy, *, write_masks=None,
            read_masks=None):
    """input_ids [B, S] (moved to the parameters' device) -> (logits
    [B, S, V], stats): each layer's K/V through the policy's codec chain
    (kv_policy.process_kv). ``write_masks`` / ``read_masks`` ([L, 2, ...],
    K then V) are the port's own, keyword-only: the flips a test feeds both
    packages; without them they are drawn per (policy.seed, layer, K/V)."""
    input_ids = torch.as_tensor(input_ids).to(_params_device(params), torch.long)
    return arch_module(cfg).forward(params, input_ids, cfg, policy, write_masks=write_masks,
                                    read_masks=read_masks)


# JAX jits its forward; the port runs the same eager call
forward_jit = forward


def cross_entropy(logits, labels, ignore_index: int = -100):
    """Next-token cross entropy with HF label semantics: logits[:, t]
    predicts labels[:, t + 1], and targets equal to ``ignore_index`` are
    masked. Returns (sum of the losses float32, count of targets int32)."""
    logits = logits[:, :-1].to(torch.float32)
    targets = torch.as_tensor(labels).to(logits.device, torch.long)[:, 1:]
    valid = targets != ignore_index
    safe = torch.where(valid, targets, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum(), valid.sum(dtype=torch.int32)


def loss_and_stats(params, input_ids, labels, cfg: ModelConfig, policy: KVCachePolicy, *,
                   write_masks=None, read_masks=None):
    """One forward: (mean loss, target count, logits, ECC stats), the
    per-text unit of the Monte-Carlo sweep."""
    logits, stats = forward(params, input_ids, cfg, policy, write_masks=write_masks,
                            read_masks=read_masks)
    total, count = cross_entropy(logits, labels)
    return total / count.clamp(min=1), count, logits, stats
