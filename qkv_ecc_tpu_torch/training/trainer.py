"""Loading a trained checkpoint (counterpart of ``load_params`` in
``qkv_ecc_tpu/training/trainer.py``): the ``.npz`` that the JAX package's
``save_params`` writes, one array per parameter keyed by its tree path
("/"-joined dict keys and list indices, e.g. ``layers/0/c_attn/w``)."""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.registry import init_params, params_from_jax


def _map(fn, node, path=()):
    """node's tree with each leaf replaced by fn("/".join(path), leaf)."""
    if isinstance(node, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(node)]
    return fn("/".join(path), node)


def load_params(path: str, cfg: ModelConfig, device=None):
    """The checkpoint at ``path`` as the port's parameter tree for ``cfg``,
    each leaf in the dtype of the config's init, on ``device`` (None: the
    card). Every array must have the shape of its leaf in a fresh init
    (ValueError naming the key otherwise)."""
    device = resolve_device(device)
    template = init_params(cfg, 0, device="cpu")
    with np.load(path) as loaded:
        def take(key, leaf):
            arr = loaded[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"{cfg.name} needs {tuple(leaf.shape)}")
            return arr

        arrays = _map(take, template)
    params = params_from_jax(arrays, cfg, device=device)
    dtypes = {}
    _map(lambda key, leaf: dtypes.setdefault(key, leaf.dtype), template)
    return _map(lambda key, t: t.to(dtypes[key]), params)
