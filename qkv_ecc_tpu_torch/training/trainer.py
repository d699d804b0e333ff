"""Language-model training and its checkpoints (counterpart of
``qkv_ecc_tpu/training/trainer.py``).

Trains the port's own model definitions (models/gpt2.py, models/llama.py)
through the same forward the evaluation runs, under the fp16 KV policy (its
codec, a cast to bfloat16 and back, carries the gradient as JAX's astype
does). The optimizer is JAX's optax chain written out: the global-norm clip
of ``optax.clip_by_global_norm``, ``torch.optim.AdamW`` with optax's
numbers in one parameter group, and the learning rate of
``optax.warmup_cosine_decay_schedule`` at the update's count before it
increments (the first update's rate is 0; Adam's moments advance all the
same). Checkpoints are ``.npz`` files, one array per parameter keyed by its
tree path ("/"-joined dict keys and list indices, e.g.
``layers/0/c_attn/w``), which both packages read and write.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig, refuse_latent
from ..models.kv_policy import KVCachePolicy
from ..models.registry import (cross_entropy, forward, init_params, map_tree,
                               params_from_jax, tree_leaves)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 4000
    batch: int = 32
    seq_len: int = 256
    lr: float = 3e-4
    warmup: int = 200
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    seed: int = 0
    log_every: int = 200


def _sample_batch(rng: np.random.Generator, data: np.ndarray, batch: int,
                  seq_len: int) -> np.ndarray:
    starts = rng.integers(0, len(data) - seq_len - 1, size=batch)
    return np.stack([data[s : s + seq_len + 1] for s in starts]).astype(np.int32)


def warmup_cosine_schedule(tcfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate, ``optax.warmup_cosine_decay_schedule(0, lr,
    warmup, steps, 0.1 lr)`` in float32 as optax computes it, with JAX's
    warmup of min(tcfg.warmup, max(steps // 10, 1)). Raises ValueError
    where optax does (no step left after the warmup)."""
    f32 = np.float32
    warmup = min(tcfg.warmup, max(tcfg.steps // 10, 1))
    decay = tcfg.steps - warmup
    if not decay > 0:
        raise ValueError(f"the cosine decay needs steps after the warmup: {tcfg.steps} steps, "
                         f"warmup {warmup}")
    peak = f32(tcfg.lr)
    alpha = 0.0 if tcfg.lr == 0.0 else tcfg.lr * 0.1 / tcfg.lr

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - tcfg.lr) * frac + peak)
        c = f32(min(count - warmup, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
        return float(peak * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: the gradients are left alone
    when their global norm is below ``max_norm``, else each becomes
    (g / norm) * max_norm (divided first, as optax does; torch's
    clip_grad_norm_ multiplies by max_norm / (norm + 1e-6)), chosen on the
    device without a host read. Returns the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def train_loss(params, chunk, cfg: ModelConfig, policy: KVCachePolicy):
    """JAX's loss of one batch [B, S + 1]: the forward of its first S ids,
    then the mean cross entropy of each position's next id among them."""
    refuse_latent(cfg, "training")
    ids = chunk[:, :-1]
    logits, _ = forward(params, ids, cfg, policy)
    total, count = cross_entropy(logits, ids)
    return total / count.clamp(min=1)


def train_tiny(
    cfg: ModelConfig,
    corpus,
    tcfg: TrainConfig = TrainConfig(),
    progress: Optional[Callable[[int, float, float], None]] = None,
    *,
    params=None,
    device=None,
):
    """Train cfg on a corpus (raw bytes -> byte-level LM, or a pre-
    tokenized int array) on ``device`` (None: the card); returns (params,
    loss in nats of the last logged step). Batches are JAX's: the same
    numpy ``default_rng(tcfg.seed)`` draws. ``params`` (the port's own,
    keyword-only) starts from given parameters, copied, instead of
    init_params(cfg, tcfg.seed); they stay in their dtype."""
    refuse_latent(cfg, "training")
    device = resolve_device(device)
    if isinstance(corpus, (bytes, bytearray)):
        assert cfg.vocab_size >= 256, "byte-level training needs vocab >= 256"
        data = np.frombuffer(corpus, dtype=np.uint8)
    else:
        data = np.asarray(corpus)
        assert data.max() < cfg.vocab_size
    if params is None:
        params = init_params(cfg, tcfg.seed, device=device)
    params = map_tree(lambda _, t: t.detach().to(device).clone().requires_grad_(True), params)
    leaves = list(tree_leaves(params).values())
    policy = KVCachePolicy(codec="fp16")
    schedule = warmup_cosine_schedule(tcfg)
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=tcfg.weight_decay)

    rng = np.random.default_rng(tcfg.seed)
    t0 = time.time()
    loss = float("nan")
    for step in range(tcfg.steps):
        chunk = torch.from_numpy(_sample_batch(rng, data, tcfg.batch, tcfg.seq_len)).to(device)
        opt.zero_grad(set_to_none=False)
        loss_t = train_loss(params, chunk, cfg, policy)
        loss_t.backward()
        clip_by_global_norm_([p.grad for p in leaves], tcfg.clip_norm)
        opt.param_groups[0]["lr"] = schedule(step)
        opt.step()
        if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
            loss = float(loss_t.detach())
            if progress:
                progress(step, loss, time.time() - t0)
    return map_tree(lambda _, t: t.detach().requires_grad_(False), params), loss


def save_params(params, path: str, cfg: ModelConfig = None):
    """Flatten the parameter tree into an .npz keyed by tree path (JAX's
    keys and arrays), and with ``cfg`` its fields as JSON beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: t.detach().cpu().numpy() for k, t in tree_leaves(params).items()})
    if cfg is not None:
        with open(path + ".json", "w") as fh:
            json.dump(cfg.as_dict(), fh, indent=2)


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

        arrays = map_tree(take, template)
    params = params_from_jax(arrays, cfg, device=device)
    dtypes = {k: leaf.dtype for k, leaf in tree_leaves(template).items()}
    return map_tree(lambda key, t: t.to(dtypes[key]), params)
