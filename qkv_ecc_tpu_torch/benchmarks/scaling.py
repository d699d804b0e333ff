"""Scaling-efficiency measurement: decode tokens/s (counterpart of
``qkv_ecc_tpu/benchmarks/scaling.py``).

The single-device tier runs the port's decode loop (``models/runtime.py``:
prefill, then ``decode_step`` with a greedy argmax) and reports the JAX
module's row. The mesh tiers (``measure_tp_mesh``, and every DATAxMODEL
spec of ``main``) need the parallel runtime, which is not ported yet
(ROADMAP M11): they raise NotImplementedError, and ``--meshes`` defaults to
``single`` until then (JAX's default lists the meshes).

    python -m qkv_ecc_tpu_torch.benchmarks.scaling --meshes single \\
        --model bench-0.9b --mode int12-golay

runs on the card (``--device cpu`` on the CPU, whose times are the host's).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..device import resolve_device

_MESH_TODO = ("the tensor- and data-parallel decode step needs the parallel runtime "
              "(parallel/), which is not ported yet: ROADMAP M11")


def measure_single_device(cfg, policy, *, batch, prompt_len, steps,
                          block_size, warmup=5, device=None):
    """tokens/s of the plain (unsharded) decode loop on ``device`` (None:
    the card), weights from seed 0 in the model's dtype (bf16 for
    bench-0.9b, as the JAX function casts them; the port's runtime computes
    in the model's dtype), greedy; the device is synchronised before and
    after the timed steps."""
    from ..evaluation.timing import synchronize
    from ..models.registry import init_params
    from ..models.runtime import decode_step, init_generation_state, prefill

    device = resolve_device(device)
    params = init_params(cfg, 0, device=device, dtype=cfg.torch_dtype)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)
    state, bt, _ = init_generation_state(
        cfg, policy, batch, prompt_len + steps + warmup + 8,
        block_size=block_size, device=device,
    )
    gen = torch.Generator(device=device).manual_seed(policy.seed)
    with torch.no_grad():
        logits, state = prefill(params, ids, state, bt, cfg, policy, gen)
        tok = torch.argmax(logits, -1)
        for _ in range(warmup):
            logits, state = decode_step(params, tok, state, bt, cfg, policy, gen,
                                        block_size=block_size)
            tok = torch.argmax(logits, -1)
        synchronize(tok)
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state = decode_step(params, tok, state, bt, cfg, policy, gen,
                                        block_size=block_size)
            tok = torch.argmax(logits, -1)
        synchronize(tok)
    dt = (time.perf_counter() - t0) / steps
    return {"tier": "single-device", "mesh": "1", "batch": batch,
            "ms_per_step": dt * 1e3, "tokens_per_s": batch / dt}


def measure_tp_mesh(cfg, policy, *, data=None, model=None, batch_per_data,
                    prompt_len, steps, block_size, warmup=5, mesh=None,
                    tier="in-process-mesh"):
    """The sharded decode step on a (data, model) mesh: not ported yet."""
    raise NotImplementedError(_MESH_TODO)


def scaling_efficiency(rows):
    """Annotate weak-scaling efficiency vs the smallest data axis at each
    model-axis size: eff = (tok/s) / (tok/s_base * data/data_base)."""
    by_model = {}
    for r in rows:
        if r["tier"] != "in-process-mesh":
            continue
        d, m = (int(x) for x in r["mesh"].split("x"))
        by_model.setdefault(m, []).append((d, r))
    for m, drs in by_model.items():
        drs.sort(key=lambda dr: dr[0])
        d0, r0 = drs[0]
        for d, r in drs:
            ideal = r0["tokens_per_s"] * d / d0
            r["weak_scaling_efficiency"] = r["tokens_per_s"] / ideal
    return rows


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="tiny-llama")
    ap.add_argument("--mode", default="int12-golay")
    ap.add_argument("--ber", type=float, default=1e-2)
    ap.add_argument("--meshes", default="single",
                    help="'single' for the unsharded loop; comma-separated DATAxMODEL "
                         "shapes are not ported yet (ROADMAP M11)")
    ap.add_argument("--batch-per-data", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--block-size", type=int, default=None,
                    help="default: 128 on the card, 16 on the CPU")
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    from ..models.config import get_model_config
    from ..models.kv_policy import policy_for_mode

    cfg = get_model_config(args.model)
    policy = policy_for_mode(args.mode, ber=args.ber, seed=42)
    device = resolve_device(args.device)
    platform = device.type
    bs = args.block_size or (128 if platform == "cuda" else 16)
    specs = [spec.strip() for spec in args.meshes.split(",")]
    if any(spec not in ("single", "1") for spec in specs):
        raise NotImplementedError(f"--meshes {args.meshes}: {_MESH_TODO}")

    rows = []
    for spec in specs:
        r = measure_single_device(
            cfg, policy, batch=args.batch_per_data,
            prompt_len=args.prompt_len, steps=args.steps, block_size=bs, device=device,
        )
        r.update(model=cfg.name, mode=args.mode, ber=args.ber,
                 platform=platform, block_size=bs)
        print(json.dumps(r), flush=True)
        rows.append(r)
    rows = scaling_efficiency(rows)
    out = {"config": vars(args), "platform": platform, "rows": rows}
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.output}", flush=True)
    return out


if __name__ == "__main__":
    main()
