"""Scaling-efficiency measurement: decode tokens/s across mesh shapes
(counterpart of ``qkv_ecc_tpu/benchmarks/scaling.py``).

Tiers, one methodology:
  * single device, no mesh: the port's decode loop (``models/runtime.py``:
    prefill, then ``decode_step`` with a greedy argmax);
  * a (data, model) mesh: ``parallel/tp_runtime.py``'s step on data x model
    ranks, one process each (``measure_tp_mesh`` spawns them; on the card
    one card a rank through NCCL, so a mesh needs as many cards as ranks).
    At 1x1 it gives the step's tensor-parallel overhead beside the
    single-device row; on the CPU (``--device cpu``, gloo) the ratios
    between mesh shapes, not the absolute times, are the measurement.

Weak scaling: the global batch is batch_per_data x data, so the per-rank
work is constant as the data axis grows. Ranks that share one card (gloo)
check correctness and give no scaling figure.

    python -m qkv_ecc_tpu_torch.benchmarks.scaling --meshes single,1x1 \\
        --model bench-0.9b --mode int12-golay

runs on the card (``--device cpu`` on the CPU, whose times are the host's).
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..device import resolve_device

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


def _mesh_device(data: int, model: int, device):
    """The ranks' device of a spawned mesh; on the card, one card a rank, so
    a mesh needs as many cards as ranks (ValueError otherwise, as JAX's
    _mesh needs as many devices)."""
    need = data * model
    if device is None or torch.device(device).type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        resolve_device(device)
        if have < need:
            raise ValueError(f"mesh {data}x{model} needs {need} cards, have {have}")
    return device


def measure_tp_mesh(cfg, policy, *, data=None, model=None, batch_per_data, prompt_len, steps,
                    block_size, warmup=5, mesh=None, tier="in-process-mesh", device=None):
    """tokens/s of the tensor- and data-parallel decode step
    (parallel/tp_runtime.py) on a (data, model) mesh: weak scaling over
    data (the global batch is batch_per_data x data), strong over model.

    With ``mesh`` (parallel/mesh.py), every rank of it calls this together
    and gets the same row (rank 0's clock, the ranks started by a barrier).
    The tier keeps JAX's name, which scaling_efficiency reads, though the
    ranks here are processes.
    Without, it spawns data x model ranks (parallel/launch.py) on
    ``device`` (None: one card each, through NCCL; "cpu": gloo) and returns
    rank 0's row. Weights from seed 0 in the model's dtype, greedy."""
    if mesh is None:
        from ..parallel.launch import spawn

        device = _mesh_device(data, model, device)
        on_cpu = device is not None and torch.device(device).type == "cpu"
        rows = spawn("qkv_ecc_tpu_torch.benchmarks.scaling:_tp_rank", data * model,
                     backend="gloo" if on_cpu else "nccl", device=device,
                     args=(cfg, policy, data, model, batch_per_data, prompt_len, steps,
                           block_size, warmup, tier))
        return rows[0]
    import torch.distributed as dist

    from ..evaluation.timing import synchronize
    from ..models.registry import init_params
    from ..parallel.sharding import shard_params
    from ..parallel.tp_runtime import local_rows, make_tp_functions

    data, model, device = mesh.data, mesh.model, mesh.device
    batch = batch_per_data * data
    params = shard_params(init_params(cfg, 0, device=device, dtype=cfg.torch_dtype), cfg, mesh)
    init_state, prefill, decode_step = make_tp_functions(cfg, policy, mesh, block_size)
    state, bt = init_state(batch, prompt_len + steps + warmup + 8)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(device)
    gen = torch.Generator(device=device).manual_seed(policy.seed)
    with torch.no_grad():
        logits, state = prefill(params, local_rows(ids, mesh), state, bt, gen)
        tok = torch.argmax(logits, -1)
        for _ in range(warmup):
            logits, state = decode_step(params, tok, state, bt, gen)
            tok = torch.argmax(logits, -1)
        synchronize(tok)
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, state = decode_step(params, tok, state, bt, gen)
            tok = torch.argmax(logits, -1)
        synchronize(tok)
    dt = (time.perf_counter() - t0) / steps
    return {"tier": tier, "mesh": f"{data}x{model}", "batch": batch,
            "ms_per_step": dt * 1e3, "tokens_per_s": batch / dt}


def _tp_rank(cfg, policy, data, model, batch_per_data, prompt_len, steps, block_size, warmup,
             tier):
    """A spawned rank of measure_tp_mesh."""
    from ..parallel.launch import rank_device_from_env
    from ..parallel.mesh import create_mesh

    mesh = create_mesh(data, model, device=rank_device_from_env())
    return measure_tp_mesh(cfg, policy, batch_per_data=batch_per_data, prompt_len=prompt_len,
                           steps=steps, block_size=block_size, warmup=warmup, mesh=mesh,
                           tier=tier)


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
    ap.add_argument("--meshes", default="1x1,2x1,4x1,8x1,1x2,2x2",
                    help="comma-separated DATAxMODEL shapes (each spawns its ranks; on the "
                         "card one card a rank); 'single' for the unsharded loop")
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
    rows = []
    for spec in (spec.strip() for spec in args.meshes.split(",")):
        if spec in ("single", "1"):
            r = measure_single_device(
                cfg, policy, batch=args.batch_per_data,
                prompt_len=args.prompt_len, steps=args.steps, block_size=bs, device=device,
            )
        else:
            d, m = (int(x) for x in spec.split("x"))
            r = measure_tp_mesh(
                cfg, policy, data=d, model=m, batch_per_data=args.batch_per_data,
                prompt_len=args.prompt_len, steps=args.steps, block_size=bs,
                device=args.device,
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
