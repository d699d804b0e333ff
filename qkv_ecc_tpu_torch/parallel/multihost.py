"""Multi-host execution over torch.distributed (counterpart of
``qkv_ecc_tpu/parallel/multihost.py``).

One process per rank, on one host or many. ``initialize_multihost`` joins
the default process group over TCP at the coordinator's address;
``multihost_mesh`` lays the (data, model) mesh so that the model
(tensor-parallel) axis stays within a host - its two all_reduces a layer
never leave it - and the data axis spans hosts, so only the per-step token
vector crosses between them. ``generate_tp_multihost`` keeps the tokens on
the device between steps and gathers the token matrix to every rank at the
end.

A 2-process demo on the CPU (one command per process):

    python -m qkv_ecc_tpu_torch.parallel.multihost --coordinator localhost:29801 \\
        --num-processes 2 --process-id {0,1} --device cpu [--serve --model-axis 2]

prints ``TOKENS`` (greedy generation) or one ``REQ`` line per request (the
continuous-batching server) on every process. Without ``--device`` each
process takes card ``process-id % cards`` through NCCL; ``--backend gloo
--device cuda:0`` puts every process on one card.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .mesh import Mesh, create_mesh, initialize_distributed


def initialize_multihost(coordinator_address: str, num_processes: int, process_id: int, *,
                         backend: str):
    """Join the default process group over TCP at ``coordinator_address``
    ("host:port"; process 0 listens there) with ``backend`` ("nccl" or
    "gloo"). Returns (process count, process index)."""
    return initialize_distributed(coordinator_address, num_processes, process_id,
                                  backend=backend)


def local_ranks() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE when the launcher sets it,
    else the whole world (every process on one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", torch.distributed.get_world_size()))


def multihost_mesh(model: int | None = None, *, device=None) -> Mesh:
    """The (data, model) mesh with the model axis within a host (ranks are
    numbered host by host, so consecutive ranks share one) and the data
    axis across hosts. model defaults to the ranks of a host and must
    divide them (ValueError otherwise: the tensor-parallel axis stays on
    one host)."""
    local = local_ranks()
    if model is None:
        model = local
    if model > local or local % model:
        raise ValueError(f"model axis {model} must divide the {local} ranks of a host: the TP "
                         "axis must stay within one host")
    return create_mesh(torch.distributed.get_world_size() // model, model, device=device)


def generate_tp_multihost(params, input_ids, cfg, policy, mesh: Mesh, max_new_tokens: int = 16,
                          block_size: int = 128):
    """Greedy TP + DP generation across hosts: the whole [B, S + new]
    token matrix as numpy on every process (tp_runtime.generate_tp, whose
    tokens stay on the device until one gather at the end)."""
    from .tp_runtime import generate_tp

    return generate_tp(params, input_ids, cfg, policy, mesh, max_new_tokens,
                       block_size).cpu().numpy()


def serve_demo_requests(vocab_size: int):
    """The request stream of the multi-host serving demo and of its
    single-process oracle (JAX's): more requests than slots, mixed prompt
    lengths, so that the run admits late and recycles pages."""
    from ..serving import Request

    rng = np.random.default_rng(23)
    return [Request(i, rng.integers(0, vocab_size, (n,)), max_new_tokens=m)
            for i, (n, m) in enumerate([(7, 5), (13, 4), (5, 6), (9, 3)])]


def demo_config():
    """The demo's model: tiny-llama under its own name."""
    import dataclasses

    from ..models.config import TINY_LLAMA

    return dataclasses.replace(TINY_LLAMA, name="multihost-demo")


def _demo(args):
    """The demo on tiny-llama: a golay cache at BER 1e-2 by default."""
    from ..device import resolve_device

    if args.device is None:
        resolve_device(None)  # the card, or the error that there is none
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    initialize_multihost(args.coordinator, args.num_processes, args.process_id, backend=backend)
    from ..models.kv_policy import policy_for_mode
    from ..models.registry import init_params

    cfg = demo_config()
    mesh = multihost_mesh(model=args.model_axis, device=args.device)
    if args.params:  # an .npz checkpoint (training.save_params' keys)
        from ..training import load_params

        params = load_params(args.params, cfg, device=mesh.device)
    else:  # the same seed on every process
        params = init_params(cfg, 0, device=mesh.device)
    policy = policy_for_mode(args.mode, ber=args.ber, seed=42)
    print(f"proc {mesh.rank}/{torch.distributed.get_world_size()} mesh data={mesh.data} "
          f"model={mesh.model} device={mesh.device} backend={backend}", flush=True)

    if args.serve:
        from ..serving import MultihostTPContinuousBatchingServer

        server = MultihostTPContinuousBatchingServer(
            params, cfg, policy, mesh, max_batch=2, max_seq_len=64,
            block_size=args.block_size, prefill_bucket=16)
        for req in serve_demo_requests(cfg.vocab_size):
            server.add_request(req)
        for o in sorted(server.run(), key=lambda o: o.request_id):
            print(f"REQ {o.request_id} " + ",".join(str(int(t)) for t in o.token_ids),
                  flush=True)
    elif args.bench_steps:
        import json

        from ..benchmarks.scaling import measure_tp_mesh

        row = measure_tp_mesh(cfg, policy, mesh=mesh, batch_per_data=args.bench_batch_per_data,
                              prompt_len=64, steps=args.bench_steps, block_size=args.block_size,
                              tier=f"multihost-{args.num_processes}p")
        print("BENCH " + json.dumps(row), flush=True)
    else:
        rng = np.random.default_rng(11)
        prompt = rng.integers(0, cfg.vocab_size, (args.num_processes, 9))
        out = generate_tp_multihost(params, prompt, cfg, policy, mesh,
                                    max_new_tokens=args.max_new_tokens,
                                    block_size=args.block_size)
        print("TOKENS " + ",".join(str(int(t)) for t in out.reshape(-1)), flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--model-axis", type=int, default=None,
                    help="default: every process of a host")
    ap.add_argument("--mode", default="int12-golay")
    ap.add_argument("--ber", type=float, default=1e-2)
    ap.add_argument("--max-new-tokens", type=int, default=6)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--serve", action="store_true",
                    help="run the multi-host continuous-batching server instead of generate")
    ap.add_argument("--bench-steps", type=int, default=0,
                    help="time this many TP decode steps and print a scaling row instead")
    ap.add_argument("--bench-batch-per-data", type=int, default=4)
    ap.add_argument("--params", default=None,
                    help="an .npz checkpoint of the demo model (default: random, seed 0)")
    ap.add_argument("--device", default=None,
                    help="default: card process-id %% cards; 'cpu', or 'cuda:0' with gloo")
    ap.add_argument("--backend", default=None, help="default: gloo on the CPU, else nccl")
    _demo(ap.parse_args(argv))


if __name__ == "__main__":
    main()
