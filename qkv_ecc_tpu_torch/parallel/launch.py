"""Spawn a group of ranks, one process each, and collect what they return.

    results = spawn("package.module:function", world=4, backend="gloo",
                    device="cpu", args=(...,))

starts ``world`` Python processes (``python -m
qkv_ecc_tpu_torch.parallel.launch``), each of which joins the default
process group over TCP at a free localhost port with ``backend``, calls
``function(*args)`` and writes its return value to a file; the parent
returns the ranks' values in rank order. A rank that raises, exits with
another code than 0 or outlives ``timeout`` fails the whole group: every
rank is stopped and RuntimeError carries the failing ranks' output. The
target must be importable without the parent's ``__main__``.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]  # the directory holding the package


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, *, backend: str, device=None, args=(), timeout: float = 600):
    """Run ``target`` ("module:function") on ``world`` ranks (see the
    module docstring). ``device`` is the ranks' (None: rank r on card r %
    cards; "cpu"; "cuda:0" for ranks sharing one card) and is exported as
    QKV_RANK_DEVICE for the target to read (rank_device_from_env). Each rank
    runs torch on one CPU thread and imports from the package's directory
    and the caller's PYTHONPATH. Returns [value of rank 0, ...]."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="qkv_ranks_") as tmp:
        tmp = Path(tmp)
        with open(tmp / "args.pkl", "wb") as f:
            pickle.dump(tuple(args), f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
        env["QKV_RANK_DEVICE"] = "" if device is None else str(device)
        procs = []
        for r in range(world):
            log = open(tmp / f"rank{r}.log", "w")
            cmd = [sys.executable, "-m", "qkv_ecc_tpu_torch.parallel.launch", target, str(r),
                   str(world), str(port), backend, str(tmp)]
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                           cwd=str(_ROOT)), log))
        deadline = time.monotonic() + timeout
        failed = []
        try:
            while any(p.poll() is None for p, _ in procs):
                if time.monotonic() > deadline:
                    failed.append("timeout")
                    break
                if any(p.poll() not in (None, 0) for p, _ in procs):
                    break
                time.sleep(0.05)
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
                log.close()
        for r, (p, _) in enumerate(procs):
            if p.returncode != 0:
                tail = (tmp / f"rank{r}.log").read_text()[-4000:]
                failed.append(f"rank {r} exited with {p.returncode}:\n{tail}")
        if failed:
            raise RuntimeError(f"{target} on {world} ranks failed: " + "\n".join(failed))
        out = []
        for r in range(world):
            with open(tmp / f"rank{r}.out", "rb") as f:
                out.append(pickle.load(f))
        return out


def rank_device_from_env():
    """The ranks' device that spawn exported: None (the cards), or a
    device string."""
    return os.environ.get("QKV_RANK_DEVICE") or None


def _rank_main(argv):
    target, rank, world, port, backend, tmp = argv
    rank, world = int(rank), int(world)
    import torch

    from .mesh import initialize_distributed

    torch.set_num_threads(1)
    initialize_distributed(f"localhost:{port}", world, rank, backend=backend)
    module, fn = target.split(":")
    with open(Path(tmp) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    value = getattr(importlib.import_module(module), fn)(*args)
    with open(Path(tmp) / f"rank{rank}.out.tmp", "wb") as f:
        pickle.dump(value, f)
    os.replace(Path(tmp) / f"rank{rank}.out.tmp", Path(tmp) / f"rank{rank}.out")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
