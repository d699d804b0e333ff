"""nvcc build time of the port's CUDA sources with and without
``--split-compile=0`` (nvcc runs its optimisation passes on all cores), on
one machine.

    python -m qkv_ecc_tpu_torch.kernels.build_trial [--rounds 2]

Builds every source of ``_build.SOURCES`` together, one nvcc each, as
``_build.build_all`` does, into a temporary directory, in turns without and
with the flag (without, with, with, without for two rounds), and prints
each source's seconds and each build's wall time. Needs nvcc, not a card.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

from ._build import NVCC_FLAGS, SOURCES, run_nvcc

FLAG = "--split-compile=0"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    without = tuple(f for f in NVCC_FLAGS if f != FLAG)
    arms = {"without": without, "with": without + (FLAG,)}
    walls = {arm: [] for arm in arms}
    with tempfile.TemporaryDirectory() as tmp:
        for r in range(args.rounds):
            for arm in ("without", "with") if r % 2 == 0 else ("with", "without"):
                t0 = time.perf_counter()
                done = run_nvcc({name: Path(tmp) / f"{arm}{r}-{name}.so" for name in SOURCES},
                                arms[arm])
                wall = time.perf_counter() - t0
                for name, (rc, _, log) in done.items():
                    if rc != 0:
                        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
                walls[arm].append(wall)
                print(f"round {r} {arm} {FLAG}: " + ", ".join(
                    f"{name} {done[name][1]:.2f} s" for name in SOURCES)
                    + f"; all sources {wall:.2f} s", flush=True)
    for arm, ws in walls.items():
        print(f"{arm} {FLAG}: all sources {', '.join(f'{w:.2f}' for w in ws)} s", flush=True)
    return walls


if __name__ == "__main__":
    main()
