"""Run one cell of the qkv_ecc_tpu_torch benchmark once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (``BENCHMARK.json``). Prints the run's result as the last
line of standard output, one JSON object:

  correct, attempted, failed   the check of what the window served
                               (core/check.py), the row-rounds started
                               and the rows whose logits were not finite
  metrics                      --trace 0: the cell's end-to-end metrics;
                               --trace 1: its per-layer metrics
  device                       the card, its count, the peak of allocated
                               memory; with --trace 1 the traced stretch's
                               busy and window seconds
  breakdown                    (--trace 1) device ops by time, idle gaps by
                               the host's span
  window_steps                 the decode steps the window held
  setup_compiled, build_s      whether set-up built the kernels (a
                               checkout's first run) and its seconds
  checks                       each number compared, with its limit (last)

and the numbers compared, each beside its limit, as the last lines of
standard error. Exits non-zero without a result when there is no card or
too few, when the program is not in the checkout, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qkv_ecc_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (``names``: sys.modules) whose top-level name, compared
    whole, is JAX's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(msg, file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench.core import result, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", 3)
    try:
        import qkv_ecc_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}", 4)
    if ROOT not in Path(qkv_ecc_tpu_torch.__file__).resolve().parents:
        fail(f"qkv_ecc_tpu_torch was loaded from {qkv_ecc_tpu_torch.__file__}, "
             f"outside the checkout {ROOT}", 4)

    from h100_bench.core.session import run_cell

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    line, report = result.assemble(cell, out, bool(args.trace), args.seed)
    found = forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {found}", 5)
    for text in report:
        print(text, file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
