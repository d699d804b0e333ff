"""The control of a cell's check, and the program's readings beside it.

    python3 h100_bench/control.py --workload <cell> --seeds 1 2 3 [--seconds 1]

For each seed, in one process: a run of the cell (a short window, then the
round it was in finished), the numbers its check compares, and the same
numbers of the control - the reference put in the program's place at the
next precision below the configuration's (core/check.py) - read at the
same prompts and served tokens. One JSON line a seed on standard output.
The limits in workloads/<cell>.json are set between the program's largest
reading and the control's smallest (PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench.core import check, spec
    from h100_bench.core.session import run_cell

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, "cuda", t)
        nums = check.numbers(out.served, with_control=True)
        nums.pop("detail")
        control = nums.pop("control")
        print(json.dumps({"workload": cell.name, "seed": seed, "program": nums,
                          "control": control, "setup": out.run.setup_parts,
                          "seconds": time.perf_counter() - t}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
