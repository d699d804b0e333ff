"""Everything the harness knows of a cell, found by name.

``BENCHMARK.json`` at the checkout's root names each cell's configuration
and traffic. The rest lives in files of their own under ``h100_bench/``:

  configs/<config>.json     the configuration as run (sizes, dtype, the
                            port's model name, and under ``"reference"``
                            the name of its architecture's two modules)
  archs/<name>.py           the architecture as the harness runs and
                            counts it (archs/__init__.py says what it gives)
  reference/<name>.py       its plain float32 model, with the cache rows
                            and window of each layer (reference/forward.py)
  workloads/<traffic>.json  the traffic mix and the cell's check limits
  metrics/<metric>.py       one reader a metric, ``read(run) -> float|None``

A later cell, configuration or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes. A new architecture is new files
too: its configuration file, a traffic file, ``archs/<name>.py``,
``reference/<name>.py`` and the ``BENCHMARK.json`` entries, beside the
port's model in the program; ``<name>`` is an import name. A cell over a
cache mode that ``reference/arms.py`` does not hold needs the reference
extended first.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # configs/<config>.json
    traffic_name: str
    traffic: dict  # workloads/<traffic>.json
    end_to_end: list  # the BENCHMARK.json metric entries this cell reports
    per_layer: list


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its files; raises KeyError
    for a name the benchmark does not hold."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR.name / "workloads" / f"{w['traffic']}.json").read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_module(path: Path, name: str):
    """A module from a file path (metric names hold dots, so they are not
    import names)."""
    spec = importlib.util.spec_from_file_location(f"h100_bench_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def arch_module(config: dict):
    """archs/<name>.py of a configuration file, ``<name>`` its
    ``"reference"``."""
    return importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.archs.{config['reference']}")


def metric_reader(name: str):
    """metrics/<name>.py's ``read``."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", name).read
