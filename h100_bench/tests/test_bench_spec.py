"""The harness finds everything of a cell by name, and a cell dropped in as
files and a BENCHMARK.json entry runs with no file edited."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench.core import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads_with_its_files():
    bench = spec.load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        assert cell.traffic["limits"], w["name"]
        assert cell.config["reference"] in ("llama", "gpt2")
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_benchmark_file_keeps_the_contract():
    bench = spec.load_benchmark(ROOT)
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    ends = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in ends
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for c in bench["configs"]:
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).exists()
    for x in bench["configs"] + bench["workloads"]:
        assert 1 <= len(x["why"]) <= 200


def test_a_dropped_in_cell_needs_no_edit(tmp_path):
    """Copy the benchmark, add a traffic file and BENCHMARK.json entries for
    it and for the Mistral configuration whose file the benchmark keeps: the
    new cell loads with the existing files, metrics and code."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((ROOT / "h100_bench/workloads/mistral7b-h84-chat.json").read_text())
    traffic.update(batch=64, prompt_min=2048, prompt_max=4096)
    (tmp_path / "h100_bench/workloads/mistral7b-h84-4k.json").write_text(json.dumps(traffic))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    if all(c["name"] != "mistral-7b-v0.3" for c in bench["configs"]):
        bench["configs"].append({
            "name": "mistral-7b-v0.3", "file": "h100_bench/configs/mistral-7b-v0.3.json",
            "source": "https://huggingface.co/mistralai/Mistral-7B-v0.3/blob/main/config.json",
            "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "mistral7b-h84-4k", "config": "mistral-7b-v0.3",
                               "traffic": "mistral7b-h84-4k", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (ROOT / "h100_bench").rglob("*.json")}
    cell = spec.load_cell("mistral7b-h84-4k", tmp_path)
    assert cell.traffic["batch"] == 64 and cell.config["hidden_size"] == 4096
    assert before == {p: p.read_bytes() for p in (ROOT / "h100_bench").rglob("*.json")}


def test_run_refuses_without_a_card_or_the_program(tmp_path):
    """run.py prints no result and exits non-zero in a directory holding only
    BENCHMARK.json and the benchmark's files (no program), and on a machine
    with no card."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                           "gpt2-golay-counts-1k", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and done.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    done = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                           "gpt2-golay-counts-1k", "--seed", "5100000002", "--seconds", "2"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["correct"] and list(line)[-1] == "checks"
    assert {"decode_tok_s", "setup_s", "token_gap_ms_p95"} <= set(line["metrics"])
