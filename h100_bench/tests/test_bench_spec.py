"""The harness finds everything of a cell by name, and a cell, or a new
architecture, dropped in as files and BENCHMARK.json entries runs with no
file edited."""

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
        name = cell.config["reference"]
        assert (spec.BENCH_DIR / "archs" / f"{name}.py").is_file(), name
        assert (spec.BENCH_DIR / "reference" / f"{name}.py").is_file(), name
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


# A third architecture, as a model_config change would add it: the port's
# tiny-llama under another name, with configuration keys of its own.
THIRD_CONFIG = {"d_model": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
                "vocab": 256, "rope_theta": 10000.0, "eps": 1e-5, "torch_dtype": "float32",
                "port_model": "tiny-llama", "reference": "third"}
THIRD_AS_LLAMA = '''
def as_llama(config):
    return {"hidden_size": config["d_model"], "num_hidden_layers": config["n_layers"],
            "num_attention_heads": config["n_heads"], "num_key_value_heads": config["n_kv_heads"],
            "intermediate_size": config["d_ff"], "vocab_size": config["vocab"],
            "rope_theta": config["rope_theta"], "rms_norm_eps": config["eps"],
            "tie_word_embeddings": False, "sliding_window": None,
            "torch_dtype": config["torch_dtype"]}
'''
THIRD_ARCH = '''"""The third architecture's sizes, weights and counts."""
from . import llama
''' + THIRD_AS_LLAMA + '''

def port_sizes(config):
    return llama.port_sizes(as_llama(config))


make_weights = llama.make_weights


def layers(config):
    E, H, Hkv, D = config["d_model"], config["n_heads"], config["n_kv_heads"], 16
    mats = E * (H + 2 * Hkv) * D + H * D * E + 3 * E * config["d_ff"]
    return [{"heads": H, "qk_width": D, "pv_width": D, "rows": [("k", Hkv, D), ("v", Hkv, D)],
             "window": None, "products_active": mats, "products_held": mats, "small": 2 * E}
            for _ in range(config["n_layers"])]


def model(config):
    return llama.model(as_llama(config))
'''
THIRD_REFERENCE = '''"""The third architecture's plain model."""
from . import forward
from .llama import Model as Llama
''' + THIRD_AS_LLAMA + '''

class Model(Llama):
    def __init__(self, config, weights, rnd):
        super().__init__(as_llama(config), weights, rnd)

    def cache(self, layer):
        return [("k", self.Hkv, self.D), ("v", self.Hkv, self.D)]

    def window(self, layer):
        return None

    def attend(self, layer, q, k, v, mask, rnd, edge=None):
        return forward.attend(q, k, v, mask, rnd, edge)
'''
RUN_THIRD = '''
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(1)
from h100_bench.core import counts, spec
from h100_bench.tests import tiny
cell = spec.load_cell("third-tiny-interp", spec.ROOT)
out, nums, correct = tiny.run(cell.config, cell.traffic)
nums.pop("detail")
print(json.dumps({"correct": correct, "nums": nums, "rounds": out.served.rounds,
                  "bench": spec.BENCH_DIR.as_posix(),
                  "arch": spec.arch_module(cell.config).__file__,
                  "params": counts.matmul_params(out.run.model),
                  "step_mfu": spec.metric_reader("step_mfu")(out.run)}))
'''


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}


def test_a_dropped_in_cell_needs_no_edit(tmp_path):
    """Copy the benchmark, add a traffic file and BENCHMARK.json entries for
    it and for the Mistral configuration whose file the benchmark keeps: the
    new cell loads with the existing files, metrics and code. Then add a
    third architecture as new files alone (archs/ and reference/ modules,
    its configuration and traffic files, BENCHMARK.json entries): its cell
    runs through the tiny CPU session correct, and every file the copy had
    but BENCHMARK.json is byte for byte as it was."""
    before = _copy(tmp_path)
    root_files = {p: p.read_bytes() for p in (ROOT / "h100_bench").rglob("*.json")}
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
    cell = spec.load_cell("mistral7b-h84-4k", tmp_path)
    assert cell.traffic["batch"] == 64 and cell.config["hidden_size"] == 4096

    from h100_bench.tests import tiny

    new = {"h100_bench/archs/third.py": THIRD_ARCH,
           "h100_bench/reference/third.py": THIRD_REFERENCE,
           "h100_bench/configs/third-tiny.json": json.dumps(THIRD_CONFIG),
           "h100_bench/workloads/third-tiny-interp.json": json.dumps(
               tiny.traffic("int4-hamming84-interp"))}
    for path, text in new.items():
        assert not (tmp_path / path).exists()
        (tmp_path / path).write_text(text)
    bench["configs"].append({"name": "third-tiny", "file": "h100_bench/configs/third-tiny.json",
                             "source": "a test", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "third-tiny-interp", "config": "third-tiny",
                               "traffic": "third-tiny-interp", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    done = subprocess.run([sys.executable, "-c", RUN_THIRD, str(tmp_path), str(ROOT)],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert line["bench"] == (tmp_path / "h100_bench").as_posix()
    assert line["arch"] == str(tmp_path / "h100_bench/archs/third.py")
    assert line["correct"] and line["rounds"] >= 1, line
    assert line["nums"]["logit_gap"] == 0.0 and line["nums"]["bad_codewords"] == 0, line
    assert line["params"] == 2 * (64 * 8 * 16 + 64 * 64 + 3 * 64 * 128) + 64 * 256
    assert line["step_mfu"] > 0
    after = {p: p.read_bytes() for p in tmp_path.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert set(after) - set(before) == {tmp_path / p for p in new} | {
        tmp_path / "h100_bench/workloads/mistral7b-h84-4k.json"}
    assert {p: b for p, b in before.items() if p.name != "BENCHMARK.json"} == {
        p: after[p] for p in before if p.name != "BENCHMARK.json"}
    assert root_files == {p: p.read_bytes() for p in (ROOT / "h100_bench").rglob("*.json")}


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
