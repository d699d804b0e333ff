"""The import guard: nothing under h100_bench/ imports JAX or the JAX
package, and the reference imports nothing of the program either (top-level
names compared whole: qkv_ecc_tpu_torch is not qkv_ecc_tpu)."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "qkv_ecc_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not (_imports(path) & JAX), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert not (_imports(path) & (JAX | {"qkv_ecc_tpu_torch", "h100_bench"})), path


def test_the_guard_tells_the_names_apart():
    from h100_bench.run import forbidden_modules

    assert forbidden_modules(["qkv_ecc_tpu_torch", "qkv_ecc_tpu_torch.models", "torch"]) == []
    assert forbidden_modules(["qkv_ecc_tpu.codecs", "jax.numpy", "flax"]) == [
        "flax", "jax", "qkv_ecc_tpu"]


def _names_an_architecture(source: str) -> list:
    """Lines that name an architecture: a string "llama" or "gpt2", or a
    comparison with an ``.arch`` or ``["arch"]``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Constant) and node.value in ("llama", "gpt2"):
            found.append(node.lineno)
        elif isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                if (isinstance(side, ast.Attribute) and side.attr == "arch") or (
                        isinstance(side, ast.Subscript) and isinstance(side.slice, ast.Constant)
                        and side.slice.value == "arch"):
                    found.append(node.lineno)
    return found


def test_the_harness_core_names_no_architecture():
    """What an architecture is lives in archs/<name>.py and reference/<name>.py
    alone."""
    paths = sorted((BENCH / "core").glob("*.py")) + [
        BENCH / "reference" / f for f in ("forward.py", "codecs.py", "arms.py")]
    assert {str(p): _names_an_architecture(p.read_text()) for p in paths} == {
        str(p): [] for p in paths}


def test_the_architecture_guard_sees_a_branch():
    src = 'if cfg.arch == "gpt2":\n    pass\nif shape["arch"] != x:\n    pass\ny = "llama"\n'
    assert sorted(_names_an_architecture(src)) == [1, 1, 3, 5]
