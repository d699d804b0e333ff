"""Guards of the PyTorch/CUDA port: it imports neither JAX nor the JAX package,
chip_smoke.py fails without the card or without the package, and entry
points given no device run on the card or raise."""

import ast
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from qkv_ecc_tpu_torch.cache.layout import ECCCacheConfig, allocate_ecc_kv_cache  # noqa: E402
from qkv_ecc_tpu_torch.device import resolve_device  # noqa: E402
from qkv_ecc_tpu_torch.models.config import TINY_LLAMA  # noqa: E402
from qkv_ecc_tpu_torch.models.kv_policy import policy_for_mode  # noqa: E402
from qkv_ecc_tpu_torch.models.llama import params_from_jax  # noqa: E402
from qkv_ecc_tpu_torch.models.registry import init_params  # noqa: E402
from qkv_ecc_tpu_torch.models.runtime import generate, init_generation_state  # noqa: E402

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "qkv_ecc_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _run(code_or_args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *code_or_args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qkv_ecc_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'qkv_ecc_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'qkv_ecc_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = _run(["-c", code], ROOT)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 12


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "qkv_ecc_tpu"), (path, name)


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    for cwd in (tmp_path, ROOT):
        if cwd == ROOT and torch.cuda.is_available():
            continue  # with a card the run from the repository is the real one
        r = _run(["chip_smoke.py"], cwd)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_entry_points_need_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means that card")
    pol = policy_for_mode("int12-golay", ber=1e-2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(TINY_LLAMA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_generation_state(TINY_LLAMA, pol, 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        allocate_ecc_kv_cache(ECCCacheConfig(num_blocks=2, block_size=16, num_layers=1,
                                             num_kv_heads=2, head_dim=16))
    params = init_params(TINY_LLAMA, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(params, np.zeros((1, 4), np.int64), TINY_LLAMA, pol, max_new_tokens=2)
    np_params = {k: v.numpy() for k, v in params.items() if k != "layers"}
    np_params["layers"] = [{k: v.numpy() for k, v in lp.items()} for lp in params["layers"]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(np_params, TINY_LLAMA)
    assert resolve_device("cpu") == torch.device("cpu")
