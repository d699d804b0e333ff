"""Build the port's CUDA sources with nvcc into plain-C shared libraries and
load them with ctypes.

Each source under ``csrc/`` becomes ``_build/lib<name>-<hash>.so`` (the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source rebuilds). Builds run at first use, never at import;
``build_all`` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("write_attend", "decode_attend")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas registers, shared memory, spills)


_BUILT: dict[str, Built] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, torch's CUDA_HOME, or
    /usr/local/cuda/bin; raises when there is none."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    homes.append("/usr/local/cuda")
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in CUDA_HOME, CUDA_PATH, torch's CUDA_HOME, "
        "/usr/local/cuda/bin and PATH): the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> list[Built]:
    """Build each csrc/<name>.cu that is not built yet, one nvcc process per
    source, all started together; raises with nvcc's output when a build
    fails."""
    todo = {}
    for name in names:
        if name in _BUILT:
            continue
        target = _target(name)
        if target.exists():
            _BUILT[name] = Built(name, target, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        todo[name] = (proc, tmp, target, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, t0) in todo.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, target)
        _BUILT[name] = Built(name, target, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_BUILT[name] for name in names]


def build(name: str) -> Built:
    """Build csrc/<name>.cu unless it is built already."""
    return build_all((name,))[0]


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, building it first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name).path))
    return _LIBS[name]
