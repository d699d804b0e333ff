"""Build the port's CUDA sources with nvcc into plain-C shared libraries and
load them with ctypes.

Each source under ``csrc/`` becomes ``_build/lib<name>-<hash>.so`` (the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source rebuilds). Builds run at first use, never at import;
``build_all`` starts one nvcc per source, all at once, and each nvcc runs
its optimisation passes on all cores (``--split-compile=0``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("write_attend", "decode_attend", "codec_kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--split-compile=0",
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


def run_nvcc(jobs: dict, flags=NVCC_FLAGS) -> dict:
    """Compile csrc/<name>.cu into each ``jobs[name]`` path, one nvcc per
    source, all started together. Returns {name: (return code, seconds,
    nvcc's output)}, each build's own seconds, whichever ends first."""
    running = {}
    for name, out in jobs.items():
        log = Path(f"{out}.log")
        cmd = [find_nvcc(), *flags, "-o", str(out), str(CSRC / f"{name}.cu")]
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
        running[name] = (proc, log, time.perf_counter())
    done = {}
    while running:
        time.sleep(0.05)
        for name, (proc, log, t0) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds = time.perf_counter() - t0
            del running[name]
            done[name] = (proc.returncode, seconds, log.read_text())
            log.unlink()
    return done


def build_all(names=SOURCES) -> list[Built]:
    """Build each csrc/<name>.cu that is not built yet, one nvcc process per
    source, all started together; raises with nvcc's output when a build
    fails."""
    jobs = {}
    for name in names:
        if name in _BUILT:
            continue
        target = _target(name)
        if target.exists():
            _BUILT[name] = Built(name, target, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs[name] = target.with_suffix(f".{os.getpid()}.tmp")
    failed = []
    for name, (rc, seconds, log) in run_nvcc(jobs).items():
        if rc != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        target = _target(name)
        os.replace(jobs[name], target)
        _BUILT[name] = Built(name, target, seconds, log)
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


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float}


@functools.lru_cache(maxsize=None)
def launcher(name: str, signature: str, symbol=None):
    """The C launcher ``symbol`` (default ``<name>_launch``) of
    csrc/<name>.cu, built and loaded at first use; ``signature`` spells its
    arguments, p for a pointer (the stream last), i for an int, l for a
    64-bit int, f for a float. Returns a cudaError_t."""
    fn = getattr(load(name), symbol or f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [_CTYPES[c] for c in signature]
    return fn
