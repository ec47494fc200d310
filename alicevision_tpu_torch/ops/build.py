"""Build the port's CUDA sources at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and compiles alone with
`nvcc` into a shared library under `alicevision_tpu_torch/_build/` (listed
in .gitignore). The library's file name carries a hash of its source and
flags, so an edited source rebuilds and an unchanged one is reused. Nothing
here runs at import time: a CPU-only machine without `nvcc` imports the port
and never builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills into the build log
]
SOURCES = ("sgm_directional",)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for one source; None if its library is already built."""
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job) -> str:
    proc, tmp, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return log


def build_all(names=SOURCES) -> dict:
    """Build every source in parallel (one nvcc each, all started together).
    Returns {name: (seconds, nvcc log)}; a cached library reports 0 s."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in names}
    out = {}
    for name, job in jobs.items():
        log = "" if job is None else _finish(name, job)
        out[name] = (time.perf_counter() - t0, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    if name not in _LOADED:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
