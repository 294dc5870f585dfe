"""Build and load the package's CUDA kernels.

Each kernel is one `.cu` file under `quantpy_tpu_torch/csrc/` with a plain C
interface. It is compiled at first use with `nvcc` for `sm_90a` into a
shared library under `quantpy_tpu_torch/_build/` and loaded with `ctypes`.
The library's name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. Nothing here runs on
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load", "nvcc_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}

#: seconds and compiler output of the builds made in this process, by name
build_log: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    """The `nvcc` of $CUDA_HOME, of /usr/local/cuda, or on $PATH."""
    candidates = [
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
    ]
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into _build/ unless an up-to-date library is
    there; return the library's path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{name}-{digest[:12]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    output = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src.name}:\n{output}")
    os.replace(tmp, lib)
    build_log[name] = (seconds, output)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
