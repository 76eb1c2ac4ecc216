"""Build the port's CUDA kernels with `nvcc` and load them with `ctypes`.

Each source under `csrc/` has a plain C interface and includes no PyTorch
header, so `nvcc` builds it in seconds. A library is built at most once per
process, into `inferix_tpu_torch/_build/` (listed in .gitignore), under a
name keyed by a hash of its source and flags, so an edited source is rebuilt
and an unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Sequence

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# Where nvcc is looked for after $CUDA_HOME/bin, before PATH.
CUDA_BIN_DIRS: Sequence[str] = ("/usr/local/cuda/bin",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    """$CUDA_HOME/bin/nvcc, then /usr/local/cuda/bin/nvcc, then PATH."""
    candidates: List[pathlib.Path] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates += [pathlib.Path(d) / "nvcc" for d in CUDA_BIN_DIRS]
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "inferix_tpu_torch: nvcc not found (looked in $CUDA_HOME/bin, "
        f"{', '.join(CUDA_BIN_DIRS)} and PATH); the CUDA kernels are built "
        "with nvcc at first use on a machine with the CUDA toolkit")


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` into a shared library (once per process) and
    load it. verbose=True adds `-Xptxas -v` and prints nvcc's output."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        src = CSRC / f"{name}.cu"
        flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
        key = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib_path = BUILD_DIR / f"lib{name}-{key}.so"
        if not lib_path.exists():
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.run([nvcc, *flags, "-o", tmp, str(src)],
                                  capture_output=True, text=True)
            if verbose:
                print(proc.stdout + proc.stderr, flush=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed to build {src.name}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)  # atomic: no half-written library
        _LIBS[name] = ctypes.CDLL(str(lib_path))
        return _LIBS[name]
