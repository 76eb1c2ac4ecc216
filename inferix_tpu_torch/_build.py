"""Build the port's CUDA kernels with `nvcc`, and its host C++ with the
host compiler, and load them with `ctypes`.

Each source under `csrc/` has a plain C interface and includes no PyTorch
header, so `nvcc` builds it in seconds; `build` starts one nvcc per source,
all at once. `load_host_library` builds a host `.cpp` with a plain C
interface (`native/frame_pipe.cpp`) with `g++`. A library is built at most
once per process, into `inferix_tpu_torch/_build/` (listed in .gitignore),
under a name keyed by a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused. A failed build raises with the
compiler's output.
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

HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

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


def _lib_path(src: pathlib.Path, flags: Sequence[str]) -> pathlib.Path:
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{key}.so"


def _cu_path(name: str) -> pathlib.Path:
    return _lib_path(CSRC / f"{name}.cu", NVCC_FLAGS)


def build(names: Sequence[str], verbose: bool = False) -> None:
    """Build `csrc/<name>.cu` for each name whose library is missing, one
    nvcc process per source, all started together. verbose=True adds
    `-Xptxas -v` and prints each nvcc's output."""
    todo = [n for n in names if not _cu_path(n).exists()]
    if not todo:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = NVCC_FLAGS + (("-Xptxas", "-v") if verbose else ())
    jobs = []
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *flags, "-o", tmp, str(CSRC / f"{name}.cu")],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in jobs:
        out, _ = proc.communicate()
        if verbose:
            print(f"nvcc {name}.cu:\n{out}", flush=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed to build {name}.cu:\n{out}")
        else:
            os.replace(tmp, _cu_path(name))  # atomic: no half-written library
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str, verbose: bool = False) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` into a shared library (once per process) and
    load it."""
    with _LOCK:
        if name not in _LIBS:
            build([name], verbose)
            _LIBS[name] = ctypes.CDLL(str(_cu_path(name)))
        return _LIBS[name]


def load_host_library(src: pathlib.Path) -> ctypes.CDLL:
    """Build the host C++ source `src` with HOST_CXX (once per process; kept
    across processes in the build directory) and load it."""
    name, cxx = src.stem, HOST_CXX
    with _LOCK:
        if name not in _LIBS:
            so = _lib_path(src, (cxx,) + HOST_FLAGS)
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    res = subprocess.run([cxx, *HOST_FLAGS, str(src), "-o", tmp],
                                         capture_output=True, text=True)
                except OSError as e:
                    os.unlink(tmp)
                    raise RuntimeError(f"{cxx} failed to build {src.name}: {e}") from e
                if res.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"{cxx} failed to build {src.name}:\n"
                                       f"{res.stdout}{res.stderr}")
                os.replace(tmp, so)
            _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]
