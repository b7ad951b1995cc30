"""Builds the port's CUDA C++ kernels with nvcc and loads them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled for
Hopper (``sm_90a``) into a shared library under ``ray_tpu_torch/_build/``
(git-ignored) at first use. The library's name carries a hash of its source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built when a module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "int8_matmul": "int8_matmul.cu",
           "decode_attention": "decode_attention.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output of each library built by this process (with ptxas's register,
# shared-memory and spill report when built verbose).
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (on PATH, under $CUDA_HOME or /usr/local/cuda): "
            "the port's CUDA kernels are built from source at first use"
        )
    return str(path)


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None,
          verbose: bool = False) -> Dict[str, Path]:
    """Compiles the named kernels (default: all) that are not built yet, one
    nvcc process per source, all started together. ``verbose`` prints
    nvcc's output with ptxas's register and spill report for each kernel.
    Returns {name: library path}; raises with nvcc's output on failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
            tmp, out,
        )
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        os.replace(tmp, out)
        BUILD_LOGS[name] = log
        if verbose:
            print(f"[build {name}]\n{log}", flush=True)
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
        return lib
