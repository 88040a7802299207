"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`build/torch_kernels/lib<name>-<hash>.so` at the root of the checkout, where
<hash> is taken over the source and the flags, so an edited source rebuilds
and an unchanged one is reused. Nothing is built at import: the first call
that needs a library builds it (`load`). nvcc's `-Xptxas -v` report
(registers, shared memory, spills) is kept beside each library and returned
by `ptxas_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA toolkit's nvcc; raises when no toolkit is found."""
    from torch.utils.cpp_extension import CUDA_HOME

    if not CUDA_HOME:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _paths(name: str):
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = BUILD_DIR / f"lib{name}-{digest}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def _build(name: str) -> Path:
    """Compile csrc/<name>.cu unless built already; raises with nvcc's output."""
    src, lib, log = _paths(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def library_path(name: str) -> Path:
    """Where `load` builds csrc/<name>.cu's library for the current source."""
    return _paths(name)[1]


def ptxas_report(name: str) -> str:
    """nvcc's -Xptxas -v output from building `name` (empty if not built here)."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_build(name)))
        return lib
