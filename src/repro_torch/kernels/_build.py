"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``kernels/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. A build may set preprocessor macros (``defines``). The
library's file name carries a hash of the source, flags and macros, so
an edited source rebuilds and an unchanged one is reused. Nothing here
runs at import time; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
build_log: dict = {}       # library file name -> nvcc's output (ptxas report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin); the CUDA kernels cannot "
                           "be built")
    return nvcc


def _flags(defines: dict) -> list:
    return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted(defines.items()))]


def library_path(name: str, **defines) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, **defines) -> Path:
    """Compile ``csrc/<name>.cu`` with ``-DNAME=value`` for each of
    ``defines`` unless an up-to-date library exists; returns the
    library's path. Builds with other macros may run at the same time
    (one ``nvcc`` each)."""
    out = library_path(name, **defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log[out.name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n"
                           f"{build_log[out.name]}")
    os.replace(tmp, out)
    return out


def load(name: str, **defines) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` with ``defines``;
    memoized."""
    key = (name, tuple(sorted(defines.items())))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, **defines)))
            _loaded[key] = lib
        return lib
