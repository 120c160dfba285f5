"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``kernels/_build/`` (listed in ``.gitignore``) and loaded with
``ctypes``. A build may set preprocessor macros (``defines``) and a
``prelude``: C++ text put before the source (through a generated
wrapper source under ``_build/`` that includes it), for macros whose text
does not pass as one ``-D`` argument, such as a generated scatter
expression. The library's file name carries a hash of the sources
(``csrc/<name>.cu`` and every ``csrc/*.cuh``), the flags, the macros and
the prelude, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time; a failed build raises with
``nvcc``'s log.
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


def library_path(name: str, prelude: str = "", **defines) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    if prelude:
        h.update(b"\0prelude\0" + prelude.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, prelude: str = "", **defines) -> Path:
    """Compile ``csrc/<name>.cu`` with ``-DNAME=value`` for each of
    ``defines``, after ``prelude``, unless an up-to-date library exists;
    returns the library's path. Builds with other macros may run at the
    same time (one ``nvcc`` each)."""
    out = library_path(name, prelude, **defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src = CSRC / f"{name}.cu"
    if prelude:                    # this build's own wrapper source
        src = tmp.with_suffix(".cu")
        src.write_text(f"{prelude}\n#include \"{CSRC / f'{name}.cu'}\"\n")
    cmd = [_nvcc(), *_flags(defines), "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        if prelude:
            src.unlink()
    build_log[out.name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n"
                           f"{build_log[out.name]}")
    os.replace(tmp, out)
    return out


def load(name: str, prelude: str = "", **defines) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` with ``prelude``
    and ``defines``; memoized."""
    key = (name, prelude, tuple(sorted(defines.items())))
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, prelude, **defines)))
            _loaded[key] = lib
        return lib
