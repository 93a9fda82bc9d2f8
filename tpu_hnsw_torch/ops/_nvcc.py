"""Build and load the port's CUDA kernel libraries.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` at first use into ``tpu_hnsw_torch/_build/
<name>-<hash>.so``, where the hash covers the source and the flags, so a
changed source gets a new file. Libraries load with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(_PKG, "csrc", f"{name}.cu")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to a CUDA toolkit")
    return found


def library_path(name: str) -> str:
    """Where the library for the current source lives (content-addressed)."""
    with open(source_path(name), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_library(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` if this source has not been built.
    Returns (path, compiler output; empty when already built)."""
    path = library_path(name)
    if os.path.exists(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: two processes building at once is safe
    return path, proc.stdout + proc.stderr


def load_library(name: str, symbols: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load a kernel library once per process, with
    ``argtypes`` declared on each of its launch functions (``symbols``:
    name -> argtypes; each returns int)."""
    lib = _loaded.get(name)
    if lib is None:
        path, _ = build_library(name)
        lib = ctypes.CDLL(path)
        for symbol, argtypes in symbols.items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
