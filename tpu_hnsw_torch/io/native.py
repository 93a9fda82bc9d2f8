"""ctypes bindings for the port's native IO library (``cpp/io_native.cpp``;
port of ``tpu_hnsw/io/native.py``).

The library is compiled by ``g++`` at first use into ``tpu_hnsw_torch/
_build/io_native-<hash>.so``, where the hash covers the source and the
flags, so a changed source gets a new file and the reference's library
(built elsewhere, from its own copy) is never loaded. On a host without
``g++`` :func:`load` returns None and every entry takes its numpy
version; where ``g++`` exists, a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCE = os.path.join(_PKG, "cpp", "io_native.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
_SIGNATURES = {
    # name: (restype, argtypes)
    "fvecs_read": (_L, [ctypes.c_char_p, _P, _L, _I, _I]),
    "fvecs_shape": (_I, [ctypes.c_char_p, ctypes.POINTER(_L),
                         ctypes.POINTER(_I)]),
    "bvecs_read": (_L, [ctypes.c_char_p, _P, _L, _I]),
    "blob_write": (_L, [ctypes.c_char_p, _P, _L, _I]),
    "blob_read": (_L, [ctypes.c_char_p, _P, _L, _I]),
    "balanced_assign_greedy": (_L, [_P, _P, _L, _I, _L, _P, _P]),
}


def library_path() -> str:
    """Where the library for the current source lives (content-addressed)."""
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"io_native-{h.hexdigest()[:16]}.so")


def _build() -> str:
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on io_native.cpp ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: two processes building at once is safe
    return path


def load() -> ctypes.CDLL | None:
    """Compile (once) and load the native library. None on a host without
    ``g++`` (the numpy versions then serve); raises if ``g++`` is there and
    the build or load fails."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if shutil.which("g++") is None:
            return None
        lib = ctypes.CDLL(_build())
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIB = lib
        return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def read_fvecs_native(path: str, count: int | None = None
                      ) -> np.ndarray | None:
    """Rows of an .fvecs file as ``[n, d]`` f32; None without the library
    or when the file is not a readable fvecs file."""
    lib = load()
    if lib is None:
        return None
    rows, dim = _L(), _I()
    if lib.fvecs_shape(path.encode(), ctypes.byref(rows),
                       ctypes.byref(dim)) != 0:
        return None
    n = rows.value if count is None else max(0, min(rows.value, count))
    out = np.empty((n, dim.value), np.float32)
    if n == 0:  # max_rows 0 means "all rows" to the C side
        return out
    got = lib.fvecs_read(path.encode(), _ptr(out), n, 0, 0)
    if got < 0:
        return None
    return out[:got]


def read_bvecs_native(path: str, count: int | None = None
                      ) -> np.ndarray | None:
    """Rows of a .bvecs file (uint8 components) as ``[n, d]`` f32; None
    without the library or when the file is not a readable bvecs file."""
    lib = load()
    if lib is None:
        return None
    size = os.path.getsize(path)
    if size < 4:
        return None
    d = int(np.fromfile(path, np.int32, 1)[0])
    if d <= 0:
        return None
    total = size // (4 + d)
    n = total if count is None else max(0, min(total, count))
    out = np.empty((n, d), np.float32)
    if n == 0:
        return out
    got = lib.bvecs_read(path.encode(), _ptr(out), n, 0)
    if got < 0:
        return None
    return out[:got]


def blob_write(path: str, arr: np.ndarray) -> bool:
    """Write ``arr``'s bytes (C order) to ``path``."""
    lib = load()
    data = np.ascontiguousarray(arr)
    if lib is None:
        data.tofile(path)
        return True
    raw = data.view(np.uint8).reshape(-1)
    return lib.blob_write(path.encode(), _ptr(raw), raw.nbytes, 0) \
        == raw.nbytes


def blob_read(path: str, shape, dtype) -> np.ndarray:
    """An array of ``shape`` and ``dtype`` from a blob written by
    :func:`blob_write`."""
    lib = load()
    if lib is None:
        return np.fromfile(path, dtype).reshape(shape)
    out = np.empty(shape, dtype)
    raw = out.view(np.uint8).reshape(-1)
    if lib.blob_read(path.encode(), _ptr(raw), raw.nbytes, 0) != raw.nbytes:
        return np.fromfile(path, dtype).reshape(shape)
    return out


def balanced_assign_greedy_native(
    cand_i: np.ndarray, cand_d: np.ndarray, n_blocks: int,
    assign: np.ndarray, free: np.ndarray
) -> int | None:
    """Native greedy capacity-balanced assignment (see io_native.cpp).

    cand_i [n, t] int32 C-contiguous, cand_d [n, t] float32, assign [n]
    int64 pre-filled -1 (mutated), free [B] int64 capacities (mutated).
    Returns rows assigned, or None when the native library is missing.
    Raises ValueError for arrays of another dtype, layout or shape (the C
    side would read or write past them).
    """
    lib = load()
    if lib is None:
        return None
    want = ((cand_i, np.int32, 2), (cand_d, np.float32, 2),
            (assign, np.int64, 1), (free, np.int64, 1))
    for a, dt, nd in want:
        if (not isinstance(a, np.ndarray) or a.dtype != dt or a.ndim != nd
                or not a.flags.c_contiguous):
            raise ValueError("balanced_assign_greedy_native: expected "
                             "C-contiguous cand_i int32 [n, t], cand_d "
                             "float32 [n, t], assign int64 [n], free int64 "
                             "[B]")
    n, t = cand_i.shape
    if (cand_d.shape != (n, t) or assign.shape != (n,)
            or free.shape != (n_blocks,)):
        raise ValueError("balanced_assign_greedy_native: shapes disagree")
    return int(lib.balanced_assign_greedy(
        _ptr(cand_i), _ptr(cand_d), n, t, n_blocks, _ptr(assign),
        _ptr(free)))
