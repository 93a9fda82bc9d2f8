"""All-pairs hamming distances over packed bits: the CUDA kernel and its
plain version.

Port of ``tpu_hnsw/ops/pallas_hamming.py::hamming_scan`` (and its wrapper
``hamming_scan_auto``). On a CUDA tensor :func:`hamming_scan` launches
``csrc/hamming_scan.cu`` or raises; on a CPU tensor it runs
:func:`hamming_scan_reference`. Packed words are 32-bit, given as
``torch.int32`` or ``torch.uint32`` (the same bits; numpy's ``uint32``
packs view as int32 without a copy). The library is built by
``ops/_nvcc.py`` at first use.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_hnsw_torch.ops import _nvcc

#: kernel launches so far; a run resets it to show the kernel was used
LAUNCHES = 0

NAME = "hamming_scan"
_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, _P]
# int64 elements of the [Q, chunk, W] XOR temporary per step of the plain
# version
_REF_CHUNK_ELEMS = 1 << 26
_MAX_Q = 65535 * 32  # the kernel's grid: 65535 tiles of 32 queries


def words(t: torch.Tensor) -> torch.Tensor:
    """Packed 32-bit words as int32 (a view: the bits are unchanged)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 or uint32, not {t.dtype}")
    return t


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of 32-bit words (int32/uint32) as int32: the
    reference's SWAR reduction, widened to int64 (torch has no unsigned
    shift on 32-bit words, and an int32 right shift would carry the sign)."""
    v = words(x).to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def hamming_scan_reference(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`hamming_scan` (same arguments),
    chunked over the rows of ``x`` to bound its ``[Q, chunk, W]``
    temporaries."""
    q, x = words(q), words(x)
    Q, W = q.shape
    N = x.shape[0]
    out = torch.empty((Q, N), dtype=torch.int32, device=x.device)
    step = max(1, _REF_CHUNK_ELEMS // max(Q * W, 1))
    for s in range(0, N, step):
        xo = q[:, None, :] ^ x[None, s:s + step, :]
        out[:, s:s + step] = popcount(xo).sum(-1, dtype=torch.int32)
    return out


def _check(name, t, W, device):
    if t.ndim != 2 or t.shape[1] != W:
        raise ValueError(f"{name}: expected shape [*, {W}], got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def hamming_scan(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Hamming distances of every query against every row: ``[Q, N]`` int32.

    q ``[Q, W]`` and x ``[N, W]`` packed 32-bit words (int32 or uint32),
    on one device; any W >= 1, ragged Q and N.
    """
    global LAUNCHES
    q, x = words(q), words(x)
    if x.device.type == "cpu":
        return hamming_scan_reference(q, x)
    if x.device.type != "cuda":
        raise ValueError(f"hamming_scan: no kernel for {x.device}")
    W = x.shape[1] if x.ndim == 2 else -1
    _check("x", x, W, x.device)
    _check("q", q, W, x.device)
    Q, N = q.shape[0], x.shape[0]
    if W < 1 or Q > _MAX_Q:
        raise ValueError(f"hamming_scan: needs W >= 1 and Q <= {_MAX_Q}")
    vec = 4 if W % 4 == 0 and x.data_ptr() % 16 == 0 else 1
    out = torch.empty((Q, N), dtype=torch.int32, device=x.device)
    lib = _nvcc.load_library(NAME, "hamming_scan_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.hamming_scan_launch(vec, q.data_ptr(), x.data_ptr(),
                                      out.data_ptr(), Q, N, W, stream)
    if err != 0:
        raise RuntimeError(f"hamming_scan kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
