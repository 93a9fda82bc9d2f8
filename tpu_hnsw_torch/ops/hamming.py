"""Hamming scans over packed bits: the CUDA kernels and their plain versions.

Port of ``tpu_hnsw/ops/pallas_hamming.py::hamming_scan`` (and its wrapper
``hamming_scan_auto``), plus the top-k that ``BinaryFlatIndex.search``
runs after it, fused. Two entries:

- :func:`hamming_scan`: all pairs, ``[Q, N]`` int32 hamming counts;
- :func:`hamming_topk`: the ``k`` nearest rows of each query by hamming or
  jaccard distance, ordered by (distance, id), without a ``[Q, N]`` matrix.

On a CUDA tensor each launches ``csrc/hamming_scan.cu`` or raises; on a CPU
tensor each runs its plain version (:func:`hamming_scan_reference`,
:func:`hamming_topk_reference`). Packed words are 32-bit, given as
``torch.int32`` or ``torch.uint32`` (the same bits; numpy's ``uint32``
packs view as int32 without a copy). The library is built by
``ops/_nvcc.py`` at first use.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_hnsw_torch.ops import _nvcc
from tpu_hnsw_torch.ops import topk as T

#: launches of either kernel entry so far; a run resets it to show the
#: kernel was used
LAUNCHES = 0
#: launches of the fused top-k entry alone
TOPK_LAUNCHES = 0

NAME = "hamming_scan"
#: the largest k the fused top-k takes (a warp merges lists of <= 128)
TOPK_MAX_K = 128
METRICS = ("hamming", "jaccard")

_P = ctypes.c_void_p
_I, _LL = ctypes.c_int, ctypes.c_longlong
_SCAN_ARGS = [_P, _P, _P, _I, _LL, _I, _LL, _I, _P]
_TOPK_ARGS = [_P, _P, _P, _P, _P, _I, _LL, _I, _LL, _I, _I, _I, _P]
_BQ, _BN = 64, 128  # the kernel's CTA tile: queries x rows
_WAVES = 4          # CTAs per SM the row ranges aim at
# int64 elements of the [Q, chunk, W] XOR temporary per step of the plain
# version
_REF_CHUNK_ELEMS = 1 << 26


def words(t: torch.Tensor) -> torch.Tensor:
    """Packed 32-bit words as int32 (a view: the bits are unchanged)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32)
    if t.dtype != torch.int32:
        raise TypeError(f"packed words must be int32 or uint32, not {t.dtype}")
    return t


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of 32-bit words (int32/uint32) as int32: the
    reference's SWAR reduction in int32 (each mask clears the bits an
    arithmetic shift brings in, and wrapping arithmetic keeps the bits)."""
    v = words(x)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def row_popcount(x: torch.Tensor) -> torch.Tensor:
    """``[R, W]`` packed words -> ``[R]`` int32 bit counts."""
    return popcount(x).sum(-1, dtype=torch.int32)


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


def distances(h: torch.Tensor, pop_q: torch.Tensor, pop_x: torch.Tensor,
              metric: str) -> torch.Tensor:
    """``[Q, N]`` f32 distances from hamming counts: the count itself, or
    jaccard's ``1 - inter / max(union, 1)`` with
    ``inter = (|q| + |x| - h) / 2`` and ``union = (|q| + |x| + h) / 2``
    (the reference's own f32 division of integers)."""
    if metric == "hamming":
        return h.float()  # exact: counts stay below 2^24
    tot = pop_q[:, None] + pop_x[None, :]
    inter = torch.div(tot - h, 2, rounding_mode="floor")
    union = torch.div(tot + h, 2, rounding_mode="floor")
    return 1.0 - inter.float() / torch.clamp_min(union, 1).float()


def hamming_topk_reference(q, x, pop_q, pop_x, k: int, metric: str):
    """Plain PyTorch version of :func:`hamming_topk` (same arguments)."""
    d = distances(hamming_scan_reference(q, x), pop_q, pop_x, metric)
    d, ids = T.topk_smallest_by_index(d, k)
    return d, ids.to(torch.int32)


def _operands(q, x, entry: str):
    """Checked (q, x, Q, N, W) for a launch on ``x``'s CUDA device."""
    q, x = words(q), words(x)
    if x.device.type != "cuda":
        raise ValueError(f"{entry}: no kernel for {x.device}")
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"{entry}: x must be [N, W] with W >= 1")
    N, W = x.shape
    Q = q.shape[0] if q.ndim == 2 else -1
    _nvcc.check("x", x, torch.int32, (N, W), x.device)
    _nvcc.check("q", q, torch.int32, (Q, W), x.device)
    if -(-Q // _BQ) > 65535 or N >= 1 << 31:
        raise ValueError(f"{entry}: at most {65535 * _BQ} queries and "
                         f"2^31 - 1 rows (int32 ids)")
    return q, x, Q, N, W


def _splits(Q: int, N: int, device) -> tuple[int, int]:
    """(rows per range, ranges): contiguous ranges of whole 128-row tiles,
    at most ``_WAVES`` CTAs per SM over all 64-query tiles (rounding down
    keeps the last wave of CTAs full)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-N // _BN)
    want = _WAVES * sms // -(-Q // _BQ)
    per = -(-tiles // max(1, min(want, tiles))) * _BN
    return per, -(-N // per)


def _library():
    return _nvcc.load_library(NAME, {"hamming_scan_launch": _SCAN_ARGS,
                                     "hamming_topk_launch": _TOPK_ARGS})


def hamming_scan(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Hamming distances of every query against every row: ``[Q, N]`` int32.

    q ``[Q, W]`` and x ``[N, W]`` packed 32-bit words (int32 or uint32),
    on one device; any W >= 1, ragged Q and N.
    """
    global LAUNCHES
    if x.device.type == "cpu":
        return hamming_scan_reference(q, x)
    q, x, Q, N, W = _operands(q, x, "hamming_scan")
    out = torch.empty((Q, N), dtype=torch.int32, device=x.device)
    if Q == 0 or N == 0:
        return out
    per, ns = _splits(Q, N, x.device)
    _nvcc.launch(_library(), "hamming_scan_launch", x.device, q.data_ptr(),
                 x.data_ptr(), out.data_ptr(), Q, N, W, per, ns)
    LAUNCHES += 1
    return out


def hamming_topk(q: torch.Tensor, x: torch.Tensor, pop_q: torch.Tensor,
                 pop_x: torch.Tensor, k: int, metric: str = "hamming"):
    """The ``k`` nearest rows of each query: (distances f32 ``[Q, k]``, ids
    int32 ``[Q, k]``), ascending by (distance, id), as ``lax.top_k`` on the
    negated distances orders them.

    q ``[Q, W]``, x ``[N, W]`` packed words; pop_q ``[Q]`` and pop_x ``[N]``
    their int32 row popcounts (:func:`row_popcount`); ``metric`` hamming
    (the count, as f32) or jaccard (``1 - inter / max(union, 1)`` in f32);
    ``1 <= k <= min(N, TOPK_MAX_K)``. On the card each CTA keeps its rows'
    top-k per query and the candidates are merged here.
    """
    global LAUNCHES, TOPK_LAUNCHES
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}")
    if not 1 <= k <= min(x.shape[0], TOPK_MAX_K):
        raise ValueError(f"hamming_topk: need 1 <= k <= min(N, "
                         f"{TOPK_MAX_K}), got k={k} with N={x.shape[0]}")
    if x.device.type == "cpu":
        return hamming_topk_reference(q, x, pop_q, pop_x, k, metric)
    q, x, Q, N, W = _operands(q, x, "hamming_topk")
    _nvcc.check("pop_q", pop_q, torch.int32, (Q,), x.device)
    _nvcc.check("pop_x", pop_x, torch.int32, (N,), x.device)
    if Q == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=x.device),
                torch.empty((0, k), dtype=torch.int32, device=x.device))
    per, ns = _splits(Q, N, x.device)
    cand = torch.empty((Q, ns * k), dtype=torch.int64, device=x.device)
    _nvcc.launch(_library(), "hamming_topk_launch", x.device, q.data_ptr(),
                 x.data_ptr(), pop_q.data_ptr(), pop_x.data_ptr(),
                 cand.data_ptr(), Q, N, W, per, ns, k,
                 int(metric == "jaccard"))
    LAUNCHES += 1
    TOPK_LAUNCHES += 1
    d, ids = T.decode_score_keys(torch.topk(cand, k, dim=1, largest=False,
                                            sorted=True).values)
    return d, ids.to(torch.int32)
