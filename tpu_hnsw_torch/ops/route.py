"""Query-centroid routing: each query's nearest centroids of each group.

The exact route of the block engine (``index/block.py``'s
``BlockHnswIndex.search_device``, port of ``tpu_hnsw/index/block.py::
_route_exact_body``), of the stacked searcher (``parallel/
partition.py::ShardedBlockSearcher._route``) and the graph engine's dense
route over its level >= 1 elements (``index/search.py::_scan_seeds_body``,
at ``p`` = ``descent_ef``, 1 by default): f32 scores of every query
against every live centroid and each (query, group) row's ``p`` best,
ascending by (score, index).

Two paths, picked by dtype and shape (:func:`fused`):

- ``"fused"``: f32 centroids and ``p <= MAX_P``. On a CUDA tensor the kernel
  of ``csrc/route_topk.cu`` scores and selects in one pass (no ``[Q, L*b]``
  score matrix; at p 1 with its own top-1 epilogue); on a CPU tensor its
  plain version, :func:`route_topk_reference`.
- ``"gemm_topk"``: any other call (bf16 centroids, wider ``p``): the
  library GEMM (:func:`centroid_scores`), then ``topk_smallest_fast``.

Both paths give the same contract: ids ``[Q, L, p]``, -1 past a group's
live centroids, the stacked offsets folded in.

The kernel library is built by ``ops/_nvcc.py`` at first use and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import _nvcc
from tpu_hnsw_torch.ops import topk as T

#: the route so far by path: ``"fused"`` counts launches of the kernel's
#: entry (``route_topk_launch``: ``route_topk_tile``, then
#: ``route_topk_reduce`` where a group is split), ``"gemm_topk"`` calls of
#: the GEMM + top-k chain, ``"plain"`` fused-path calls on a CPU tensor,
#: which launch nothing; a run resets it to show the path
ROUTE_LAUNCHES = {"fused": 0, "gemm_topk": 0, "plain": 0}

NAME = "route_topk"
#: the widest p the fused path takes. The kernel takes p up to 128 (csrc:
#: kMaxP) but beats the GEMM + top-k chain only up to a width that falls
#: with the rows it fills: on an H100 it wins at every shape measured up to
#: p 16 (0.30-0.55 of the chain's time at 512 and 4,096 queries of SIFT-1M,
#: 0.33-0.52 of DEEP-10M's stacked 8 x 5,127), and from p 34 it loses at
#: 512 queries of SIFT-1M (1.23x, 3.90x at p 105) and at 32 (2.39x)
MAX_P = 16
#: the widest p the kernel takes (csrc: kMaxP)
KERNEL_MAX_P = 128
#: the most centroid ranges a row is split into (csrc: kMaxSplit) and the
#: keys of a row the ranges' merge holds (csrc: kRedKeys)
MAX_SPLIT = 64
SPLIT_KEYS = 1024
#: queries and centroids of a CTA's tile (csrc: kTM, kTN)
TILE = 128
#: the share of the card's CTA slots (SMs x CTAs an SM holds) the grid
#: must fill before a group's centroids stop being split further
FILL = 0.9

_P = ctypes.c_void_p
_I, _LL = ctypes.c_int, ctypes.c_longlong
_ARGS = [_I] + [_P] * 5 + [_LL] + [_I] * 7 + [_LL, _P, _P, _P]


def centroid_scores(centroids, c_sq, q, q_sq, metric: Metric):
    """``[Q, B]`` query-centroid scores: one f32 GEMM (a library GEMM);
    ``q_sq + c_sq - 2 dot`` for L2, ``-dot`` otherwise."""
    dots = q.to(centroids.dtype).float() @ centroids.float().T
    if metric is Metric.L2:
        return q_sq[:, None] + c_sq[None, :] - 2.0 * dots
    return -dots


def fused(centroids: torch.Tensor, p: int) -> bool:
    """Whether :func:`route_topk` takes the fused path for these centroids
    at width ``p`` (else the GEMM + top-k chain)."""
    return centroids.dtype == torch.float32 and 1 <= p <= MAX_P


def _grouped(centroids, c_sq):
    """``[L, b, d]`` centroids and ``[L, b]`` norms (a ``[b, d]`` table is
    one group)."""
    if centroids.dim() == 2:
        return centroids[None], c_sq.reshape(1, -1)
    return centroids, c_sq


def _padded(live, L: int, b: int, device) -> torch.Tensor | None:
    """``[L, b]`` bool: centroid columns at or past a group's live count
    (block.py:303-304); None when every column is live."""
    if live is None:
        return None
    return torch.arange(b, device=device)[None, :] >= live.reshape(L, 1)


def route_topk_reference(centroids, c_sq, q, q_sq, p: int, metric: Metric,
                         *, live=None, offset: bool = False,
                         select=T.topk_smallest_by_index) -> torch.Tensor:
    """Plain PyTorch version of :func:`route_topk` (same arguments):
    :func:`centroid_scores`, padded columns at +inf, then ``select`` (the
    ``(values, ids)`` of each row's k smallest); ids past a group's live
    centroids are -1. The GEMM + top-k chain is this with
    ``topk_smallest_fast`` (lax.top_k's order up to 256 columns, a radix
    top-k above, where the reference's approx_min_k orders ties
    arbitrarily too)."""
    cents, csq = _grouped(centroids, c_sq)
    L, b = csq.shape
    Q = q.shape[0]
    sc = centroid_scores(cents.reshape(L * b, -1), csq.reshape(-1), q, q_sq,
                         metric).view(Q, L, b)
    pad = _padded(live, L, b, sc.device)
    if pad is not None:
        sc = torch.where(pad, torch.inf, sc)
    ids = select(sc, min(p, b))[1]
    if pad is not None:
        ids = torch.where(ids >= live.reshape(1, L, 1).long(), -1, ids)
    if offset:
        base = torch.arange(L, device=ids.device)[None, :, None] * b
        ids = torch.where(ids >= 0, ids + base, -1)
    if p > b:
        ids = torch.cat([ids, ids.new_full((Q, L, p - b), -1)], 2)
    return ids


@functools.lru_cache(maxsize=None)
def _slots(index: int, p: int) -> int:
    """CTAs of the tile kernel the card holds at once at width ``p``: its
    SMs times the CTAs an SM holds (two up to p of about 30, the top-1
    instantiation's too, registers bounding both; one above)."""
    per_sm = _library().route_topk_occupancy(p)
    if per_sm < 1:
        raise RuntimeError(f"route_topk_occupancy failed: {per_sm}")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * per_sm


def split_count(Q: int, L: int, b: int, p: int, slots: int) -> int:
    """Ranges each group's centroids are split into: the fewest whose CTAs
    (query tiles x groups x ranges) fill ``FILL`` of the card's ``slots``,
    else the most, a tile each. A row's ranges are at most ``MAX_SPLIT``
    and hold at most ``SPLIT_KEYS`` keys together. (Measured on an H100 at
    p 8: SIFT-1M's 32 query tiles x 33 tiles take 0.2185 ms at 9 ranges,
    0.287 at 4 and 0.225 at 17; DEEP-10M's 256 CTAs are fastest unsplit.
    The graph route's 32 query tiles x 488 tiles take 8 ranges at p 1.)"""
    tiles = -(-b // TILE)
    rows = -(-Q // TILE) * L
    best = 1
    for S in range(1, max(1, min(MAX_SPLIT, tiles, SPLIT_KEYS // p)) + 1):
        span = -(-tiles // S)
        if -(-tiles // span) != S:  # the same ranges as a smaller S
            continue
        best = S
        if rows * S >= FILL * slots:
            break
    return best


def _library():
    return _nvcc.load_library(NAME, {"route_topk_launch": _ARGS,
                                     "route_topk_occupancy": [_I]})


def _launch(cents, csq, q, q_sq, p: int, metric: Metric, live,
            offset: bool) -> torch.Tensor:
    """The kernel's ids for ``[L, b, d]`` centroids (:func:`route_topk`'s
    contract), at any p it takes, ``KERNEL_MAX_P`` at most."""
    dev = cents.device
    L, b, d = cents.shape
    Q = q.shape[0]
    _nvcc.check("centroids", cents, torch.float32, (L, b, d), dev)
    _nvcc.check("c_sq", csq, torch.float32, (L, b), dev)
    _nvcc.check("q", q, torch.float32, (Q, d), dev)
    _nvcc.check("q_sq", q_sq, torch.float32, (Q,), dev)
    if live is not None:
        _nvcc.check("live", live, torch.int32, (L,), dev)
    if not 1 <= p <= KERNEL_MAX_P:
        raise ValueError(f"route_topk: the kernel takes p in [1, "
                         f"{KERNEL_MAX_P}], got {p}")
    if L * b >= 1 << 31 or Q >= 1 << 31:
        raise ValueError("route_topk: needs fewer than 2^31 queries and "
                         "centroids")
    out = torch.empty((Q, L, p), dtype=torch.int64, device=dev)
    if Q == 0 or L == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    S = split_count(Q, L, b, p, _slots(index, p))
    span = -(-max(b, 1) // (S * TILE)) * TILE
    keys = (torch.empty((Q, L, S, p), dtype=torch.int64, device=dev)
            if S > 1 else None)
    vec = 16 if (d % 4 == 0 and q.data_ptr() % 16 == 0
                 and cents.data_ptr() % 16 == 0) else 4
    _nvcc.launch(
        _library(), "route_topk_launch", dev, vec, q.data_ptr(),
        q_sq.data_ptr(), cents.data_ptr(), csq.data_ptr(),
        None if live is None else live.data_ptr(), Q, L, b, d, p, S, span,
        int(metric is Metric.L2), b if offset else 0,
        None if keys is None else keys.data_ptr(), out.data_ptr())
    ROUTE_LAUNCHES["fused"] += 1
    return out


def route_topk(centroids, c_sq, q, q_sq, p: int, metric: Metric, *,
               live=None, offset: bool = False) -> torch.Tensor:
    """Each query's ``p`` nearest centroids of each group: ``[Q, L, p]``
    int64 ids, ascending by (score, index), ties to the lower index.

    centroids ``[L, b, d]`` (or ``[b, d]``: one group), c_sq ``[L, b]``
    f32, q ``[Q, d]`` f32, q_sq ``[Q]`` f32; scores as
    :func:`centroid_scores`. ``live`` ``[L]`` int32 counts each group's
    live centroids (the rest are padding, never chosen: -1 where a row has
    fewer than ``p``); None: all ``b``. ``offset`` adds ``l * b`` to group
    ``l``'s ids (stacked block ids). The fused path (:func:`fused`) runs
    the kernel on a CUDA tensor, the plain version on a CPU one; any other
    call takes the GEMM + top-k chain, whose ties past 256 columns fall in
    the radix top-k's order."""
    if not fused(centroids, p):
        ROUTE_LAUNCHES["gemm_topk"] += 1
        return route_topk_reference(centroids, c_sq, q, q_sq, p, metric,
                                    live=live, offset=offset,
                                    select=T.topk_smallest_fast)
    if centroids.device.type == "cpu":
        ROUTE_LAUNCHES["plain"] += 1
        return route_topk_reference(centroids, c_sq, q, q_sq, p, metric,
                                    live=live, offset=offset)
    return _launch(*_grouped(centroids, c_sq), q, q_sq, p, metric, live,
                   offset)
