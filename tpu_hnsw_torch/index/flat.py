"""Exact (brute-force) KNN: the ground-truth oracle (port of
``tpu_hnsw/index/flat.py``).

A tiled scan: one ``[Q, tile]`` GEMM per tile of the table (L1, which has
no matmul form: ``torch.cdist(p=1)``), a per-tile top-k, and a running
merge, all in ``lax.top_k``'s order (ties to the lower row), so the
oracle's ids equal the reference's at ties too. ``exact=True`` keeps the
top-k of the f32 scan itself (the oracle); the default keeps ``4k``
candidates per tile and re-ranks them with exact elementwise f32
distances. ``scan_dtype="int8"`` finds those candidates with an int32
product of int8 copies instead (``torch._int_mm``). Queries go through in
slices of at most ``QUERY_ELEMS / tile`` rows, which bounds the
``[Q, tile]`` scores and their int64 sort keys.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.utils.device import entry_device

#: ``torch._int_mm`` on CUDA takes more than 16 rows on the left, and inner
#: and right widths that are multiples of 8
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8

#: the reference's ``amax / 127.0`` as XLA computes it: a division by a
#: constant becomes a product with the constant's f32 reciprocal, so scales
#: taken this way equal the reference's bit for bit (a true division differs
#: in the last bit for some rows)
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _align(v: int) -> int:
    return -(-v // INT_MM_ALIGN) * INT_MM_ALIGN


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation of f32 rows (flat.py:101-104,
    214-221): (int8 rows, f32 scales), ``row ~= q8 * scale``."""
    scl = torch.clamp_min(x.abs().amax(dim=1), 1e-30) * INV_127
    q8 = torch.clamp(torch.round(x / scl[:, None]), -127, 127).to(torch.int8)
    return q8, scl


def _running_topk(score_tile, n_rows: int, tile: int, k: int, nq: int,
                  device):
    """The k best of ``n_rows`` rows scored a tile at a time
    (``score_tile(off)`` gives ``[nq, w]`` scores of rows ``off..off+w``).
    Returns (scores ``[nq, k]``, row positions ``[nq, k]``, -1 where fewer
    than k finite scores exist), ascending by (score, row)."""
    best_d = torch.full((nq, 0), torch.inf, device=device)
    best_i = torch.full((nq, 0), -1, dtype=torch.int64, device=device)
    for off in range(0, n_rows, tile):
        sc = score_tile(off)
        tv, ti = T.topk_smallest_by_index(sc, min(k, sc.shape[1]))
        # the running best holds lower rows than this tile: it goes first
        vals, sel = T.topk_smallest_by_index(
            torch.cat([best_d, tv], 1),
            min(k, best_d.shape[1] + tv.shape[1]))
        best_i = torch.gather(torch.cat([best_i, ti + off], 1), 1, sel)
        best_d = vals
    if best_d.shape[1] < k:  # fewer rows than k
        pad = k - best_d.shape[1]
        best_d = F.pad(best_d, (0, pad), value=torch.inf)
        best_i = F.pad(best_i, (0, pad), value=-1)
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def _stream_search(q, xs, xs_sq, valid, k: int, metric: Metric, tile: int):
    """Tiled scan of ``xs [N, d]`` (``xs_sq [N]`` f32; ``valid [N]`` bool
    or None). Returns (scores ``[Q, k]``, row positions ``[Q, k]``, -1 where
    fewer than k valid rows exist), ascending by (score, row)."""
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1):
        raise NotImplementedError(f"{metric} flat scan")
    q_sq = D.squared_norms(q)
    # a bf16 table meets a bf16-rounded query with f32 products and sums
    qx = q.to(xs.dtype).float()

    def score_tile(off):
        xb = xs[off:off + tile].float()
        if metric is Metric.L1:
            sc = torch.cdist(qx, xb, p=1)
        else:
            dots = qx @ xb.T
            if metric is Metric.L2:
                sc = torch.clamp_min(
                    q_sq[:, None] + xs_sq[None, off:off + tile] - 2.0 * dots,
                    0.0)
            else:
                sc = -dots
        if valid is not None:
            sc = torch.where(valid[None, off:off + tile], sc, torch.inf)
        return sc

    return _running_topk(score_tile, xs.shape[0], tile, k, q.shape[0],
                         q.device)


def _stream_search_int8(q, xs8, xs_sq, scales, k: int, metric: Metric,
                        tile: int, n: int):
    """Tiled int8 scan (flat.py:94-141): ``xs8 [N8, dp]`` int8 rows
    (``N8`` and ``dp`` padded to multiples of ``INT_MM_ALIGN``), ``scales
    [N8]`` their per-row dequantisation, ``xs_sq [n]`` exact f32 squared
    norms of the ``n`` real rows. Each tile is an int32 product of the
    symmetric int8 queries against the tile, dequantised, then L2 from the
    exact norms or the negated product. Returns what :func:`_stream_search`
    returns; padded rows never reach the select."""
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
        raise NotImplementedError(f"{metric} int8 flat scan")
    nq = q.shape[0]
    q_sq = D.squared_norms(q)
    q8, q_scl = _quantize_rows(F.pad(q, (0, xs8.shape[1] - q.shape[1])))
    q8 = F.pad(q8, (0, 0, 0, max(0, INT_MM_MIN_ROWS - nq)))
    tile = _align(tile)

    def score_tile(off):
        w = min(tile, n - off)
        # the contiguous [tile, dp] rows, transposed: cuBLASLt's int8 layout
        dots_i = torch._int_mm(q8, xs8[off:off + tile].T)[:nq, :w]
        # the reference's order of operations: equal scores on the CPU
        dots = dots_i.float() * (q_scl[:, None] * scales[None, off:off + w])
        if metric is Metric.L2:
            return torch.clamp_min(
                q_sq[:, None] + xs_sq[None, off:off + w] - 2.0 * dots, 0.0)
        return -dots

    return _running_topk(score_tile, n, tile, k, nq, q.device)


def _rerank(q, x, cand_ids, metric: Metric, k: int, n: int):
    """Exact f32 re-scoring of candidate ids ``[Q, C]`` -> top-k. Ids
    outside ``[0, n)`` are masked to +inf rather than clipped into the
    table, where they would rescore a real row and displace a neighbour."""
    bad = (cand_ids < 0) | (cand_ids >= n)
    v = x[torch.clamp(cand_ids, 0, n - 1)]
    sc = torch.where(bad, torch.inf, D.batched_scores(q, v, metric))
    vals, sel = T.topk_smallest_by_index(sc, k)
    ids = torch.where(torch.isfinite(vals), torch.gather(cand_ids, 1, sel), -1)
    return vals, ids


class FlatIndex:
    """Exact KNN over a device-resident vector table; ``device`` holds it
    (default: the card; raises without one). ``scan_dtype="int8"`` adds an
    int8 scoring copy of the table with per-row scales (quantised
    ``BLOCK`` rows at a time, which bounds the f32 temporaries) that the
    default search scans for its candidates before the exact f32 rerank;
    ``exact=True`` never reads it, and L1, which has no product form,
    ignores the option, as the reference does."""

    BLOCK = 131072
    #: scores per query slice: 1024 queries at a full tile (their int64
    #: sort keys are 1 GB)
    QUERY_ELEMS = 1 << 27

    def __init__(self, vectors, metric: Metric = Metric.L2, dtype=None,
                 scan_dtype: str = "default", device=None):
        if scan_dtype not in ("default", "int8"):
            raise ValueError("scan_dtype must be default|int8")
        self.scan_dtype = "default" if metric is Metric.L1 else scan_dtype
        if not isinstance(vectors, torch.Tensor):
            vectors = torch.from_numpy(np.asarray(vectors, np.float32))
        vectors = vectors.to(device=entry_device(device),
                             dtype=dtype or vectors.dtype)
        if metric.needs_normalized:
            vectors = D.l2_normalize(vectors)
        self.metric = metric
        self.vectors = vectors
        self.device = vectors.device
        self.n = int(vectors.shape[0])
        self.dim = int(vectors.shape[1])
        self._tile = min(self.BLOCK, 1 << (max(self.n - 1, 1)).bit_length())
        self.vectors_sq = D.squared_norms(vectors)
        self._xs8 = self._scales = None
        if self.scan_dtype == "int8":
            self._xs8 = torch.zeros((_align(self.n), _align(self.dim)),
                                    dtype=torch.int8, device=self.device)
            self._scales = torch.zeros(_align(self.n), device=self.device)
            for s in range(0, self.n, self.BLOCK):
                e = min(self.n, s + self.BLOCK)
                self._xs8[s:e, :self.dim], self._scales[s:e] = \
                    _quantize_rows(vectors[s:e].float())

    @property
    def size(self) -> int:
        return self.n

    def search_device(self, queries, k: int = 10, ef_search: int = 0,
                      exact=None):
        """Device-resident exact search; returns (distances, ids) tensors in
        pgvector operator units. ``ef_search`` is accepted and ignored."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(device=self.device, dtype=torch.float32)
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32)).to(
                self.device)
        if q.ndim == 1:
            q = q[None]
        if self.metric.needs_normalized:
            q = D.l2_normalize(q)
        k_req, k = k, min(k, self.n)
        step = max(1, self.QUERY_ELEMS // self._tile)
        parts = [self._search_slice(q[s:s + step], k, exact)
                 for s in range(0, max(q.shape[0], 1), step)]
        scores = torch.cat([p[0] for p in parts])
        ids = torch.cat([p[1] for p in parts])
        if k < k_req:
            scores = torch.nn.functional.pad(scores, (0, k_req - k),
                                             value=torch.inf)
            ids = torch.nn.functional.pad(ids, (0, k_req - k), value=-1)
        return D.score_to_distance(scores, self.metric), ids

    def _search_slice(self, q, k: int, exact):
        """Raw scores and ids ``[Q, k]`` of one query slice."""
        if exact:
            return _stream_search(q, self.vectors, self.vectors_sq, None, k,
                                  self.metric, self._tile)
        cand = min(4 * k, self.n)
        if self._xs8 is not None:
            _, cand_ids = _stream_search_int8(
                q, self._xs8, self.vectors_sq, self._scales, cand,
                self.metric, self._tile, self.n)
        else:
            _, cand_ids = _stream_search(q, self.vectors, self.vectors_sq,
                                         None, cand, self.metric, self._tile)
        return _rerank(q, self.vectors, cand_ids, self.metric, k, self.n)

    def search(self, queries, k: int = 10, block: int = 0, exact=None):
        """Returns numpy (distances ``[Q, k]`` in operator units, ids).
        ``block`` is the reference's keyword, accepted and ignored."""
        d, i = self.search_device(queries, k=k, exact=exact)
        return d.cpu().numpy(), i.cpu().numpy()
