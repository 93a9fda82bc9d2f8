"""Exact (brute-force) KNN: the ground-truth oracle (port of
``tpu_hnsw/index/flat.py``).

A tiled scan: one ``[Q, tile]`` GEMM per tile of the table (L1, which has
no matmul form: ``torch.cdist(p=1)``), a per-tile top-k, and a running
merge, all in ``lax.top_k``'s order (ties to the lower row), so the
oracle's ids equal the reference's at ties too. ``exact=True`` keeps the
top-k of the f32 scan itself (the oracle); the default keeps ``4k``
candidates per tile and re-ranks them with exact elementwise f32
distances. Queries go through in slices of at most ``QUERY_ELEMS / tile``
rows, which bounds the ``[Q, tile]`` scores and their int64 sort keys.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.utils.device import entry_device


def _stream_search(q, xs, xs_sq, valid, k: int, metric: Metric, tile: int):
    """Tiled scan of ``xs [N, d]`` (``xs_sq [N]`` f32; ``valid [N]`` bool
    or None). Returns (scores ``[Q, k]``, row positions ``[Q, k]``, -1 where
    fewer than k valid rows exist), ascending by (score, row)."""
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1):
        raise NotImplementedError(f"{metric} flat scan")
    nq = q.shape[0]
    q_sq = D.squared_norms(q)
    # a bf16 table meets a bf16-rounded query with f32 products and sums
    qx = q.to(xs.dtype).float()
    best_d = torch.full((nq, 0), torch.inf, device=q.device)
    best_i = torch.full((nq, 0), -1, dtype=torch.int64, device=q.device)
    for off in range(0, xs.shape[0], tile):
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
        tv, ti = T.topk_smallest_by_index(sc, min(k, xb.shape[0]))
        # the running best holds lower rows than this tile: it goes first
        vals, sel = T.topk_smallest_by_index(
            torch.cat([best_d, tv], 1),
            min(k, best_d.shape[1] + tv.shape[1]))
        best_i = torch.gather(torch.cat([best_i, ti + off], 1), 1, sel)
        best_d = vals
    if best_d.shape[1] < k:  # fewer rows than k
        pad = k - best_d.shape[1]
        best_d = torch.nn.functional.pad(best_d, (0, pad), value=torch.inf)
        best_i = torch.nn.functional.pad(best_i, (0, pad), value=-1)
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


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
    (default: the card; raises without one). ``scan_dtype`` is the
    reference's keyword: "default" is the scan above; its "int8" scoring
    copy is not ported (ROADMAP.md, "Do not port these") and raises, except
    for L1, which ignores it as the reference does."""

    BLOCK = 131072
    #: scores per query slice: 1024 queries at a full tile (their int64
    #: sort keys are 1 GB)
    QUERY_ELEMS = 1 << 27

    def __init__(self, vectors, metric: Metric = Metric.L2, dtype=None,
                 scan_dtype: str = "default", device=None):
        if scan_dtype not in ("default", "int8"):
            raise ValueError("scan_dtype must be default|int8")
        if scan_dtype == "int8" and metric is not Metric.L1:
            raise NotImplementedError(
                "FlatIndex(scan_dtype='int8') is not ported (ROADMAP.md, "
                "'Do not port these')")
        self.scan_dtype = "default"
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
        _, cand_ids = _stream_search(q, self.vectors, self.vectors_sq, None,
                                     cand, self.metric, self._tile)
        return _rerank(q, self.vectors, cand_ids, self.metric, k, self.n)

    def search(self, queries, k: int = 10, block: int = 0, exact=None):
        """Returns numpy (distances ``[Q, k]`` in operator units, ids).
        ``block`` is the reference's keyword, accepted and ignored."""
        d, i = self.search_device(queries, k=k, exact=exact)
        return d.cpu().numpy(), i.cpu().numpy()
