"""k-means for the block layout (port of ``tpu_hnsw/parallel/kmeans.py``).

Lloyd iterations as one GEMM + argmin (assignment) and one ``index_add_``
(update) each. The host RNG calls are the reference's calls in the same
order (sample, init, refill pool, refill draws), so both packages start
from the same centroids and can be compared centroid for centroid.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.utils.profiling import annotate


#: scores a step of the assignment holds (4 GB in f32): the reference's
#: XLA fuses the argmin into its GEMM and never holds ``[N, k]``, which at
#: config E's shape (859,392 sampled rows, 26,856 centroids) is 92 GB
ASSIGN_ELEMS = 1 << 30


def _assign(x, x_sq, centroids):
    """Nearest centroid per row (L2), in steps of rows whose ``[step, k]``
    scores hold at most ``ASSIGN_ELEMS``."""
    c_sq = D.squared_norms(centroids)
    step = max(1, ASSIGN_ELEMS // max(centroids.shape[0], 1))
    out = []
    for s in range(0, max(x.shape[0], 1), step):
        scores = (x_sq[s:s + step, None] + c_sq[None, :]
                  - 2.0 * (x[s:s + step] @ centroids.T))
        out.append(scores.argmin(dim=1))
    return torch.cat(out)


def _update(x, assign, k: int):
    """Mean of each cluster (segment sum / count)."""
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, assign, x)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, assign, torch.ones_like(x[:, 0]))
    return sums / torch.clamp_min(counts, 1.0)[:, None], counts


def _lloyd(x, x_sq, centroids, k: int, iters: int):
    """``iters`` Lloyd iterations; an empty cluster keeps its previous
    centroid (the host refill runs between segments)."""
    counts = torch.ones(k, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        a = _assign(x, x_sq, centroids)
        c2, counts = _update(x, a, k)
        centroids = torch.where(counts[:, None] < 1.0, centroids, c2)
    return centroids, counts


def kmeans(
    data,
    k: int,
    iters: int = 10,
    seed: int = 0,
    sample: int | None = 262144,
    balance: bool = True,
    assign_full: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means with random-sample init.

    ``data`` is an ``[N, d]`` tensor (on any device) or array. Returns
    (centroids ``[k, d]`` f32, assignment ``[N]`` int64 — empty unless
    ``assign_full``) on the data's device. ``balance`` re-seeds empty
    clusters from a fixed pool of sample points, as the reference does.
    """
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.asarray(data, np.float32))
    dev = data.device
    n = data.shape[0]
    rng = np.random.default_rng(seed)

    def rows(src, idx):
        return src[torch.from_numpy(np.asarray(idx, np.int64)).to(dev)]

    m = n if sample is None else min(n, sample)
    with annotate("kmeans", m):
        with annotate("kmeans_sample", m):
            train = data
            if m < n:
                train = rows(data, rng.choice(n, sample, replace=False))
            x = train.float()
            x_sq = D.squared_norms(x)
            centroids = rows(x, rng.choice(x.shape[0], k, replace=False))
        refill_pool = None
        if balance and iters >= 3:
            segments = [iters - 2 * (iters // 3)] + [iters // 3] * 2
        else:
            segments = [iters] if iters else []
        for seg in segments:
            with annotate("kmeans_lloyd", m):
                centroids, counts = _lloyd(x, x_sq, centroids, k, seg)
            if not balance:
                continue
            with annotate("kmeans_refill") as span:
                empty = np.where(counts.cpu().numpy() < 1)[0]
                span.work = len(empty)
                if len(empty):
                    if refill_pool is None:
                        pool_n = min(x.shape[0], max(1024, k))
                        refill_pool = rows(
                            x, rng.choice(x.shape[0], pool_n, replace=False))
                    centroids = centroids.clone()
                    centroids[torch.from_numpy(empty).to(dev)] = rows(
                        refill_pool, rng.choice(len(refill_pool), len(empty)))
    if not assign_full:
        return centroids, torch.zeros(0, dtype=torch.int64, device=dev)
    step = 1 << 18
    out = []
    for s in range(0, n, step):
        xb = data[s:s + step].float()
        out.append(_assign(xb, D.squared_norms(xb), centroids))
    assign = (torch.cat(out) if out
              else torch.zeros(0, dtype=torch.int64, device=dev))
    return centroids, assign
