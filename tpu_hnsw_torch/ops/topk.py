"""Top-k selection (port of ``tpu_hnsw/ops/topk.py``)."""

from __future__ import annotations

import torch

#: widest row that topk_smallest_by_index sorts whole (one launch, where the
#: keyed top-k takes a dozen: the graph engine's pools and merges)
STABLE_SORT_MAX = 1024


def topk_smallest(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis, ascending. Returns (values, indices)."""
    return torch.topk(scores, k, dim=-1, largest=False, sorted=True)


def topk_smallest_fast(
    scores: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's wide-row top-k (topk.py:24-38). Rows up to 256 wide,
    or k covering the row, take its exact ``lax.top_k``: ties to the lower
    index (:func:`topk_smallest_by_index`). Wider rows take
    ``lax.approx_min_k`` there, which orders ties arbitrarily; the GPU has
    no hardware partial reduce, so they take the exact
    :func:`topk_smallest`."""
    width = scores.shape[-1]
    if width <= 256 or k >= width:
        return topk_smallest_by_index(scores, k)
    return topk_smallest(scores, k)


def score_keys(scores: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """f32 scores and int64 positions ``< 2^32`` -> int64 keys ordered by
    (score, position): the score's bits with the magnitude flipped when
    negative (-0.0 taken as +0.0), above the position. The kernels write
    the same keys (for a score >= 0 they are its bits above the
    position)."""
    sc = torch.where(scores == 0, 0.0, scores).contiguous()
    b = sc.view(torch.int32)
    b = b ^ ((b >> 31) & 0x7FFFFFFF)
    return b.to(torch.int64) * (1 << 32) + pos


def decode_score_keys(keys: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`score_keys` back to (f32 scores, int64 positions)."""
    b = (keys >> 32).to(torch.int32)
    b = b ^ ((b >> 31) & 0x7FFFFFFF)
    return b.view(torch.float32), keys & 0xFFFFFFFF


def topk_smallest_by_index(d: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of f32 ``d`` along the last axis, ascending by (value,
    index): ``lax.top_k(-d, k)``'s order, ties to the lower index. Returns
    (values f32, indices int64). Rows up to ``STABLE_SORT_MAX`` wide take
    one stable sort (equal values keep their index order, -0.0 equal to
    +0.0); wider rows a top-k of int64 keys."""
    if d.shape[-1] <= STABLE_SORT_MAX:
        vals, idx = torch.sort(d, dim=-1, stable=True)
        return vals[..., :k], idx[..., :k]
    idx = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    kk = torch.topk(score_keys(d, idx), k, dim=-1, largest=False,
                    sorted=True)
    return decode_score_keys(kk.values)


def merge_pools(dists_a, ids_a, flags_a, dists_b, ids_b, flags_b, k: int):
    """Merge two (dist, id, flag) pools along the last axis and keep the best
    k (topk.py:42-64), in :func:`topk_smallest_by_index`'s order: among equal
    distances the earlier entry, so a pool keeps what it held. Entries with
    dist +inf are padding."""
    d = torch.cat([dists_a, dists_b], dim=-1)
    vals, sel = topk_smallest_by_index(d, k)
    return (vals, torch.gather(torch.cat([ids_a, ids_b], dim=-1), -1, sel),
            torch.gather(torch.cat([flags_a, flags_b], dim=-1), -1, sel))


def lexsort_order(t: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Positions that sort 1-D ``t`` (ints in [0, 2^31)) ascending, then f32
    ``d``, then position: ``jnp.lexsort((d, t))``. One stable sort of the
    int64 key ``t << 32 | ordered bits of d`` (-0.0 taken as +0.0, as the
    reference's sort does)."""
    sc = torch.where(d == 0, 0.0, d).contiguous()
    b = sc.view(torch.int32)
    b = b ^ ((b >> 31) & 0x7FFFFFFF)
    key = t.to(torch.int64) * (1 << 32) + (b.to(torch.int64) + (1 << 31))
    return torch.sort(key, stable=True).indices


def kway_merge_topk(dists: torch.Tensor, ids: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-partition top-k lists ``[..., P, K]`` -> a global top-k
    ``[..., k]`` (topk.py:67-81): one top-k over the P*K flat positions in
    ``lax.top_k``'s order, ties to the lower flat position."""
    flat_d = dists.reshape(*dists.shape[:-2], -1)
    flat_i = ids.reshape(*ids.shape[:-2], -1)
    vals, sel = topk_smallest_by_index(flat_d, k)
    return vals, torch.gather(flat_i, -1, sel)


def mask_duplicate_ids(d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``d`` with +inf wherever the id (>= 0) already appeared in an earlier
    column of the same row (topk.py:84-97): the merge dedup for replicas,
    which reach it with identical distances. ``[Q, w]`` each; the
    ``[Q, w, w]`` compare is small (w = P*k)."""
    w = i.shape[1]
    eq = (i[:, :, None] == i[:, None, :]) & (i[:, :, None] >= 0)
    earlier = torch.ones((w, w), dtype=torch.bool,
                         device=i.device).tril(-1)
    dup = (eq & earlier[None]).any(-1)
    return torch.where(dup, torch.inf, d)
