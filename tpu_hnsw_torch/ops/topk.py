"""Top-k selection (port of ``tpu_hnsw/ops/topk.py``)."""

from __future__ import annotations

import torch


def topk_smallest(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k along the last axis, ascending. Returns (values, indices)."""
    return torch.topk(scores, k, dim=-1, largest=False, sorted=True)


def topk_smallest_fast(
    scores: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's wide-row top-k. On the TPU it is ``lax.approx_min_k``
    (the hardware partial reduce); the GPU has no counterpart, so this is
    the exact :func:`topk_smallest`. Kept as its own name so each call site
    maps onto the reference's."""
    return topk_smallest(scores, k)


def decode_keys(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Keys ``(f32 distance bits << 32) | index`` back to (f32 distances,
    int32 indices)."""
    d = (keys >> 32).to(torch.int32).view(torch.float32)
    return d, (keys & 0xFFFFFFFF).to(torch.int32)


def topk_smallest_by_index(d: torch.Tensor, k: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest-k of non-negative f32 ``d`` along the last axis, ascending
    by (value, index): ``lax.top_k(-d, k)``'s order, ties to the lower
    index. Returns (values f32, indices int32)."""
    # one int64 key per entry: the float's bits (monotone for d >= 0) above
    # the index, so keys are unique and ordered by (distance, index)
    idx = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    keys = (d.contiguous().view(torch.int32).to(torch.int64) << 32) | idx
    kk = torch.topk(keys, k, dim=-1, largest=False, sorted=True)
    return decode_keys(kk.values)
