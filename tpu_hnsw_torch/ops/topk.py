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
    (values f32, indices int64)."""
    idx = torch.arange(d.shape[-1], dtype=torch.int64, device=d.device)
    kk = torch.topk(score_keys(d, idx), k, dim=-1, largest=False,
                    sorted=True)
    return decode_score_keys(kk.values)
