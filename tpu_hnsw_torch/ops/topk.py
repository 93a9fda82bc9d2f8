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
