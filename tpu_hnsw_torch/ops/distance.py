"""Distance primitives on torch tensors (port of ``tpu_hnsw/ops/distance.py``).

Internally the engine works with a *score* in which smaller is always
better:

- L2      -> squared L2 distance (monotone in ``<->``)
- IP      -> negative inner product (exactly pgvector's ``<#>``)
- COSINE  -> negative inner product over pre-normalized vectors
             (monotone in cosine distance ``<=>``)

User-facing distances are recovered with :func:`score_to_distance`.
Matrix products run in full f32: the package turns TF32 off at import
(``tpu_hnsw_torch/__init__.py``), the counterpart of the reference's
``Precision.HIGHEST``, because the ``|q|^2+|x|^2-2q.x`` form loses the low
bits exactly where nearest-neighbour order is decided.
"""

from __future__ import annotations

import torch

from tpu_hnsw_torch.config import Metric


def squared_norms(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * xf).sum(-1)


def pairwise_scores(
    q: torch.Tensor,
    x: torch.Tensor,
    metric: Metric,
    x_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """Scores of every query against every point: ``[Q, N]``."""
    if metric is Metric.L1:
        return torch.cdist(q.float(), x.float(), p=1)
    if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
        raise ValueError(f"unsupported metric {metric}")
    dots = q.float() @ x.float().T
    if metric is Metric.L2:
        if x_sq is None:
            x_sq = squared_norms(x)
        q_sq = squared_norms(q)
        return torch.clamp_min(q_sq[:, None] + x_sq[None, :] - 2.0 * dots, 0.0)
    return -dots


def batched_scores(
    q: torch.Tensor,
    vecs: torch.Tensor,
    metric: Metric,
) -> torch.Tensor:
    """Scores of each query against its own gathered rows.

    q ``[Q, d]``, vecs ``[Q, K, d]`` -> ``[Q, K]``, computed elementwise in
    f32 (exact distances: no ``|a|^2+|b|^2-2ab`` cancellation).
    """
    qf = q.float()[:, None, :]
    vf = vecs.float()
    if metric is Metric.L2:
        d = qf - vf
        return (d * d).sum(-1)
    if metric is Metric.L1:
        return (qf - vf).abs().sum(-1)
    return -(qf * vf).sum(-1)


def score_to_distance(score: torch.Tensor, metric: Metric) -> torch.Tensor:
    """Map internal scores back to pgvector operator units: L2 -> ``<->``
    (euclidean), IP -> ``<#>``, COSINE -> ``<=>`` (1 - cos)."""
    if metric is Metric.L2:
        return torch.sqrt(torch.clamp_min(score, 0.0))
    if metric is Metric.COSINE:
        return 1.0 + score
    return score


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """pgvector ``l2_normalize``; cosine indexes store normalized vectors."""
    xf = x.float()
    n = torch.sqrt((xf * xf).sum(-1, keepdim=True))
    return (xf / torch.clamp_min(n, eps)).to(x.dtype)
