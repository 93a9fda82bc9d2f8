"""Batched neighbour-selection heuristic (port of
``tpu_hnsw/index/select.py``).

pgvector's ``SelectNeighbors`` (Malkov & Yashunin Algorithm 4 with
extend_candidates=false, keep_pruned_connections=true) over a batch of
rows: scanning candidates in ascending distance to the base, keep one iff
it is closer to the base than to every candidate kept so far, then fill
the remaining slots with the closest pruned ones. The inter-candidate
scores are one batched f32 product ``[B, C, C]``; the greedy scan is a
Python loop over the C candidate slots, each step a few batched tensor
ops over the B rows.

As in the reference, a candidate is rejected only when a kept candidate
is strictly closer to it than the base is, and with fewer than ``lm``
candidates the result keeps everything, so the same function implements
``HnswUpdateConnection``'s append-if-room / re-select-if-full.
"""

from __future__ import annotations

import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.index import graph as G


def pairwise_cand_scores(vecs: torch.Tensor, vecs_sq: torch.Tensor,
                         metric: Metric) -> torch.Tensor:
    """Inter-candidate scores ``[B, C, C]`` from gathered ``[B, C, d]``
    vectors, in full f32 (the reference's ``Precision.HIGHEST``; the
    package keeps TF32 off)."""
    vf = vecs.float()
    if metric is Metric.L1:
        return (vf[:, :, None, :] - vf[:, None, :, :]).abs().sum(-1)
    dots = torch.bmm(vf, vf.transpose(1, 2))
    if metric is Metric.L2:
        return torch.clamp_min(
            vecs_sq[:, :, None] + vecs_sq[:, None, :] - 2.0 * dots, 0.0)
    return -dots


def select_neighbors(g: G.HnswGraph, cand_ids: torch.Tensor,
                     cand_dists: torch.Tensor, *, lm: int, metric: Metric
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Up to ``lm`` neighbours per row. ``cand_ids``/``cand_dists`` ``[B, C]``
    (distance to the row's base element; sentinel ids carry +inf; need not
    be sorted). Returns (ids ``[B, lm]`` int32, dists ``[B, lm]``), a dense
    prefix padded with the sentinel / +inf."""
    sent = g.sentinel
    B, C = cand_ids.shape
    dev = cand_ids.device
    # ascending distance, sentinels last; stable like jnp.argsort
    order = torch.argsort(torch.where(cand_ids == sent, torch.inf,
                                      cand_dists), dim=1, stable=True)
    cand_ids = torch.gather(cand_ids, 1, order)
    cand_dists = torch.gather(cand_dists, 1, order)
    # several sources may propose one id: keep its first occurrence
    col = torch.arange(C, device=dev)
    earlier = col[None, None, :] < col[None, :, None]
    dup = ((cand_ids[:, :, None] == cand_ids[:, None, :]) & earlier).any(2)
    cand_ids = torch.where(dup, sent, cand_ids)
    cand_dists = torch.where(dup, torch.inf, cand_dists)
    valid = cand_ids != sent

    vecs, vecs_sq = G.gather_vectors(g, cand_ids)
    cc = pairwise_cand_scores(vecs, vecs_sq, metric)   # [B, C, C]

    selected = torch.zeros((B, C), dtype=torch.bool, device=dev)
    min_to_sel = torch.full((B, C), torch.inf, device=dev)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(C):
        keep = valid[:, i] & (count < lm) & (cand_dists[:, i]
                                             <= min_to_sel[:, i])
        selected[:, i] = keep
        count += keep
        min_to_sel = torch.minimum(
            min_to_sel, torch.where(keep[:, None], cc[:, :, i], torch.inf))

    # kept (by distance), then pruned (by distance); everything else goes
    # to the trash column C
    pruned = valid & ~selected
    sel_rank = torch.cumsum(selected, 1) - 1
    pr_rank = count[:, None] + torch.cumsum(pruned, 1) - 1
    pos = torch.where(selected, sel_rank,
                      torch.where(pruned, pr_rank, C)).long()
    out_ids = torch.full((B, C + 1), sent, dtype=cand_ids.dtype, device=dev)
    out_dists = torch.full((B, C + 1), torch.inf, device=dev)
    out_ids.scatter_(1, pos, cand_ids)
    out_dists.scatter_(1, pos, cand_dists.float())
    if C + 1 < lm:  # fewer candidates than slots: pad to the full width
        out_ids = torch.nn.functional.pad(out_ids, (0, lm - C - 1),
                                          value=sent)
        out_dists = torch.nn.functional.pad(out_dists, (0, lm - C - 1),
                                            value=torch.inf)
    return out_ids[:, :lm], out_dists[:, :lm]
