"""The plain reference: exact brute-force nearest neighbours in plain
PyTorch, computed in blocks so that it fits beside nothing else.

It imports nothing of the program. Scores follow the index's convention,
smaller is nearer: squared L2 distance, or the negated inner product for
``ip`` (pgvector's ``<#>``). Matrix products run in full f32 (TF32 off);
the scores of given (query, id) pairs are recomputed in float64.
"""

from __future__ import annotations

import contextlib

import torch

#: queries scored at once, and rows a query block meets at once: a
#: [1,024, 262,144] f32 block of scores is 1 GiB
QUERY_BLOCK = 1024
ROW_BLOCK = 1 << 18
#: (query, id) pairs rescored at once in float64
PAIR_BLOCK = 8192


@contextlib.contextmanager
def full_f32():
    """Matrix products in IEEE f32 inside the block (TF32 off), as before
    it afterwards."""
    mm = torch.backends.cuda.matmul
    old = (mm.allow_tf32, torch.backends.cudnn.allow_tf32)
    mm.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (finite f32) rounded to TF32's 10-bit mantissa, to nearest
    with ties to even: the operands a TF32 tensor-core product reads. The
    product of two such values is exact in f32, so an f32 product of
    rounded operands is a TF32 product."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def scores(q: torch.Tensor, x: torch.Tensor, metric: str,
           rounding=None) -> torch.Tensor:
    """``[Q, N]`` f32 scores of queries against rows; ``rounding`` (such
    as :func:`tf32`) is applied to both operands of the product only."""
    a, b = (q, x) if rounding is None else (rounding(q), rounding(x))
    dots = a @ b.T
    if metric == "l2":
        return ((q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
                - 2.0 * dots)
    if metric == "ip":
        return -dots
    raise ValueError(f"unknown metric {metric!r}")


def exact_topk(rows: torch.Tensor, queries: torch.Tensor, k: int,
               metric: str, rounding=None):
    """Each query's ``k`` nearest rows: (scores ``[Q, k]`` f32 ascending,
    ids ``[Q, k]`` int64)."""
    n = rows.shape[0]
    out_s, out_i = [], []
    with full_f32():
        for q0 in range(0, queries.shape[0], QUERY_BLOCK):
            q = queries[q0:q0 + QUERY_BLOCK].float()
            best_s = best_i = None
            for r0 in range(0, n, ROW_BLOCK):
                sc = scores(q, rows[r0:r0 + ROW_BLOCK].float(), metric,
                            rounding)
                s, i = torch.topk(sc, min(k, sc.shape[1]), dim=1,
                                  largest=False)
                i = i + r0
                if best_s is not None:
                    s, j = torch.topk(torch.cat([best_s, s], 1),
                                      min(k, best_s.shape[1] + s.shape[1]),
                                      dim=1, largest=False)
                    i = torch.gather(torch.cat([best_i, i], 1), 1, j)
                best_s, best_i = s, i
            out_s.append(best_s)
            out_i.append(best_i)
    return torch.cat(out_s), torch.cat(out_i)


def pair_scores(rows: torch.Tensor, queries: torch.Tensor,
                ids: torch.Tensor, metric: str):
    """float64 (scores, rounding scales ``|q|^2 + |x|^2``) of each query
    ``queries[j]`` against each row ``rows[ids[j, c]]``; ``ids`` must lie
    in ``[0, n)``."""
    out_s, out_m = [], []
    for s in range(0, ids.shape[0], PAIR_BLOCK):
        q = queries[s:s + PAIR_BLOCK].double()[:, None, :]
        x = rows[ids[s:s + PAIR_BLOCK]].double()
        if metric == "l2":
            sc = ((x - q) ** 2).sum(-1)
        elif metric == "ip":
            sc = -(x * q).sum(-1)
        else:
            raise ValueError(f"unknown metric {metric!r}")
        out_s.append(sc)
        out_m.append((q * q).sum(-1) + (x * x).sum(-1))
    return torch.cat(out_s), torch.cat(out_m)


def distances_to_scores(dist: torch.Tensor, metric: str) -> torch.Tensor:
    """pgvector operator units -> float64 scores: ``<->`` squared, ``<#>``
    as it is."""
    d = dist.double()
    return d * d if metric == "l2" else d


def scores_to_distances(sc: torch.Tensor, metric: str) -> torch.Tensor:
    """Scores -> pgvector operator units (f32)."""
    return torch.sqrt(torch.clamp_min(sc, 0.0)) if metric == "l2" else sc
