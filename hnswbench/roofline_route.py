"""The least time of a stacked route on one H100: every query scored
against every centroid, ``2 Q C d`` operations at the peak of the
centroids' dtype (a bf16 centroid meets the bf16-rounded query, whose
products f32 holds exactly, so bf16 tensor cores do the same sums), and
the centroids, their norms, the queries and each query's ids moved once.
The GEMM + top-k chain of ``tpu_hnsw_torch/ops/route.py`` runs the same
operations in f32 after an upcast."""

from __future__ import annotations

from hnswbench.roofline import bound

#: the centroids' dtype -> ``hnswbench.roofline.PEAK_OPS``'s name
_PEAK = {"torch.bfloat16": "bfloat16", "torch.float32": "float32"}


def route_bytes(Q: int, C: int, d: int, elem: int, p: int) -> int:
    """Bytes one route call must move: ``C`` centroids of ``d`` elements of
    ``elem`` bytes and their f32 norms, ``Q`` f32 queries and their norms,
    ``Q * p`` int64 ids written."""
    return C * (d * elem + 4) + Q * (d * 4 + 4) + 8 * Q * p


def route_bound(Q: int, C: int, d: int, dtype: str, elem: int,
                p: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one route call over ``C`` centroids of
    ``dtype`` (a torch dtype's name)."""
    return bound(route_bytes(Q, C, d, elem, p), 2 * Q * C * d, _PEAK[dtype])
