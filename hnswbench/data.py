"""Rows and queries of a cell, drawn on the device from ``--seed``.

A torch rewrite of ``tpu_hnsw_torch/io/datasets.py::synthetic_clustered``'s
recipe: ``max(16, n // 2000)`` Gaussian centres of scale 4, each row a
uniformly drawn centre plus unit noise, each query a uniformly drawn row
plus noise of scale 0.1. Drawn with one ``torch.Generator`` on the device in
a few large calls, so the same seed gives the same tensors and every seed
gives the same sizes.
"""

from __future__ import annotations

import torch

#: rows whose centres are added in one step (bounds the [rows, d] temporary)
ADD_ROWS = 1 << 20
#: the recipe's scale of the centres and of a query's noise
CENTRE_SCALE = 4.0
QUERY_NOISE = 0.1


def _normalize_(x: torch.Tensor) -> torch.Tensor:
    """Divides each row by its L2 norm in place."""
    return x.div_(torch.clamp_min(torch.linalg.vector_norm(x, dim=1,
                                                           keepdim=True),
                                  1e-12))


def clustered(n: int, dim: int, n_queries: int, seed: int, device,
              normalize: bool = False):
    """(rows ``[n, dim]`` f32, queries ``[n_queries, dim]`` f32) on
    ``device``; with ``normalize`` both are L2-normalised row by row."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    k = max(16, n // 2000)
    centres = torch.randn((k, dim), generator=g, device=device) * CENTRE_SCALE
    assign = torch.randint(0, k, (n,), generator=g, device=device)
    rows = torch.randn((n, dim), generator=g, device=device)
    for s in range(0, n, ADD_ROWS):
        rows[s:s + ADD_ROWS] += centres[assign[s:s + ADD_ROWS]]
    qidx = torch.randint(0, n, (n_queries,), generator=g, device=device)
    queries = rows[qidx] + QUERY_NOISE * torch.randn(
        (n_queries, dim), generator=g, device=device)
    if normalize:
        _normalize_(rows)
        _normalize_(queries)
    return rows, queries


def of_config(config: dict, seed: int, device):
    """The rows and query pool a configuration file describes."""
    return clustered(config["rows"], config["dim"], config["queries"], seed,
                     device, normalize=config.get("normalize", False))
