"""pgvector's HNSW scan in plain torch, one query at a time, over the
tensors of a built graph: the walk that the graph engine's lockstep beam
is held to.

pgvector's ``GetScanItems`` (``hnswscan.c``) descends from the entry point
through the upper levels with ``HnswSearchLayer`` at ef 1 and then runs
``HnswSearchLayer`` at level 0 with ef ``hnsw.ef_search``.
``HnswSearchLayer`` (``hnswutils.c``) keeps a visited set, a min-heap of
candidates and a max-heap of the ef nearest results, pops the nearest
candidate, stops when it is farther than the furthest result, and
otherwise scores every unvisited neighbour, keeping one that is nearer
than the furthest result or while fewer than ef are kept. No step cap.

It imports nothing of the program and no JAX, and runs with TF32 off
(:func:`hnswbench.reference.full_f32`). The graph comes as the flat
tensors of ``tpu_hnsw_torch/index/graph.py``'s layout, read only:
``vectors [cap+1, d]``, ``neighbors0 [cap+1, 2m]``, ``upper_nbrs [cap_u+1,
L, m]`` and ``upper_slot [cap+1]``, the sentinel id ``cap`` padding the
adjacency rows.

Departures from pgvector:

- scores are f32, computed elementwise (``((x - q) ** 2).sum()`` for L2,
  ``-(x * q).sum()`` for inner product) in torch's summation order, where
  pgvector sums in index order: the last bits differ;
- equal distances pop in order of id (Python's heaps on ``(distance,
  id)``); pgvector's pairing heap orders ties its own way;
- the level-0 ef is ``max(ef_search, k)``, as the port and
  ``RefHnsw.search`` take it; pgvector returns at most ``ef_search`` rows;
- no tombstones: every element is walked and may be returned (pgvector
  skips deleted heap tuples when it returns them);
- no iterative scan and no ``hnsw.max_scan_tuples``.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np
import torch

from hnswbench.reference import full_f32


class Graph(NamedTuple):
    """A graph's tensors as the walk reads them: the adjacency on the host
    (numpy), the vectors where they were given."""

    vectors: torch.Tensor    # [cap+1, d] f32
    neighbors0: np.ndarray   # [cap+1, 2m]
    upper_nbrs: np.ndarray   # [cap_u+1, L, m]
    upper_slot: np.ndarray   # [cap+1]
    sentinel: int


def graph(vectors, neighbors0, upper_nbrs, upper_slot) -> Graph:
    """:class:`Graph` of the four tensors; the sentinel is the last row of
    ``vectors``."""
    return Graph(vectors.float(), neighbors0.cpu().numpy(),
                 upper_nbrs.cpu().numpy(), upper_slot.cpu().numpy(),
                 vectors.shape[0] - 1)


def _scores(g: Graph, q: torch.Tensor, ids: list, metric: str) -> list:
    x = g.vectors[torch.as_tensor(ids, device=g.vectors.device)]
    if metric == "l2":
        return ((x - q) ** 2).sum(-1).tolist()
    if metric == "ip":
        return (-(x * q).sum(-1)).tolist()
    raise ValueError(f"unknown metric {metric!r}")


def _neighbours(g: Graph, c: int, level: int) -> list:
    row = g.neighbors0[c] if level == 0 \
        else g.upper_nbrs[g.upper_slot[c], level - 1]
    return [int(e) for e in row if e != g.sentinel]


def search_layer(g: Graph, q: torch.Tensor, eps: list, ef: int, level: int,
                 metric: str) -> tuple[list, int]:
    """``HnswSearchLayer`` from the entry points ``[(distance, id)]``:
    (the ef nearest found as ``[(distance, id)]`` ascending, the number of
    candidates expanded)."""
    visited = {e for _, e in eps}
    cand = sorted(set(eps))
    w = [(-d, e) for d, e in cand]
    heapq.heapify(w)
    while len(w) > ef:
        heapq.heappop(w)
    expanded = 0
    while cand:
        d_c, c = heapq.heappop(cand)
        if d_c > -w[0][0]:
            break
        expanded += 1
        fresh = [e for e in _neighbours(g, c, level) if e not in visited]
        visited.update(fresh)
        if not fresh:
            continue
        for d_e, e in zip(_scores(g, q, fresh, metric), fresh):
            if len(w) < ef or d_e < -w[0][0]:
                heapq.heappush(cand, (d_e, e))
                heapq.heappush(w, (-d_e, e))
                if len(w) > ef:
                    heapq.heappop(w)
    return sorted((-nd, e) for nd, e in w), expanded


def walk(g: Graph, entry: int, entry_level: int, q: torch.Tensor, k: int,
         ef_search: int, metric: str) -> tuple[list, int]:
    """``GetScanItems`` for one query ``q [d]``: (the k nearest as
    ``[(distance, id)]`` ascending, the candidates expanded at level 0)."""
    eps = [(_scores(g, q, [entry], metric)[0], entry)]
    for level in range(entry_level, 0, -1):
        eps, _ = search_layer(g, q, eps, 1, level, metric)
    found, expanded = search_layer(g, q, eps, max(ef_search, k), 0, metric)
    return found[:k], expanded


def walk_all(g: Graph, entry: int, entry_level: int, queries: torch.Tensor,
             k: int, ef_search: int, metric: str):
    """:func:`walk` for each row of ``queries``: (scores ``[Q, k]`` f32,
    ids ``[Q, k]`` int64, a missing result +inf and -1; level-0
    expansions ``[Q]`` int64), on the host."""
    Q = queries.shape[0]
    scores = torch.full((Q, k), torch.inf)
    ids = torch.full((Q, k), -1, dtype=torch.int64)
    expanded = torch.zeros(Q, dtype=torch.int64)
    qs = queries.to(g.vectors.device, torch.float32)
    with full_f32():
        for j in range(Q):
            found, expanded[j] = walk(g, entry, entry_level, qs[j], k,
                                      ef_search, metric)
            for c, (d, e) in enumerate(found):
                scores[j, c], ids[j, c] = d, e
    return scores, ids, expanded
