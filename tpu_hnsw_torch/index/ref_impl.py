"""Sequential reference HNSW (numpy) — the semantics oracle (a copy of
``tpu_hnsw/index/ref_impl.py``, so the port's tests need not import the
JAX package to build one).

A direct, readable implementation of the reference's HNSW behavior
(upstream ``pgvector:src/hnswutils.c`` — ``HnswSearchLayer``,
``HnswFindElementNeighbors``, ``SelectNeighbors`` with the
keep-pruned-connections variant, ``HnswUpdateConnection``;
``pgvector:src/hnswinsert.c`` insert flow), used ONLY for tests: the
batched engine must reproduce its graphs exactly at wave size 1 and
match its recall at larger wave sizes (SURVEY.md §7.3).

This is intentionally not device code: plain heaps and pointer chasing.
"""

from __future__ import annotations

import heapq
import math

import numpy as np

from tpu_hnsw_torch.config import HnswConfig, Metric


def _score(q: np.ndarray, x: np.ndarray, metric: Metric) -> float:
    if metric is Metric.L2:
        d = q - x
        return float(np.dot(d, d))
    if metric is Metric.L1:
        return float(np.sum(np.abs(q - x)))
    return float(-np.dot(q, x))


class RefHnsw:
    """Sequential in-memory HNSW with pgvector insert/search semantics."""

    def __init__(self, config: HnswConfig, rng: np.random.Generator | None = None):
        self.cfg = config
        self.rng = rng or np.random.default_rng(config.seed)
        self.vectors: list[np.ndarray] = []
        self.levels: list[int] = []
        # neighbors[node][level] -> list[int]
        self.neighbors: list[list[list[int]]] = []
        self.entry: int = -1
        self.entry_level: int = -1

    # -- level assignment: upstream HnswInitElement:
    #    level = floor(-ln(U) * ml), ml = 1/ln(m)
    def draw_level(self) -> int:
        u = float(self.rng.random())
        u = max(u, 1e-12)
        return min(int(-math.log(u) * self.cfg.ml), self.cfg.max_level)

    def _dist(self, a: int, q: np.ndarray) -> float:
        return _score(q, self.vectors[a], self.cfg.metric)

    # -- upstream HnswSearchLayer: ef-bounded best-first search at one level
    def search_layer(
        self, q: np.ndarray, eps: list[tuple[float, int]], ef: int, level: int
    ) -> list[tuple[float, int]]:
        visited = set()
        cand: list[tuple[float, int]] = []  # min-heap by distance
        w: list[tuple[float, int]] = []  # max-heap (negated) of results
        for d, e in eps:
            if e in visited:
                continue
            visited.add(e)
            heapq.heappush(cand, (d, e))
            heapq.heappush(w, (-d, e))
        while len(w) > ef:
            heapq.heappop(w)
        while cand:
            d_c, c = heapq.heappop(cand)
            f = -w[0][0]
            if d_c > f:
                break
            for e in self.neighbors[c][level]:
                if e in visited:
                    continue
                visited.add(e)
                d_e = self._dist(e, q)
                f = -w[0][0]
                if d_e < f or len(w) < ef:
                    heapq.heappush(cand, (d_e, e))
                    heapq.heappush(w, (-d_e, e))
                    if len(w) > ef:
                        heapq.heappop(w)
        return sorted((-nd, e) for nd, e in w)

    # -- upstream SelectNeighbors (extend_candidates=false,
    #    keep_pruned_connections=true): greedy heuristic — keep a candidate
    #    iff it is closer to q than to every already-selected neighbor; then
    #    fill remaining slots with the closest pruned candidates.
    def select_neighbors(
        self, q: np.ndarray, cands: list[tuple[float, int]], lm: int
    ) -> list[tuple[float, int]]:
        cands = sorted(cands)
        selected: list[tuple[float, int]] = []
        pruned: list[tuple[float, int]] = []
        for d, e in cands:
            if len(selected) >= lm:
                break
            keep = True
            ev = self.vectors[e]
            for _, s in selected:
                if _score(ev, self.vectors[s], self.cfg.metric) < d:
                    keep = False
                    break
            (selected if keep else pruned).append((d, e))
        for item in pruned:
            if len(selected) >= lm:
                break
            selected.append(item)
        return sorted(selected)

    # -- upstream HnswUpdateConnection: append if there is room, else
    #    re-select over existing + new.
    def update_connection(self, target: int, new: int, level: int) -> None:
        lm = self.cfg.layer_m(level)
        lst = self.neighbors[target][level]
        if len(lst) < lm:
            lst.append(new)
            return
        tv = self.vectors[target]
        cands = [(self._dist(e, tv), e) for e in lst]
        cands.append((self._dist(new, tv), new))
        sel = self.select_neighbors(tv, cands, lm)
        self.neighbors[target][level] = [e for _, e in sel]

    # -- upstream HnswFindElementNeighbors + HnswInsertTupleOnDisk flow
    def insert(self, vec: np.ndarray, level: int | None = None) -> int:
        vec = np.asarray(vec, dtype=np.float32)
        node = len(self.vectors)
        if level is None:
            level = self.draw_level()
        self.vectors.append(vec)
        self.levels.append(level)
        self.neighbors.append([[] for _ in range(level + 1)])

        if self.entry < 0:
            self.entry, self.entry_level = node, level
            return node

        eps = [(self._dist(self.entry, vec), self.entry)]
        # greedy descent above the element's top level (ef=1)
        for lc in range(self.entry_level, level, -1):
            eps = self.search_layer(vec, eps, 1, lc)
        # ef_construction search + neighbor selection per level
        for lc in range(min(level, self.entry_level), -1, -1):
            w = self.search_layer(vec, eps, self.cfg.ef_construction, lc)
            lm = self.cfg.layer_m(lc)
            sel = self.select_neighbors(vec, w, lm)
            self.neighbors[node][lc] = [e for _, e in sel]
            for _, e in sel:
                self.update_connection(e, node, lc)
            eps = w
        if level > self.entry_level:
            self.entry, self.entry_level = node, level
        return node

    def build(self, data: np.ndarray, levels: np.ndarray | None = None) -> None:
        for i, v in enumerate(np.asarray(data, dtype=np.float32)):
            self.insert(v, None if levels is None else int(levels[i]))

    def search(self, q: np.ndarray, k: int = 10, ef_search: int = 40):
        """upstream hnswscan.c GetScanItems: descent then ef_search beam."""
        q = np.asarray(q, dtype=np.float32)
        if self.entry < 0:
            return np.zeros(0, np.float32), np.zeros(0, np.int64)
        eps = [(self._dist(self.entry, q), self.entry)]
        for lc in range(self.entry_level, 0, -1):
            eps = self.search_layer(q, eps, 1, lc)
        w = self.search_layer(q, eps, max(ef_search, k), 0)[:k]
        return (
            np.asarray([d for d, _ in w], np.float32),
            np.asarray([e for _, e in w], np.int64),
        )
