"""System under test: ``tpu_hnsw_torch``'s ``HnswIndex``, the graph engine,
bulk-built on a device tensor and served through ``search_device`` with
pgvector's query defaults.

The interface of ``engines/block.py``. The harness's ``probes`` is passed as
``ef_search`` (pgvector's ``hnsw.ef_search``); every other argument of
``search_device`` keeps its default: one candidate expanded a step, the
ef-1 descent width, the step cap ``ef / expand + 16`` and ``route="auto"``
(the dense scan of the level >= 1 elements from
``HnswIndex.ROUTE_SCAN_MIN_UPPER`` of them, else pgvector's greedy
descent).
"""

from __future__ import annotations

import torch

from tpu_hnsw_torch import HnswIndex

from hnswbench.engines.block import index_config


def build(config: dict, rows):
    """The bulk build. A row left with no level-0 link is found by no
    search and strands every query routed to it: such a build is refused
    here, at set-up, rather than served."""
    index = HnswIndex(index_config(config), device=rows.device).build(
        rows, mode="bulk")
    g = index.graph
    if index.n > 1 and not bool((g.neighbors0[:index.n] != g.sentinel)
                                .any(1).all()):
        raise RuntimeError("the bulk build left rows with no level-0 link")
    return index


def search(index, queries, k: int, probes: int):
    dist, ids = index.search_device(queries, k=k, ef_search=probes)
    # a missing result is the sentinel id (the capacity); the harness
    # reads -1
    return dist, torch.where(ids == index.graph.sentinel, -1, ids)


def build_stats(index) -> dict:
    return dict(index.build_stats)


def stored(index):
    n = index.n
    return (torch.arange(n, device=index.device),
            index.graph.vectors[:n])
