"""System under test: ``tpu_hnsw_torch``'s ``BlockHnswIndex``, built on a
device tensor and served through ``search_device``.

Each engine file gives the harness four functions: ``build(config, rows)``
(an index over a device tensor of rows), ``search(index, queries, k,
probes)`` ((distances in pgvector operator units, ids), on the device),
``build_stats(index)`` and ``stored(index)`` (the ids and rows its live
slots hold).
"""

from __future__ import annotations

from tpu_hnsw_torch import BlockHnswIndex, HnswConfig


def index_config(config: dict) -> HnswConfig:
    return HnswConfig(dim=config["dim"], metric=config["metric"],
                      m=config["m"], ef_construction=config["ef_construction"],
                      seed=config["build_seed"])


def build(config: dict, rows):
    idx = BlockHnswIndex(index_config(config),
                         block_size=config["block_size"],
                         block_slack=config["block_slack"],
                         device=rows.device)
    idx.rerank_width = config["rerank_width"]
    idx.score_dtype = config["score_dtype"]
    return idx.build(rows, kmeans_iters=config["kmeans_iters"])


def search(index, queries, k: int, probes: int):
    return index.search_device(queries, k=k, probes=probes)


def build_stats(index) -> dict:
    return dict(index.build_stats)


def stored(index):
    live = index.block_ids >= 0
    return index.block_ids[live].long(), index.blocks[live]
