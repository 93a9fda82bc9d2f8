"""System under test: ``tpu_hnsw_torch``'s ``PartitionedHnswIndex`` of
block-engine partitions built in the process from the rows where they lie
(on the card: no host copy), with the configuration's storage dtype,
scoring copy, rerank width and block slack, and served stacked through
``.sharded()`` after ``release_parts_device_state()``.

The interface of ``engines/block.py``. The index serves the
configuration's ``index_metric`` (``cosine``: pgvector's ``<=>``); the
reference scores its ``metric`` (``ip``: ``<#>``) on the same unit rows. The
stacked searcher's raw cosine score is ``-cos``, the ``<=>`` distance less
1, which on unit rows is their ``<#>``: :func:`search` passes it on as it
is, with no rounding added.
"""

from __future__ import annotations

import inspect

import torch

from tpu_hnsw_torch import HnswConfig, Metric, PartitionedHnswIndex

from hnswbench.engines.partitioned_block import KMEANS_ITERS

if "score_dtype" not in inspect.signature(PartitionedHnswIndex).parameters:
    # refused before the rows are drawn: this program builds its
    # partitions with the block engine's defaults alone
    raise ImportError("PartitionedHnswIndex takes no score_dtype, "
                      "rerank_width or block_slack")


def index_config(config: dict) -> HnswConfig:
    return HnswConfig(dim=config["dim"], metric=Metric(config["index_metric"]),
                      m=config["m"], ef_construction=config["ef_construction"],
                      dtype=config["dtype"], seed=config["build_seed"])


def build(config: dict, rows: torch.Tensor):
    if config["kmeans_iters"] != KMEANS_ITERS:
        raise ValueError(f"the partitions are built with {KMEANS_ITERS} "
                         "k-means iterations")
    pidx = PartitionedHnswIndex(
        index_config(config), n_partitions=config["partitions"],
        router=config["router"], engine="block",
        block_size=config["block_size"], device=rows.device,
        score_dtype=config["score_dtype"],
        rerank_width=config["rerank_width"],
        block_slack=config["block_slack"])
    pidx.build(rows)
    searcher = pidx.sharded()
    searcher.release_parts_device_state()
    return searcher


def search(index, queries, k: int, probes: int):
    """(the ``<#>`` scores of the unit rows, global ids): the searcher's raw
    cosine scores, ``<=>`` - 1."""
    return index.search_device(queries, k=k, probes=probes)


def build_stats(index) -> dict:
    return {}


def stored(index):
    live = index.block_gids >= 0
    return index.block_gids[live].long(), index.blocks[live]
