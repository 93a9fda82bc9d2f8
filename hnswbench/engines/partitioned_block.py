"""System under test: ``tpu_hnsw_torch``'s ``PartitionedHnswIndex`` of
block-engine partitions, served stacked through ``.sharded()`` after
``release_parts_device_state()`` (``scripts/config_d.py``'s way).

The interface of ``engines/block.py``. The partitions are built with the
block engine's own defaults (``PartitionedHnswIndex`` takes no other), so
the configuration has to state those.
"""

from __future__ import annotations

from typing import NamedTuple

from tpu_hnsw_torch import BlockHnswIndex, PartitionedHnswIndex

from hnswbench import reference as R
from hnswbench.engines.block import index_config

#: ``BlockHnswIndex.build``'s k-means iterations, which each partition uses
KMEANS_ITERS = 10


class Served(NamedTuple):
    searcher: object  # the ShardedBlockSearcher
    metric: str


def _check(config: dict) -> None:
    probe = BlockHnswIndex(index_config(config), device="cpu")
    have = {"rerank_width": probe.rerank_width,
            "score_dtype": probe.score_dtype,
            "block_slack": probe.block_slack,
            "kmeans_iters": KMEANS_ITERS}
    wrong = {k: (config[k], v) for k, v in have.items() if config[k] != v}
    if wrong:
        raise ValueError(f"the partitions are built with {have}; the "
                         f"configuration states otherwise: {wrong}")


def build(config: dict, rows):
    _check(config)
    pidx = PartitionedHnswIndex(index_config(config),
                                n_partitions=config["partitions"],
                                router=config["router"], engine="block",
                                block_size=config["block_size"],
                                device=rows.device)
    pidx.build(rows.cpu().numpy())  # the build takes host rows
    searcher = pidx.sharded()
    searcher.release_parts_device_state()
    return Served(searcher, config["metric"])


def search(index: Served, queries, k: int, probes: int):
    sc, ids = index.searcher.search_device(queries, k=k, probes=probes)
    return R.scores_to_distances(sc, index.metric), ids


def build_stats(index) -> dict:
    return {}


def stored(index: Served):
    live = index.searcher.block_gids >= 0
    return index.searcher.block_gids[live].long(), index.searcher.blocks[live]
