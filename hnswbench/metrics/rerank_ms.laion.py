"""rerank_ms.laion: device ms under the program's `rerank` range in the
stacked bf16 searcher, per 1,000 queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "rerank")
