"""rerank_ms: device ms under the program's `rerank` range (the f32
gather, re-score and top-k after stage 1), per 1,000 queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "rerank")
