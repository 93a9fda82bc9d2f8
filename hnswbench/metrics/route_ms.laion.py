"""route_ms.laion: device ms under the program's `route` range in the
stacked bf16 searcher (the GEMM + top-k chain), per 1,000 queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "route")
