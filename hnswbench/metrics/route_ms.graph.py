"""route_ms.graph: device ms under the program's `route_scan` range (the
dense scan of the graph's level >= 1 elements), per 1,000 queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "route_scan")
