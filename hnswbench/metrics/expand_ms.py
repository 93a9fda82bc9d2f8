"""expand_ms: device ms under the program's `expand` range, per 1,000
queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "expand")
