"""beam_ms: device ms under the program's `beam_level0` range (the lockstep
level-0 beam), per 1,000 queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "beam_level0")
