"""merge_ms.laion: device ms under the program's `ici_merge` range (the
stacked merge of the four bf16 partitions), per 1,000 queries."""

from hnswbench.readers import range_ms_per_1k


def read(run):
    return range_ms_per_1k(run, "ici_merge")
