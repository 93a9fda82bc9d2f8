"""assign_s: median of build_stats["balanced_assign_s"] over the untraced
builds."""

from hnswbench.readers import build_stat


def read(run):
    return build_stat(run, "balanced_assign_s")
