"""kmeans_s: median of build_stats["kmeans_s"] over the untraced builds."""

from hnswbench.readers import build_stat


def read(run):
    return build_stat(run, "kmeans_s")
