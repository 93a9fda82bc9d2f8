"""p95_ms: 95th percentile of request latency (a search mix)."""

from hnswbench.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
