"""qps: queries answered per second (a search mix)."""

from hnswbench.readers import qps as read  # noqa: F401
