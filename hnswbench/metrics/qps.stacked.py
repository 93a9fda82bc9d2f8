"""qps.stacked: queries answered per second by the stacked searcher (a
search mix): the same reading as ``qps``, held to its own bound."""

from hnswbench.readers import qps as read  # noqa: F401
