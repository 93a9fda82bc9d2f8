"""dispatch_ms.stacked: median host ms inside the stacked searcher's entry
a request."""

from hnswbench.readers import dispatch_ms as read  # noqa: F401
