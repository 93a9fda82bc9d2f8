"""dispatch_ms.bulk: median host ms inside the search entry a request."""

from hnswbench.readers import dispatch_ms as read  # noqa: F401
