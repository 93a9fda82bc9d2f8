"""dispatch_ms.graph: median host ms inside the graph engine's search entry
a request (its termination tests wait on the device)."""

from hnswbench.readers import dispatch_ms as read  # noqa: F401
