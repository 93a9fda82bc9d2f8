"""dispatch_ms.laion: median host ms inside the stacked bf16 searcher's
entry a request."""

from hnswbench.readers import dispatch_ms as read  # noqa: F401
