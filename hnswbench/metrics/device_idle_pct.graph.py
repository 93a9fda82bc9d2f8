"""device_idle_pct.graph: share of the window traced on the device alone
with no device operation running."""

from hnswbench.readers import idle_pct as read  # noqa: F401
