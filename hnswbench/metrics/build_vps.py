"""build_vps: rows indexed per second by the window's builds."""

from hnswbench.readers import build_vps as read  # noqa: F401
