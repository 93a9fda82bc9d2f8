"""The run's import check: no module of JAX or of the JAX package."""

from __future__ import annotations

import sys

#: top-level module names a run may not load (compared whole:
#: ``tpu_hnsw_torch`` is not ``tpu_hnsw``)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_hnsw")


def forbidden_modules(modules=None) -> list:
    """Loaded module names whose top-level name is in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
