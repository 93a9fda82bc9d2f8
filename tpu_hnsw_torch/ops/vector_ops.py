"""The ``vector`` type function surface (port of
``tpu_hnsw/ops/vector_ops.py``). Only ``binary_quantize`` is ported so
far; the rest of the surface is ROADMAP queue 1 item 5."""

from __future__ import annotations

import numpy as np
import torch


def binary_quantize(a) -> torch.Tensor:
    """``binary_quantize``: 1 where component > 0, as uint8 0/1 (pack with
    ``ops.bitops.pack_bits``). A tensor stays on its device; an array
    becomes a CPU tensor."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return (a > 0).to(torch.uint8)
