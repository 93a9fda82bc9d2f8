"""Where the port's entry points run: the card unless the caller names
another device. Nothing falls back to the CPU."""

from __future__ import annotations

import torch


def entry_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises for a CUDA device on a
    host without one."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return dev
