"""The control: the plain reference put in the program's place and
computed in TF32, the precision below the configuration's f32 (matrix
products of operands rounded to TF32's 10-bit mantissa, f32 sums).

It has an engine's four functions (see ``engines/block.py``): its index
holds the rows as given, and a search is the exact top-k in TF32. A sound
``correct`` has to come out false on it.
"""

from __future__ import annotations

import torch

from hnswbench import reference as R


def build(config: dict, rows: torch.Tensor):
    return rows, config["metric"]


def search(index, queries, k: int, probes: int):
    rows, metric = index
    q = torch.as_tensor(queries, dtype=torch.float32, device=rows.device)
    sc, ids = R.exact_topk(rows, q, k, metric, rounding=R.tf32)
    return R.scores_to_distances(sc, metric), ids


def build_stats(index) -> dict:
    return {}


def stored(index):
    rows = index[0]
    return torch.arange(rows.shape[0], device=rows.device), rows
