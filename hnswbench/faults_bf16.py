"""The precision below a bf16 configuration's, for its ``dist_gap`` limit:
a sound limit for bf16 storage has to come out false on both of these.

- :class:`Fp8Reference`, the control: the plain reference
  (:mod:`hnswbench.reference`) put in the program's place and computed
  with both operands of each product rounded to fp8 e4m3 (f32 sums), as
  :mod:`hnswbench.control` computes it in TF32 below f32;
- :class:`Fp8Rerank`, a fault: the configuration's engine with the rows
  its rerank reads rounded to fp8 e4m3, while stage 1 still scores the
  bf16 copy. It serves a stacked searcher (``engines/partitioned_bf16.py``)
  or a ``BlockHnswIndex``: their ``blocks`` become the rounded rows and a
  scoring copy that aliased them keeps the exact ones, so the index holds
  both (twice the blocks' bytes).

Each has an engine's four functions (see ``engines/block.py``); read one at
a cell's size as a side of a run::

    cell = spec.cell(spec.load_benchmark(), "laion12m5.bulk")
    run_cell(cell, 7, 10.0, False, torch.device("cuda"),
             engine=faults_bf16.Fp8Rerank(cell["config"]))
"""

from __future__ import annotations

import torch

from hnswbench import reference as R
from hnswbench import spec

#: the format one step below bf16 (3 mantissa bits against 7)
FP8 = torch.float8_e4m3fn
#: rows rounded at once (bounds the fp8 temporary)
STEP_ROWS = 1 << 20


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3, as f32: the operands an fp8 product
    reads. The product of two such values is exact in f32."""
    return x.float().to(FP8).float()


def fp8_rounded(blocks: torch.Tensor) -> torch.Tensor:
    """``blocks`` rounded to fp8 e4m3 and back to their dtype."""
    flat = blocks.reshape(-1, blocks.shape[-1])
    out = torch.empty_like(flat)
    for s in range(0, flat.shape[0], STEP_ROWS):
        out[s:s + STEP_ROWS] = flat[s:s + STEP_ROWS].to(FP8).to(blocks.dtype)
    return out.view(blocks.shape)


class Fp8Reference:
    """The exact top-k of the rows as given, computed in fp8 e4m3."""

    def build(self, config, rows):
        return rows, config["metric"]

    def search(self, index, queries, k, probes):
        rows, metric = index
        q = torch.as_tensor(queries, dtype=torch.float32, device=rows.device)
        sc, ids = R.exact_topk(rows, q, k, metric, rounding=fp8)
        return R.scores_to_distances(sc, metric), ids

    def build_stats(self, index):
        return {}

    def stored(self, index):
        rows = index[0]
        return torch.arange(rows.shape[0], device=rows.device), rows


class Fp8Rerank:
    """The configuration's engine with its rerank reading fp8-rounded
    rows."""

    def __init__(self, config: dict):
        self.inner = spec.module("engines", config["engine"])

    def build(self, config, rows):
        index = self.inner.build(config, rows)
        # the scoring copy, aliasing or not, keeps the exact rows
        index.blocks = fp8_rounded(index.blocks)
        return index

    def search(self, index, queries, k, probes):
        return self.inner.search(index, queries, k, probes)

    def build_stats(self, index):
        return self.inner.build_stats(index)

    def stored(self, index):
        return self.inner.stored(index)
