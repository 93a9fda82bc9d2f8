"""Faults planted under the timed path, to show that ``correct`` catches
them (``hnswbench/tests``) and to read them at a cell's own size
(:mod:`hnswbench.calibrate`).

:class:`Faulty` is the configuration's engine with one fault planted where
an answer or an index is produced:

- ``stale``: each request gets the previous request's answers;
- ``half_batch``: the second half of a request answered with the first
  half's answers;
- ``altered_answer``: each query's first id moved to the next row;
- ``route_one_probe``: the route probes one block a query (a partition,
  in a stacked searcher) in place of the configuration's probes;
- ``stage1_quarter``: the fused stage-1 kernel scans only every fourth
  block it is given (the others read as absent), so it drops three
  quarters of its candidates; the rerank is sound;
- ``unchanged`` (a build): the build returns what it was given;
- ``half_rows`` (a build): half the rows are indexed;
- ``altered_row`` (a build): one stored value is changed.
"""

from __future__ import annotations

import contextlib

from hnswbench import spec

SEARCH = ("stale", "half_batch", "altered_answer", "route_one_probe",
          "stage1_quarter")
BUILD = ("unchanged", "half_rows", "altered_row")


@contextlib.contextmanager
def _stage1_quarter():
    """The program's ``expand_topr`` given only every fourth probed block
    (the others as id -1, which the kernel scores +inf), while inside."""
    import torch
    from tpu_hnsw_torch.ops import expand as X

    inner = X.expand_topr

    def cut(blocks, blocks_sq, block_ids, q, q_sq, bids, *a, **kw):
        keep = torch.arange(bids.shape[1], device=bids.device) % 4 == 0
        bids = torch.where(keep[None, :], bids, torch.full_like(bids, -1))
        return inner(blocks, blocks_sq, block_ids, q, q_sq, bids, *a, **kw)

    X.expand_topr = cut
    try:
        yield
    finally:
        X.expand_topr = inner


class Faulty:
    """The configuration's engine (see ``engines/block.py``) with the fault
    ``fault`` planted."""

    def __init__(self, fault: str, config: dict):
        if fault not in SEARCH + BUILD:
            raise ValueError(f"unknown fault {fault!r}")
        self.inner = spec.module("engines", config["engine"])
        self.fault = fault
        self.n = config["rows"]
        self.last = None

    def build(self, config, rows):
        if self.fault == "half_rows":
            return self.inner.build(config, rows[:rows.shape[0] // 2])
        if self.fault == "unchanged":
            return self.inner.index_config(config)
        index = self.inner.build(config, rows)
        if self.fault == "altered_row":
            index.blocks[0, 0, 0] += 1.0
        return index

    def search(self, index, queries, k, probes):
        if self.fault == "route_one_probe":
            probes = 1
        cut = _stage1_quarter() if self.fault == "stage1_quarter" \
            else contextlib.nullcontext()
        with cut:
            dist, ids = self.inner.search(index, queries, k, probes)
        if self.fault == "stale":
            prev, self.last = self.last, (dist.clone(), ids.clone())
            if prev is not None and prev[0].shape == dist.shape:
                dist, ids = prev
        elif self.fault == "half_batch":
            h = dist.shape[0] // 2
            dist, ids = dist.clone(), ids.clone()
            dist[h:], ids[h:] = dist[:dist.shape[0] - h], ids[:ids.shape[0] - h]
        elif self.fault == "altered_answer":
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + 1) % self.n
        return dist, ids

    def build_stats(self, index):
        return dict(getattr(index, "build_stats", {}))

    def stored(self, index):
        return self.inner.stored(index)
