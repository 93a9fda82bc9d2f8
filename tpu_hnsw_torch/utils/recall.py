"""Recall and evaluation metrics.

The reference's recall harness is in-database: TAP tests compare index
scans against a sequential-scan ground truth and assert a threshold
(upstream ``pgvector:test/t/010_hnsw_build_recall.pl`` family). This is the
same contract as a library function.
"""

from __future__ import annotations

import numpy as np


def recall_at_k(result_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """Fraction of true top-k found in the returned top-k (set recall).

    Fully vectorized (sorted merge via searchsorted with per-row offsets),
    so 100k-query evaluations stay sub-second; duplicate ids within a
    result row count once, matching set-intersection semantics.
    """
    r = np.asarray(result_ids)[:, :k].astype(np.int64)
    g = np.asarray(gt_ids)[:, :k].astype(np.int64)
    nq = g.shape[0]
    rs = np.sort(r, axis=1)
    first = np.ones_like(rs, dtype=bool)
    first[:, 1:] = rs[:, 1:] != rs[:, :-1]
    lo = min(int(rs.min()), int(g.min()))
    span = max(int(rs.max()), int(g.max())) - lo + 1
    off = (np.arange(nq, dtype=np.int64) * span)[:, None]
    gf = np.sort((g - lo + off).ravel())
    rf = (rs - lo + off).ravel()
    pos = np.searchsorted(gf, rf)
    hits = np.zeros(rf.size, dtype=bool)
    ok = pos < gf.size
    hits[ok] = gf[pos[ok]] == rf[ok]
    hits &= first.ravel()
    return float(hits.sum()) / (nq * k)
