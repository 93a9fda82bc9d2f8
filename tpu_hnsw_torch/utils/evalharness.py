"""Evaluation harness (port of ``tpu_hnsw/utils/evalharness.py``): exact
ground truth, steady-state QPS, and recall/QPS sweeps as plain dicts."""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_hnsw_torch.index.flat import FlatIndex
from tpu_hnsw_torch.utils.recall import recall_at_k


def ground_truth(base, queries, k, metric, device=None):
    """Ids of the k nearest rows by :class:`FlatIndex` (its default path:
    scan + exact f32 rerank), on ``device`` (default: the card)."""
    return FlatIndex(base, metric, device=device).search(queries, k=k)[1]


def measure_qps(index, queries, k, ef_search, repeats: int = 10,
                pipeline: int = 8, min_window_s: float = 0.25,
                stats_out: dict | None = None, **search_kw):
    """Warm, then the median QPS over ``repeats`` windows of fixed length.

    With ``search_device``, the queries are uploaded to the index's device
    once and sliced into chunks of ``max(64, nq // pipeline)``; one pass
    dispatches every chunk, a window runs as many passes as fill
    ``min_window_s`` (calibrated on one pass) and ends with
    ``torch.cuda.synchronize()`` (on a CUDA device) and a host fetch of the
    last chunk's ids. The spread lands in ``stats_out`` (qps_cv, qps_min,
    qps_max, window_passes, windows). Returns (median QPS, ids of the last
    pass, the graph sentinel mapped to -1)."""
    dev = getattr(index, "search_device", None)
    if dev is None:
        index.search(queries[: min(len(queries), 8)], k=k, ef_search=ef_search)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            _, ids = index.search(queries, k=k, ef_search=ef_search)
            times.append(time.perf_counter() - t0)
        return len(queries) / float(np.median(times)), ids

    nq = len(queries)
    chunk = max(64, nq // pipeline)
    qhost = np.ascontiguousarray(np.asarray(queries, np.float32))
    if not np.isfinite(qhost).all():
        raise ValueError("NaN or infinity values are not allowed")
    qdev = torch.from_numpy(qhost).to(index.device)
    on_cuda = qdev.device.type == "cuda"
    batches = [qdev[i:i + chunk] for i in range(0, nq, chunk)]

    def one_pass():
        return [dev(b, k=k, ef_search=ef_search, **search_kw)
                for b in batches]

    def drain(out):
        # the device runs the chunks in order: the last one's ids on the
        # host bound the whole window
        if on_cuda:
            torch.cuda.synchronize()
        out[-1][1].cpu()

    out = one_pass()  # warm-up
    drain(out)
    t0 = time.perf_counter()
    out = one_pass()
    drain(out)
    dt1 = time.perf_counter() - t0
    loops = max(1, int(min_window_s / max(dt1, 1e-6)))
    qpss = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(loops):
            out = one_pass()
        drain(out)
        qpss.append(loops * nq / (time.perf_counter() - t0))
    qpss = np.asarray(qpss)
    med = float(np.median(qpss))
    if stats_out is not None:
        stats_out.update(
            qps_cv=round(float(qpss.std() / max(qpss.mean(), 1e-9)), 4),
            qps_min=round(float(qpss.min()), 1),
            qps_max=round(float(qpss.max()), 1),
            window_passes=loops,
            windows=repeats,
        )
    ids = torch.cat([o[1] for o in out]).cpu().numpy()
    sent = getattr(getattr(index, "graph", None), "sentinel", None)
    if sent is not None:
        ids = np.where(ids == sent, -1, ids)
    return med, ids


def sweep(index, queries, gt, k=10, efs=(10, 20, 40, 80, 120, 200, 400)):
    """recall/QPS curve over ef_search (BASELINE config B protocol)."""
    rows = []
    for ef in efs:
        if ef < k:
            continue
        qps, ids = measure_qps(index, queries, k, ef)
        rows.append(
            {"ef_search": ef, "recall": recall_at_k(ids, gt, k), "qps": qps}
        )
    return rows


def qps_at_recall(index, queries, gt, target=0.95, k=10,
                  efs=(10, 20, 40, 60, 80, 120, 160, 240, 320, 400)):
    """The smallest ef of the sweep meeting the recall target: (qps, recall,
    ef); the best-recall point when none does (its recall < target flags
    it)."""
    best = None
    for ef in efs:
        if ef < k:
            continue
        qps, ids = measure_qps(index, queries, k, ef)
        r = recall_at_k(ids, gt, k)
        row = (qps, r, ef)
        if r >= target:
            return row
        if best is None or r > best[1]:
            best = row
    return best
