"""Headline benchmark of the port — prints ONE JSON line (port of the
repository's root ``bench.py``, which runs the JAX package).

    python -m tpu_hnsw_torch.cli bench [--n N --dim D] [--device cuda]

North-star metric: QPS per device at recall@10 >= 0.95 on SIFT1M-class
data (128-d L2, m=16, ef_construction=64), baseline target 50,000 QPS.
Build throughput (target 100,000 vec/s) is reported in "extra".

The measured engine is the flagship ``BlockHnswIndex`` (an HNSW routing
graph over cluster-blocked level 0, stage 1 by the ``expand_topr``
kernel). The classical graph-traversal engine (``HnswIndex``, batched
beam search) and the flat exact scan (the seqscan analogue) are reported
in "extra" and never carry the headline.

The same environment variables and protocol as the root ``bench.py``:
real SIFT files under ``$TPU_HNSW_DATA`` when present, else a synthetic
stand-in of the same shape (``$TPU_HNSW_BENCH_DATASET``: clustered, the
default; uniform, the hard-mode control; or a named config such as
sift1m, read by ``io/datasets.load_or_synthesize``); size via
``$TPU_HNSW_BENCH_N`` (default 1,000,000), ``_D``, ``_Q``,
``$TPU_HNSW_BLOCK_SIZE``, ``$TPU_HNSW_TARGET_RECALL``, ``_DTYPE`` and
``$TPU_HNSW_BENCH_GRAPH=0`` to skip the graph engine. One warm-up build at
the measured size, then three host-input and five device-input block
builds (medians reported with every run), the probe grid on the full
query set, QPS by ``utils/evalharness.measure_qps`` (fixed-length
windows, the median of 10, cv in "extra"), the 10%-selectivity filtered
row, the graph engine's warm-up, host-input and three device-input builds
and its operating-point ladder, then the flat scan's QPS. A build is
drained by a synchronise and a host fetch.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

#: the JSON line's keys (the root bench.py's, in its order): top level
RESULT_KEYS = ("metric", "value", "unit", "vs_baseline", "extra")
#: and under "extra"
EXTRA_KEYS = (
    "n", "dim", "dtype", "index", "recall_at_10", "probes", "n_blocks",
    "block_size", "recall_target_met", "measurement",
    "block_bytes_per_element", "filtered_qps", "filtered_recall",
    "filtered_selectivity", "filtered_vs_unfiltered", "filtered_measurement",
    "hnsw_graph_qps", "hnsw_graph_recall", "hnsw_graph_ef",
    "hnsw_graph_descent_ef", "hnsw_graph_expand", "hnsw_graph_max_steps",
    "hnsw_graph_build_s", "hnsw_graph_build_stages",
    "hnsw_graph_bytes_per_element", "hnsw_graph_measurement", "flat_qps",
    "flat_recall", "flat_measurement", "build_vectors_per_sec",
    "build_vs_baseline", "build_input", "build_stages",
    "build_vectors_per_sec_host_input", "build_stages_host_input",
    "warmup_s", "dataset")
#: block probe counts tried in turn for the operating point
PROBE_GRID = (4, 8, 16, 32, 64, 128)
#: graph operating points, cheapest first: (descent_ef, ef_search, expand,
#: max_steps); max_steps 0 runs the beam to convergence. The first point
#: that meets the target on the full query set is measured.
GRAPH_LADDER = ((16, 16, 3, 4), (24, 16, 3, 4), (16, 16, 3, 5),
                (16, 16, 4, 4), (24, 16, 2, 5), (8, 16, 4, 5), (8, 24, 4, 6),
                (8, 24, 4, 7), (8, 40, 4, 9), (8, 64, 4, 0), (8, 128, 1, 0),
                (8, 200, 1, 0))
FILTER_SEED, FILTER_SHARE = 17, 0.10


def filter_mask(n: int) -> np.ndarray:
    """The filtered row's id mask: FILTER_SHARE of ``n`` ids pass."""
    return np.random.default_rng(FILTER_SEED).random(n) < FILTER_SHARE


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None) -> dict:
    """Run the benchmark on ``device`` (default: the card), print the JSON
    line and return it as a dict."""
    from tpu_hnsw_torch import (BlockHnswIndex, FlatIndex, HnswConfig,
                                HnswIndex, Metric)
    from tpu_hnsw_torch.io.datasets import (load_or_synthesize,
                                            synthetic_clustered,
                                            synthetic_uniform)
    from tpu_hnsw_torch.utils.device import entry_device
    from tpu_hnsw_torch.utils.evalharness import measure_qps
    from tpu_hnsw_torch.utils.recall import recall_at_k

    dev = entry_device(device)
    n = int(os.environ.get("TPU_HNSW_BENCH_N", 1_000_000))
    dim = int(os.environ.get("TPU_HNSW_BENCH_D", 128))
    n_queries = int(os.environ.get("TPU_HNSW_BENCH_Q", 4096))
    block_size = int(os.environ.get("TPU_HNSW_BLOCK_SIZE", 256))
    target_recall = float(os.environ.get("TPU_HNSW_TARGET_RECALL", 0.95))
    dtype = os.environ.get("TPU_HNSW_BENCH_DTYPE", "float32")
    synth = os.environ.get("TPU_HNSW_BENCH_DATASET", "clustered")
    with_graph = os.environ.get("TPU_HNSW_BENCH_GRAPH", "1") != "0"

    data_dir = os.environ.get("TPU_HNSW_DATA")
    # a named config reads <name>_base.fvecs / <name>_query.fvecs /
    # <name>_groundtruth.ivecs under $TPU_HNSW_DATA, or synthesizes an
    # equivalently-shaped stand-in without them
    if synth in ("sift10k", "sift1m", "glove100", "deep10m"):
        base, queries, _ = load_or_synthesize(synth, data_dir)
        n, dim = base.shape
        queries = queries[:n_queries]
        n_queries = len(queries)
        real = bool(data_dir) and os.path.exists(
            os.path.join(data_dir, f"{synth}_base.fvecs"))
        dataset = synth if real else f"{synth}-synthetic-standin"
    elif data_dir and n >= 1_000_000:
        base, queries, _ = load_or_synthesize("sift1m", data_dir)
        base, queries = base[:n], queries[:n_queries]
        dataset = "sift1m"
    elif synth == "uniform":
        base, queries = synthetic_uniform(n, dim, n_queries=n_queries, seed=42)
        dataset = "synthetic-uniform"
    else:
        base, queries = synthetic_clustered(n, dim, n_queries=n_queries,
                                            seed=42)
        dataset = "synthetic-clustered"

    cfg = HnswConfig(dim=dim, m=16, ef_construction=64, seed=0, dtype=dtype)

    def drain_build(bx):
        # the build's device work is done, and a host fetch proves it
        _sync(dev)
        bx.blocks_sq[0].cpu()

    # one warm-up build at the SAME n (first launches, the kernel
    # library's load, allocator growth), then medians of measured builds
    t0 = time.perf_counter()
    widx = BlockHnswIndex(cfg, block_size=block_size, device=dev).build(base)
    drain_build(widx)
    t_warm = time.perf_counter() - t0
    block_bytes_per_elem = widx.stats()["bytes_per_element"]
    del widx

    def timed_build(inp):
        t0 = time.perf_counter()
        bx = BlockHnswIndex(cfg, block_size=block_size, device=dev).build(inp)
        drain_build(bx)
        return time.perf_counter() - t0, dict(bx.build_stats), bx

    def median_build(inp, runs=3):
        times, stages_list, keep = [], [], None
        for _ in range(runs):
            t, st, bx = timed_build(inp)
            times.append(t)
            stages_list.append(st)
            if keep is None or t <= min(times[:-1], default=t):
                keep = bx  # fastest build serves the QPS phase
            else:
                del bx
        med = float(np.median(times))
        stages = stages_list[int(np.argsort(times)[len(times) // 2])]
        stages["build_runs_s"] = [round(t, 2) for t in sorted(times)]
        return med, stages, keep

    # host-input builds (pay the host-to-device copy)
    med_host, host_stages, idx = median_build(base)
    build_vps = n / med_host

    # device-resident builds: the embeddings are already on the device
    # (the embed-on-card case); five runs, median reported
    xdev = torch.from_numpy(base).to(dev)
    _sync(dev)
    med_dev, dev_stages, bx = median_build(xdev, runs=5)
    del bx
    build_vps_dev = n / med_dev
    del xdev

    oracle = FlatIndex(base, Metric.L2, device=dev)
    gt = oracle.search(queries, k=10, exact=True)[1]

    # operating point on the FULL measured query set
    probe_grid = [p for p in PROBE_GRID if p <= idx.n_blocks]
    chosen, chosen_recall = probe_grid[-1], 0.0
    for p in probe_grid:
        _, ids = idx.search(queries, k=10, probes=p)
        r = recall_at_k(ids, gt, 10)
        if r >= target_recall:
            chosen, chosen_recall = p, r
            break
        chosen_recall = r
    mstats = {}
    hnsw_qps, ids = measure_qps(
        idx, queries, 10, 4 * chosen, probes=chosen, pipeline=1,
        stats_out=mstats
    )
    hnsw_recall = recall_at_k(ids, gt, 10)

    # device-side filtered scan: 10% of ids pass; recall graded against
    # the exact filtered oracle
    fmask = filter_mask(n)
    allowed_ids = np.where(fmask)[0]
    fsub = FlatIndex(base[allowed_ids], Metric.L2, device=dev)
    fgt_local = fsub.search(queries, k=10, exact=True)[1]
    fgt = np.where(fgt_local >= 0,
                   allowed_ids[np.clip(fgt_local, 0, None)], -1)
    del fsub
    fstats = {}
    filt_qps, fids = measure_qps(
        idx, queries, 10, 8 * chosen, probes=2 * chosen, pipeline=1,
        stats_out=fstats, filter_mask=fmask)
    filt_recall = recall_at_k(fids, fgt, 10)
    n_blocks = idx.n_blocks
    filtered_extra = {
        "filtered_qps": round(float(filt_qps), 1),
        "filtered_recall": round(float(filt_recall), 4),
        "filtered_selectivity": FILTER_SHARE,
        "filtered_vs_unfiltered": round(float(filt_qps / hnsw_qps), 3),
        "filtered_measurement": fstats,
    }
    del idx

    # the classical graph-traversal engine, measured every run
    graph_extra = {}
    if with_graph:
        def g_timed_build(inp):
            t0 = time.perf_counter()
            gi = HnswIndex(cfg, device=dev).build(inp)
            _sync(dev)
            gi.graph.levels[:1].cpu()  # drain: a host fetch
            return time.perf_counter() - t0, gi

        # one warm-up build, one host-input build, then the median of
        # three device-resident builds (the block engine's ingest mode)
        g_warm_s, gidx = g_timed_build(base)
        del gidx
        g_host_s, gidx = g_timed_build(base)
        g_host_stages = getattr(gidx, "build_stats", {}).get("stages", {})
        xgdev = torch.from_numpy(base).to(dev)
        _sync(dev)
        g_runs = []
        for _ in range(3):
            del gidx
            t, gidx = g_timed_build(xgdev)
            g_runs.append(t)
        del xgdev
        g_build_s = float(np.median(g_runs))
        g_build_stages = getattr(gidx, "build_stats", {}).get("stages", {})
        g_build_stages = {**g_build_stages,
                          "warmup_build_s": round(g_warm_s, 1),
                          "build_runs_s": [round(t, 2) for t in g_runs],
                          "build_input": "device-resident",
                          "host_input_build_s": round(g_host_s, 1),
                          "host_input_stages": g_host_stages}
        # selection and measurement run the same deterministic search
        g_dce, g_ef, g_exp, g_steps, g_recall = *GRAPH_LADDER[-1], 0.0
        for dce, ef, exp, ms in GRAPH_LADDER:
            _, g_ids = gidx.search(queries, k=10, ef_search=ef,
                                   expand=exp, descent_ef=dce,
                                   max_steps=ms)
            g_recall = recall_at_k(g_ids, gt, 10)
            if g_recall >= target_recall:
                g_dce, g_ef, g_exp, g_steps = dce, ef, exp, ms
                break
        g_stats = {}
        g_qps, g_ids = measure_qps(gidx, queries, 10, g_ef, pipeline=1,
                                   stats_out=g_stats, expand=g_exp,
                                   descent_ef=g_dce, max_steps=g_steps)
        graph_extra = {
            "hnsw_graph_qps": round(float(g_qps), 1),
            "hnsw_graph_recall": round(
                float(recall_at_k(g_ids, gt, 10)), 4),
            "hnsw_graph_ef": g_ef,
            "hnsw_graph_descent_ef": g_dce,
            "hnsw_graph_expand": g_exp,
            "hnsw_graph_max_steps": g_steps,
            "hnsw_graph_build_s": round(g_build_s, 1),
            "hnsw_graph_build_stages": g_build_stages,
            "hnsw_graph_bytes_per_element": gidx.stats()[
                "bytes_per_element"],
            "hnsw_graph_measurement": g_stats,
        }
        del gidx

    # the seqscan path (pgvector's planner picks a sequential scan when it
    # beats the index) — reported, never headline
    flat_stats = {}
    flat_qps, flat_ids = measure_qps(oracle, queries, 10, 0, pipeline=1,
                                     stats_out=flat_stats)
    flat_recall = recall_at_k(flat_ids, gt, 10)

    result = {
        "metric": f"qps_per_chip_at_recall10>={target_recall}",
        "value": round(float(hnsw_qps), 1),
        "unit": "qps",
        "vs_baseline": round(float(hnsw_qps) / 50_000.0, 4),
        "extra": {
            "n": n,
            "dim": dim,
            "dtype": dtype,
            "index": "hnsw-block",
            "recall_at_10": round(float(hnsw_recall), 4),
            "probes": chosen,
            "n_blocks": n_blocks,
            "block_size": block_size,
            "recall_target_met": bool(hnsw_recall >= target_recall),
            "measurement": mstats,
            "block_bytes_per_element": block_bytes_per_elem,
            **filtered_extra,
            **graph_extra,
            "flat_qps": round(float(flat_qps), 1),
            "flat_recall": round(float(flat_recall), 4),
            "flat_measurement": flat_stats,
            "build_vectors_per_sec": round(build_vps_dev, 1),
            "build_vs_baseline": round(build_vps_dev / 100_000.0, 4),
            "build_input": "device-resident (embeddings already on the "
            "device); the host-input figure below pays the host-to-device "
            "copy; median of 5 post-warmup builds, spread in "
            "build_stages.build_runs_s",
            "build_stages": dev_stages,
            "build_vectors_per_sec_host_input": round(build_vps, 1),
            "build_stages_host_input": host_stages,
            "warmup_s": round(t_warm, 1),
            "dataset": dataset,
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
