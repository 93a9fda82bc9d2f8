"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py config_e    # the kernel builds and phase 8 alone
    python3 chip_smoke.py route       # the route kernel's build and phase 3b
    python3 chip_smoke.py beam        # the beam kernel's build, the 1M
                                      # graph and phase 5's beam check

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):

1. require CUDA, then print the card (``nvidia-smi`` name and power limit);
2. build the kernel libraries (``expand_score``, ``hamming_scan``,
   ``route_topk``, ``beam_search``) from ``tpu_hnsw_torch/csrc``, one
   ``nvcc`` process each,
   started together,
   and print each kernel's ``-Xptxas=-v`` registers, spills and shared
   memory;
   once the host data is made (below), the three merges of
   ``parallel/collectives.py`` under a one-rank NCCL group (a file
   rendezvous on the loopback device), each equal to the local merge;
3. hold both entries of ``csrc/expand_score.cu`` against their plain
   PyTorch versions at main-path shapes (Q=1024, S=256, d=128, B=4102,
   uniform random bids): ``expand_score`` at p in {8, 32} in f32, bf16 and
   int8, L2 and IP, plus the filter mask (int8, p=8); ``expand_topr``
   (int8: keys exactly equal, L2 and IP, masked and not, r in {1, 40, 100,
   128}, Q=1024 and a ragged 76; f32 and bf16 at r=40 within RTOL), here
   and at every later shape on each route the shape allows (the ring, and
   the grouped route where a query's keys fit its merge); time both
   entries, the fused entry's routes in turns, and the earlier design's
   composite (all scores, then ``torch.topk``) with CUDA events;
3b. the route kernel (``csrc/route_topk.cu``) at the benchmark cells'
   shapes (p 8) and the CLI eval's and bench grid's wider p: ids equal to
   its plain version's on integer rows, within the f32 tolerance of
   float64 on normal rows, timed beside its bound, the plain version and
   the library chain it replaced; the route's counters (``ROUTE_LAUNCHES``)
   must equal the calls made on each path, here, in the block path and in
   config D;
4. the block path at full size: ``BlockHnswIndex`` over
   ``synthetic_clustered(1_000_000, 128, n_queries=4096, seed=42)``, built
   from host input and from a CUDA tensor, graded against the port's
   ``FlatIndex.search(exact=True)`` over bench.py's probe grid until
   recall@10 >= 0.95, then QPS over 1024-query chunks; stage 1 timed at
   the routed bids of the first 1024 queries; a ``torch.profiler``
   breakdown of one 1024-query ``search_device`` chunk (top device ops,
   device-busy time over the unprofiled host wall time); the oracle timed
   beside the ``torch.topk``-order scan it replaced; the default flat scan
   and ``FlatIndex(scan_dtype="int8")`` over the oracle's table in turns
   (``int8_scan_timing``: QPS, recall@10 >= 0.99 for int8, build seconds,
   resident and peak memory, a profiled 1024-query call of each by op
   class, one tile of each in its parts (GEMM, epilogue, keyed select)
   and the bytes ``torch._int_mm`` allocates beyond its product); the
   same chunk
   under ``utils/profiling.trace``: device and host ms of the ``route``
   and ``expand`` ranges, and the host cost of an annotation outside a
   trace;
5. filter and lifecycle on that index: the 10%-selectivity filter of
   bench.py, add, delete, filtered ``search_iterative``, ``compact`` and a
   ``save``/``load`` round trip; then the port's CLI and planner on the
   same rows: the rows and queries written as .fvecs and a uint8 copy as
   .bvecs, each read back by the native parser (``io/native.py``, which
   must load) and by numpy (equal arrays, GB/s); ``python -m
   tpu_hnsw_torch.cli build --type block``, ``search`` (printed distances
   checked against the ids' L2) and ``eval --gt`` (the oracle's ids as
   .ivecs; recall@10 >= 0.95 at some ef_search), each a subprocess on the
   card; ``tpu_hnsw_torch.cli bench`` at its default 1M x 128 (the root
   bench.py's JSON keys, recall target met); ``expand_topr`` against its
   plain version at the CLI's and the bench's shapes (int8 keys exactly
   equal) on the bids the CLI's saved index routes: search's 4,096
   queries at ef_search 40, eval's 512-query chunks at every probe count
   of its sweep (3 to 105), the bench's 4,096 queries at each grid point
   up to its probes and, with its 10% filter mask, at twice them (stage 1
   also timed at the eval chunk of the most probes, 105: the most
   candidates a query);
   ``planner.calibrate()`` (five finite constants; its 2,048-query stage-1
   call on random bids against the plain version), each estimator beside
   the bench's QPS, the two constants ``planner.anchor`` solves from this
   run, and ``choose_engine(1M, 128)`` on a sample of the bench's own rows:
   it must pick the bench's fastest engine, or fail only as the structure
   gate's known reference defect (ROADMAP queue 3), recorded as an
   expected failure; then the graph engine on the same rows
   (bulk build, and again with ``refine_rounds=1``: its stages and recall
   at the ladder's first two points beside the default build's; bench.py's
   ladder, QPS; the level-0 beam kernel (``csrc/beam_search.cu``) against
   the torch loop at the graph cell's shape, 4,096 queries at ef 40: ids
   on >= 99.9% of rows, everything equal on integer-valued rows, timed
   beside its bound and the loop, ``BEAM_LAUNCHES`` equal to the calls
   made on each path; graph-routed ``BlockHnswIndex``,
   graph add/delete/compact/iterative/save-load);
6. ``IvfFlatIndex(128, L2, lists=1000)`` on the same rows: build, recall@10
   and QPS (``utils/evalharness.measure_qps``) at probes 1-32, peak
   memory, add, delete, filtered ``search_iterative``, save/load; then
   ``PartitionedHnswIndex`` over them: 8 centroid partitions (route_k 2,
   5% replicas, block engine) with recall, no duplicate id, DML, compact,
   a filtered ``search_iterative`` and save/load, and 4 graph-engine hash
   partitions over 200,000 rows; then both through their stacked
   searchers (``sharded()``) against the host loop, ring against gather,
   and ``ShardedBlockSearcher.from_saved`` in slabs of a quarter of a
   partition: ids equal to the in-memory searcher's, peak memory within
   the serving bytes plus two slabs and 16 MB;
7. config D at full width: ``synthetic_clustered(10_000_000, 96,
   n_queries=8192, seed=13)`` L2-normalised, 8 hash partitions of
   ``BlockHnswIndex`` (inner product, block 256), the exact oracle over all
   rows and the int8 flat scan beside the default one on its table
   (``int8_scan_timing``, the first 4,096 queries); ``expand_topr`` at
   d=96 IP against its plain version; recall@10 over the probe grid to the
   first point >= 0.95, QPS there, 8
   ``expand_topr`` launches a chunk, a profiled chunk, the host-loop
   ``search`` against ``search_device`` (equal up to tied distances), peak
   memory; then the same index through ``sharded()``: ids against the host
   loop's ``search_device``, ``release_parts_device_state``, the probe grid,
   QPS, one ``expand_topr`` launch a chunk, a profiled chunk and the
   serving peak beside the host loop's, and ``expand_topr`` at the stacked
   shape (8,192 virtual queries over the 41,016 stacked blocks) against
   its plain version and timed;
8. config E's per-card shard at full width: 25M x 512 bf16 cosine (a
   quarter of LAION-100M, ``BASELINE.json`` config E, over four cards) as
   eight hash partitions of ``scripts/config_e_12m5.py``'s shape (3.125M
   rows, block 128, slack 1.10, a bf16 scoring copy aliasing the blocks),
   its recipe drawn on the card: each part built, graded against the
   exact oracle over its stored rows, saved to a temporary directory (the
   disk must hold about 28.6 GB, or the phase raises) and freed in turn;
   the oracle merged over the parts; ``ShardedBlockSearcher.from_saved``
   (seconds, stacked bytes above 2^32, ``blocks_score is blocks``, peak
   within the serving bytes plus two slabs and 16 MB); with its counters
   at 0, recall@10 and QPS (``measure_qps``, 256-query chunks) at the
   reference's 8, 17 and 34 probes a partition (doubled up to 136 until
   one reaches 0.95) beside the reference's curve, one ``expand_topr``
   launch a chunk, distinct ids in range, distances equal to 1 - q.x of
   the stored rows, a profiled chunk; then ``expand_topr`` in bf16 at the
   stacked shape (2,048 virtual queries, r = 128) against its plain
   version at routed bids (p 17, and p 8 on both routes) and at bids past
   2^32 bytes, each timed;
9. the lockstep build (``parallel/mesh_build.py``): 8 hash partitions of
   the graph engine over the first 200,000 of the 1M x 128 rows built with
   ``build(mesh="auto")`` against each partition's rows built by
   ``HnswIndex(capacity=25_000).build(mode="wave")`` in turn (every graph
   tensor, entry and level equal), both times; a profiled steady wave of
   each; recall@10 at ef_search 64 through ``search`` (the beam kernel)
   and ``sharded()`` (the torch loop): ids equal but for near-ties;
   the sequential bulk build's time for scale; then the lockstep build of
   all 1M rows (dense-scan seeding past 4,096 upper elements a
   partition), its time and recall@10;
10. the sparse cell of ``scripts/config_sparse.py``: ``synthetic_splade(
   1_000_000, vocab=30522, nnz=128, n_queries=1024, seed=13)`` and
   ``SparseHnswIndex(metric="ip", engine="block", proj_dim=256,
   block_size=256, seed=0)``: the exact ``SparseFlatIndex(IP)`` oracle over
   every row, the build by stage, the projection table on the card against
   its CPU rows, ``expand_topr`` (r 50, 100) and ``expand_score`` (rerank_k
   200) at the path's routed shapes against their plain versions and timed;
   then the path with its counters at 0: recall@10 and QPS at rerank_k 50,
   100 and 200 beside the reference's recall curve
   (``benchmarks/config_sparse.json``), exact distances, peak memory, a
   profiled call; then the first 100,000 rows (a cut of scale): the graph
   engine (IP), the block engine in L2 and cosine, add of rows with unseen
   coordinates, delete, compact and save/load;
11. the binary path at full width: ``binary_quantize`` of
   ``synthetic_clustered(1_000_000, 1536, n_queries=4096, seed=42)`` (the
   shape of dbpedia-entities-openai-1M, binary-quantized as pgvector's
   README does). Both hamming entries against their plain versions,
   exactly: ``hamming_scan`` at 1024 x 1M x 48 words, a ragged 47, and the
   all-pairs branch's first and last query chunks (partly filled query
   tiles); ``hamming_topk`` for hamming and jaccard at Q=1024 and a ragged
   Q=76, k in {1, 10, 100}, and at W=47 (k in {10, 100}); beside them
   ``torch._int_mm`` of the 0/1 int8 expansion, bare and with the affine
   step (the library yardsticks), with ``nvidia-smi`` clocks and power
   sampled during the timings. Then the path itself: the
   ``BinaryFlatIndex`` oracle (fused top-k), its QPS and peak extra memory
   over 4096 queries for both metrics beside the all-pairs design (whose
   launches, a comparison, are not counted), one search with k above the
   fused limit;
   ``BinaryHnswIndex`` hamming (probe grid to tie-aware recall@10 >= 0.95,
   exact distances, QPS) and jaccard (rerank_k=100, exact distances);
   ``expand_score`` and ``expand_topr`` at d=1536 on each index's int8
   copy (hamming L2, jaccard cosine; masked and not), and stage 1 timed at
   the bids each index's own routing gives the first 1024 queries; a
   ``torch.profiler`` breakdown of one 1024-query hamming search;
12. print each phase's seconds, the kernel table as one JSON line
    (launches per path, times, bounds), the card line, and last ``{"ok":
    true, "device": {...}}``.

The host data of config D, the sparse cell and the binary path (about 130
s of numpy) is made by three spawned processes while the kernels build
and the 1M x 128 rows are made; they are joined before the first timed
phase (``HostData``) and stopped on exit.

Each path's kernel launch counters are set to 0 just before it and read
just after it (a CLI subprocess prints its own counts when it ends);
launches made to compare a kernel with its plain version are not
counted. Stage 1 of the block, lifecycle, CLI (search and eval), bench,
planner (``calibrate``), graph-routed, partitioned (centroid, config D,
stacked config D and config E), sparse and binary paths must launch
``expand_topr`` (stacked config D and config E once a chunk), and over
all of them each of its two routes (``topr_route``) must have been
launched; the
lifecycle's filtered ``search_iterative`` and the sparse path at rerank_k
200 widen past the fused limit and must launch ``expand_score`` too. The
lockstep build launches no kernel (the graph engine is torch ops); its
count is read all the same. A
kernel's ``launches`` in the JSON line sums its paths'. ``bound_ms`` is
the larger of the bytes a call must move (each input read once, each
output written once) over 3.35 TB/s and its operations over the data
sheet's peak for their type (int8: 1,979 TOP/s; bf16: 989 TFLOP/s; f32
outside the tensor cores: 67 TFLOP/s).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from tpu_hnsw_torch import (BinaryFlatIndex, BinaryHnswIndex, BlockHnswIndex,
                            FlatIndex, HnswConfig, HnswIndex, IvfFlatIndex,
                            Metric, PartitionedHnswIndex,
                            ShardedBlockSearcher)
from tpu_hnsw_torch import bench as BN
from tpu_hnsw_torch import planner as PL
from tpu_hnsw_torch.index.block import (_make_score_copy, _pad_cols,
                                        _quantize_rows)
from tpu_hnsw_torch.index import flat as FL
from tpu_hnsw_torch.index import search as SE
from tpu_hnsw_torch.index.build_cluster import build_bulk
from tpu_hnsw_torch.io import datasets as DS
from tpu_hnsw_torch.io import native
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import _nvcc
from tpu_hnsw_torch.ops import beam as BM
from tpu_hnsw_torch.ops import bitops as BO
from tpu_hnsw_torch.ops import expand as X
from tpu_hnsw_torch.ops import hamming as H
from tpu_hnsw_torch.ops import route as R
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.ops.vector_ops import binary_quantize
from tpu_hnsw_torch.parallel import collectives as C
from tpu_hnsw_torch.utils import profiling
from tpu_hnsw_torch.utils import evalharness as E
from tpu_hnsw_torch.utils.evalharness import measure_qps
from tpu_hnsw_torch.utils.recall import recall_at_k

from hnswbench import roofline_graph
from hnswbench.roofline import bound, expand_bound

N, DIM, NQ, DATA_SEED = 1_000_000, 128, 4096, 42
BLOCK = 256
PROBE_GRID = BN.PROBE_GRID  # the port's bench grid (bench.py:160)
TARGET_RECALL = 0.95
CHUNK = 1024
KERNEL_Q = 1024
# the kernel against its plain version, as a fraction of the L2 form's
# cancellation scale max(q_sq) + max(x_sq) plus |want|: int8 dots are exact
# integers (only the dequantising multiply rounds); f32 differs in summation
# order only; bf16 too, with a looser bound for its bf16-rounded operands
RTOL = {"int8": 1e-6, "float32": 1e-5, "bfloat16": 1e-3}
BIN_DIM = 1536             # dbpedia-entities-openai-1M's width, in bits
RAGGED_Q = 76              # a query count that ends in a partly filled tile
FILTER_SEED, FILTER_SHARE = BN.FILTER_SEED, BN.FILTER_SHARE
N_ADD = 10_000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


class Sampler:
    """``nvidia-smi`` clocks, power and temperature every 100 ms while the
    block runs; the process is stopped on exit."""

    FIELDS = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.FIELDS}",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        rows = [[float(v) for v in line.split(",")]
                for line in out.strip().splitlines()
                if line.count(",") == 3 and "N/A" not in line]
        self.summary = {"samples": len(rows)}
        for i, name in enumerate(self.FIELDS.split(",")):
            vals = [r[i] for r in rows]
            if vals:
                self.summary[name] = {"min": min(vals), "max": max(vals),
                                      "median": float(np.median(vals))}
        return False


PHASE_S: dict = {}


@contextmanager
def phase(name: str):
    """Prints and keeps the seconds a phase of this script takes."""
    t0 = time.perf_counter()
    yield
    PHASE_S[name] = round(time.perf_counter() - t0, 3)
    print(f"phase {name}: {PHASE_S[name]} s", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sampled_ms(fn, seconds: float = 1.0) -> tuple[float, dict]:
    """cuda_ms over enough calls to fill about ``seconds``, with
    ``nvidia-smi`` sampling that window."""
    est = cuda_ms(fn, 3, 1)
    reps = max(5, int(seconds * 1e3 / max(est, 1e-3)))
    with Sampler() as smi:
        ms = cuda_ms(fn, reps, 0)
    return ms, smi.summary


def kernel_phase(base: np.ndarray, queries: np.ndarray, card: str,
                 dev: torch.device) -> list:
    """The kernel against expand_score_reference at main-path shapes. The
    blocks are the corpus in storage order (rows past n are pad, id -1);
    block choices are uniform random, the cold-cache case."""
    B = math.ceil(N * 1.05 / BLOCK)  # the main path's block count, 4102
    rows = torch.zeros((B * BLOCK, DIM), dtype=torch.float32, device=dev)
    rows[:N] = torch.from_numpy(base).to(dev)
    blocks = rows.reshape(B, BLOCK, DIM)
    ids = torch.arange(B * BLOCK, dtype=torch.int32, device=dev)
    block_ids = torch.where(ids < N, ids, -1).reshape(B, BLOCK)
    q = torch.from_numpy(queries[:KERNEL_Q]).to(dev)
    q_sq = (q * q).sum(1)
    blocks_sq = (blocks * blocks).sum(-1)  # exact norms, as the index keeps
    copies = {"float32": (blocks, None),
              "bfloat16": _make_score_copy(blocks, "bf16"),
              "int8": _make_score_copy(blocks, "int8")}
    q8, q_scl = _quantize_rows(q)
    rng = np.random.default_rng(0)
    results = []
    cscale = (blocks_sq.max() + q_sq.max()).item()
    topr, timing = [], None
    for dtype, (bl, scale) in copies.items():
        kw = {} if scale is None else dict(q8=q8, q_scale=q_scl,
                                            score_scale=scale)
        for p in (8, 32):
            bids = torch.from_numpy(
                rng.integers(0, B, size=(KERNEL_Q, p))).to(dev)
            for metric in (Metric.L2, Metric.IP):
                args = (bl, blocks_sq, block_ids, q, q_sq, bids, metric)
                results.append(expand_variant(
                    args, kw, dtype, metric, card, cscale,
                    shape=dict(Q=KERNEL_Q, p=p, S=BLOCK, d=DIM, B=B)))
                if p != 8:
                    continue
                if dtype == "int8":
                    topr.extend(topr_variants(args, kw, dtype, card, cscale,
                                              "random bids"))
                else:
                    topr.extend(topr_variants(args, kw, dtype, card, cscale,
                                              "random bids", rs=(40,),
                                              nqs=(KERNEL_Q,)))
                if dtype == "int8" and metric is Metric.L2:
                    timing = stage1_timing(args, kw, 40, card,
                                           "1M x 128 storage order, random "
                                           "bids")
    # the filter mask (10% of rows allowed) on the main path's int8 copy
    bl, scale = copies["int8"]
    bids = torch.from_numpy(rng.integers(0, B, size=(KERNEL_Q, 8))).to(dev)
    allowed = torch.from_numpy(rng.random((B, BLOCK)) < FILTER_SHARE).to(dev)
    kw = dict(q8=q8, q_scale=q_scl, score_scale=scale, allowed=allowed)
    results.append(expand_variant(
        (bl, blocks_sq, block_ids, q, q_sq, bids, Metric.L2), kw, "int8",
        Metric.L2, card, cscale,
        shape=dict(Q=KERNEL_Q, p=8, S=BLOCK, d=DIM, B=B)))
    for metric in (Metric.L2, Metric.IP):
        topr.extend(topr_variants(
            (bl, blocks_sq, block_ids, q, q_sq, bids, metric), kw, "int8",
            card, cscale, "random bids"))
    del rows, blocks, copies
    torch.cuda.empty_cache()
    return results, topr, timing


def expand_variant(args, kw, dtype, metric, card, cscale, shape) -> dict:
    """expand_score against its plain version on the same card tensors:
    the same +inf pattern (dead or disallowed rows), rel err under RTOL,
    and both times."""
    got = X.expand_score(*args, **kw)
    want = X.expand_score_reference(*args, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got)), "inf pattern"
    if "allowed" in kw:
        dead = (args[2] < 0) | ~kw["allowed"]
        assert torch.equal(~fin, dead[args[5]]), "masked rows must score inf"
    err = (got - want).abs()[fin]
    rel = (err / (cscale + want.abs()[fin])).max().item()
    rec = {
        "dtype": dtype, "metric": metric.value, **shape,
        "masked": "allowed" in kw,
        "max_abs_err": err.max().item(), "rel_err": rel,
        "rtol": RTOL[dtype],
        "ms": cuda_ms(lambda: X.expand_score(*args, **kw), 20),
        "plain_ms": cuda_ms(lambda: X.expand_score_reference(*args, **kw),
                            5, 1),
    }
    bl, bids = args[0], args[5]
    Q, p = bids.shape
    S, dp, es = bl.shape[1], bl.shape[2], bl.element_size()
    rec["kernel_GBps"] = Q * p * S * dp * es / rec["ms"] / 1e6
    rec["bound_ms"], rec["bound_by"] = expand_bound(
        bl.shape, bl.dtype, bids, scaled="score_scale" in kw,
        filtered="allowed" in kw, out_bytes=4 * Q * p * S)
    print(f"kernel {dtype} {metric.value} p={shape['p']} d={shape['d']}"
          f"{' masked' if rec['masked'] else ''}: {rec['ms']:.4f} ms "
          f"(plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"by {rec['bound_by']}, {rec['kernel_GBps']:.1f} GB/s "
          f"of block rows), max_abs_err {rec['max_abs_err']:.3g}, "
          f"rel {rel:.3g} [{card}]", flush=True)
    assert rel <= RTOL[dtype], rec
    return rec


def topr_check(args, kw, dtype: str, r: int, plain, cscale: float) -> dict:
    """expand_topr on each route the shape allows against
    expand_topr_reference (the keyed top-r of the plain scores ``plain``)
    on the same card tensors: int8 keys exactly equal; f32 and bf16 within
    RTOL of the cancellation scale at the returned positions and at the
    r-th score, and every plain position below the r-th score minus that
    bound returned."""
    wd, wpos = X.topr_of_scores(plain, r)
    Q = plain.shape[0]
    flat = plain.reshape(Q, -1)
    routes = topr_routes(args[0], args[5], r)
    rec = {"r": r, "Q": Q, "routes": list(routes),
           "route": chosen_route(args[0], args[5], r), "max_abs_err": 0.0}
    for route in routes:
        d, pos = X.expand_topr(*args, r, route=route, **kw)
        torch.cuda.synchronize()
        at = flat.gather(1, pos)
        fin = torch.isfinite(at)
        assert torch.equal(fin, torch.isfinite(d)), f"inf pattern, {route}"
        err = (d - at).abs()[fin]
        rec["max_abs_err"] = max(rec["max_abs_err"],
                                 err.max().item() if err.numel() else 0.0)
        if dtype == "int8":
            rec["exact_keys"] = torch.equal(T.score_keys(d, pos),
                                            T.score_keys(wd, wpos))
            assert rec["exact_keys"], (route, rec)
            continue
        rtol = RTOL[dtype]
        assert (err <= rtol * (cscale + at.abs()[fin])).all(), (route, rec)
        tol = rtol * (cscale + wd[:, -1].abs())
        kth = torch.isfinite(wd[:, -1])
        assert ((d[:, -1] - wd[:, -1]).abs()[kth] <= tol[kth]).all(), \
            (route, rec)
        must = flat < (wd[:, -1] - tol)[:, None]
        got = torch.zeros_like(must).scatter_(1, pos, True)
        assert (got | ~must).all(), (route, rec)
        rec["within_rtol"] = rtol
    return rec


def topr_variants(args, kw, dtype, card, cscale, what: str,
                  rs=(1, 40, 100, 128), nqs=(KERNEL_Q, RAGGED_Q)) -> list:
    """topr_check at each r and query count (the first nq queries)."""
    recs = []
    bl, blocks_sq, block_ids, q, q_sq, bids, metric = args
    for nq in nqs:
        a = (bl, blocks_sq, block_ids, q[:nq], q_sq[:nq], bids[:nq], metric)
        k = {n: (v[:nq] if n in ("q8", "q_scale") else v)
             for n, v in kw.items()}
        plain = X.expand_score_reference(*a, **k)
        for r in rs:
            rec = topr_check(a, k, dtype, r, plain, cscale)
            rec.update(dtype=dtype, metric=metric.value, of=what,
                       masked="allowed" in kw, d=q.shape[1])
            recs.append(rec)
        del plain
    held = "keys exactly equal" if dtype == "int8" else "within RTOL"
    routes = sorted({(rec["r"], "+".join(rec["routes"]), rec["route"])
                     for rec in recs})
    print(f"expand_topr {dtype} {args[-1].value} {what}"
          f"{' masked' if 'allowed' in kw else ''}: r {list(rs)} x Q "
          f"{list(nqs)} {held} to the plain version on routes (r, held, "
          f"chosen) {routes} [{card}]", flush=True)
    return recs


def device_ms(fn, reps: int = 10) -> float:
    """Device milliseconds of one call: the median over ``reps`` calls of
    the span between CUDA events recorded around the call, each behind a
    spin kernel of about 0.5 ms, so the call's launches are all queued
    before the first event runs and host gaps do not count."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end))
    return float(np.median(spans))


def stage1_timing(args, kw, r: int, card: str, what: str) -> dict:
    """Both entries and the earlier design's composite (all scores, then
    torch.topk over [Q, p*S]) on one set of bids, in one call: ms from
    CUDA events over back-to-back calls (cuda_ms, as every kernel's ms),
    the device span of one call beside them (device_ms, which leaves out
    the host's gaps), bounds, the plain version's ms, distinct blocks and
    reuse. The fused entry's routes are timed in turns (grouped, ring,
    ring, grouped; the mean of each route's two) where both apply;
    ``fused_ms`` is the route topr_route picks."""
    bl, bids = args[0], args[5]
    Q, p = bids.shape
    S = bl.shape[1]
    distinct = torch.unique(bids).numel()
    routes = topr_routes(bl, bids, r)
    chosen = chosen_route(bl, bids, r)

    def composite():
        return torch.topk(X.expand_score(*args, **kw).reshape(Q, -1), r,
                          dim=1, largest=False)

    def fused():
        return X.expand_topr(*args, r, **kw)

    def every():
        return X.expand_score(*args, **kw)

    turns = {route: [] for route in routes}
    for route in routes + routes[::-1]:
        turns[route].append(cuda_ms(
            lambda: X.expand_topr(*args, r, route=route, **kw), 20))
    route_ms = {route: float(np.mean(v)) for route, v in turns.items()}
    rec = {"of": what, "Q": Q, "p": p, "S": S, "d": bl.shape[2], "r": r,
           "dtype": str(bl.dtype).removeprefix("torch."),
           "distinct_blocks": distinct, "reuse": Q * p / distinct,
           "route": chosen, "grouped_ms": route_ms.get("grouped"),
           "ring_ms": route_ms["ring"], "route_turns_ms": turns,
           "chosen_is_faster": route_ms[chosen] == min(route_ms.values()),
           "all_ms": cuda_ms(every, 20), "fused_ms": route_ms[chosen],
           "composite_ms": cuda_ms(composite, 20),
           "all_device_ms": device_ms(every),
           "fused_device_ms": device_ms(fused),
           "composite_device_ms": device_ms(composite),
           "plain_all_ms": cuda_ms(
               lambda: X.expand_score_reference(*args, **kw), 3, 1),
           "plain_fused_ms": cuda_ms(
               lambda: X.expand_topr_reference(*args, r, **kw), 3, 1)}
    rec["all_bound_ms"], rec["all_bound_by"] = expand_bound(
        bl.shape, bl.dtype, bids, scaled="score_scale" in kw,
        filtered="allowed" in kw, out_bytes=4 * Q * p * S)
    rec["fused_bound_ms"], rec["fused_bound_by"] = expand_bound(
        bl.shape, bl.dtype, bids, scaled="score_scale" in kw,
        filtered="allowed" in kw, out_bytes=8 * Q * r)
    grouped = ("n/a (keys over the merge)" if rec["grouped_ms"] is None
               else f"{rec['grouped_ms']:.4f}")
    print(f"stage 1 {what}: {rec['dtype']} Q={Q} p={p} d={rec['d']} r={r}, "
          f"{distinct} distinct blocks (reuse {rec['reuse']:.2f}); "
          f"CUDA-event ms: all scores {rec['all_ms']:.4f} (bound "
          f"{rec['all_bound_ms']:.4f}), "
          f"fused top-r {rec['fused_ms']:.4f} on the {chosen} route (bound "
          f"{rec['fused_bound_ms']:.4f}; in turns grouped {grouped}, ring "
          f"{rec['ring_ms']:.4f}, chosen faster: "
          f"{rec['chosen_is_faster']}), composite {rec['composite_ms']:.4f};"
          f" device span ms {rec['all_device_ms']:.4f} / "
          f"{rec['fused_device_ms']:.4f} / {rec['composite_device_ms']:.4f}; "
          f"plain {rec['plain_all_ms']:.2f} / {rec['plain_fused_ms']:.2f} ms"
          f" [{card}]", flush=True)
    return rec


#: host API calls that launch a kernel: a trace holding fewer kernels
#: than these calls lost some (late in this script's run the trace drops
#: kernels, among them the ctypes library's and cuBLAS's; config E's phase
#: alone, ``python3 chip_smoke.py config_e``, profiles its chunk whole)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


def device_breakdown(fn, card: str, what: str, top: int = 8,
                     classes: dict | None = None) -> dict:
    """torch.profiler over one call of ``fn``: the top CUDA ops by device
    time, the count of device ops, and device-busy time over the host
    wall time of a call (the median of five unprofiled calls after two
    warm-ups, each ending in a synchronize). ``classes`` (name -> key
    substrings) adds the device ms and busy share of each class, the first
    class whose substring is in an op's full name taking it, the rest
    "other". ``complete`` says whether the trace holds a kernel for each
    kernel launch call the host made (LAUNCH_CALLS)."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(7):  # the host wall time without the profiler's cost
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls[2:]))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, launches = [], 0
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA":
            launches += ev.count * ev.key.startswith(LAUNCH_CALLS)
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        ops.append((us, ev.count, ev.key))
    ops.sort(reverse=True)
    busy = sum(o[0] for o in ops) / 1e3
    kernels = sum(o[1] for o in ops
                  if not o[2].startswith(("Memcpy", "Memset")))
    rec = {"of": what, "host_wall_ms": wall * 1e3, "device_busy_ms": busy,
           "busy_share": busy / (wall * 1e3),
           "kernels": sum(o[1] for o in ops), "device_kernels": kernels,
           "kernel_launch_calls": launches, "complete": kernels >= launches,
           "top": [{"op": k[:80], "ms": us / 1e3, "count": c}
                   for us, c, k in ops[:top]]}
    if classes:
        by = {name: {"ms": 0.0, "count": 0} for name in (*classes, "other")}
        for us, c, k in ops:
            name = next((n for n, subs in classes.items()
                         if any(x in k for x in subs)), "other")
            by[name]["ms"] += us / 1e3
            by[name]["count"] += c
        for v in by.values():
            v["share"] = v["ms"] / busy if busy else 0.0
        rec["classes"] = by
    print(f"device breakdown, {what}: host wall {rec['host_wall_ms']:.3f} "
          f"ms, device busy {busy:.3f} ms ({rec['busy_share']:.1%}), "
          f"{rec['kernels']} device ops ({rec['device_kernels']} kernels "
          f"for {rec['kernel_launch_calls']} kernel launch calls on the "
          f"host{'' if rec['complete'] else ': the trace lost kernels'}); "
          f"top {json.dumps(rec['top'])}"
          + (f"; by class {json.dumps(rec['classes'])}" if classes else "")
          + f" [{card}]", flush=True)
    return rec


def expand_launches() -> dict:
    """Launches of each expand entry since the counters were reset, and of
    each route of the fused one."""
    return {"expand_score": X.LAUNCHES - X.TOPR_LAUNCHES,
            "expand_topr": X.TOPR_LAUNCHES,
            **{f"expand_topr_{k}": v
               for k, v in X.TOPR_ROUTE_LAUNCHES.items()}}


@contextmanager
def counted_routes():
    """Resets ``ROUTE_LAUNCHES`` and counts ``route_topk``'s calls that have
    queries and groups by the path its dispatch owes them (``R.fused``):
    the counters must then equal these counts (:func:`route_launches`)."""
    calls = {"fused": 0, "gemm_topk": 0, "plain": 0}
    inner = R.route_topk

    def counting(centroids, c_sq, q, q_sq, p, *args, **kw):
        if q.shape[0] > 0 and (centroids.dim() == 2 or centroids.shape[0]):
            calls["fused" if R.fused(centroids, p) else "gemm_topk"] += 1
        return inner(centroids, c_sq, q, q_sq, p, *args, **kw)

    R.ROUTE_LAUNCHES.update(fused=0, gemm_topk=0, plain=0)
    R.route_topk = counting
    try:
        yield calls
    finally:
        R.route_topk = inner


def route_launches(calls: dict, kernel: bool = True) -> dict:
    """The route's launches by path under :func:`counted_routes`: one kernel
    launch a fused call, one chain a wider call, nothing on the CPU; with
    ``kernel``, some call must have taken the kernel."""
    out = dict(R.ROUTE_LAUNCHES)
    assert out == calls and (out["fused"] > 0 or not kernel), (out, calls)
    return out


def reset_expand_counts() -> None:
    """Sets every expand launch counter to 0."""
    X.LAUNCHES = X.TOPR_LAUNCHES = 0
    for k in X.TOPR_ROUTE_LAUNCHES:
        X.TOPR_ROUTE_LAUNCHES[k] = 0


def topr_routes(bl, bids, r: int) -> tuple:
    """The fused entry's routes at this shape (grouped first)."""
    return X.topr_routes(bids.shape[1], r, bl.shape[1])


def chosen_route(bl, bids, r: int) -> str:
    return X.topr_route(bids.shape[0], bids.shape[1], r, bl.shape[0],
                        bl.shape[1], bl.shape[2] * bl.element_size())


def routed_args(idx, q, probes: int):
    """Stage 1's arguments as the exact-routed search makes them: the bids
    the index's own route gives these queries at ``probes``, on its
    scoring copy."""
    q = idx._queries(q)
    q_sq = (q * q).sum(1)
    metric = idx.cfg.metric
    bids = R.route_topk(idx.centroids, idx.centroids_sq, q, q_sq, probes,
                        metric)[:, 0]
    qp = _pad_cols(q, idx.blocks_score.shape[2])
    kw = {}
    if idx.score_scale is not None:
        q8, q_scl = _quantize_rows(qp)
        kw = dict(q8=q8, q_scale=q_scl, score_scale=idx.score_scale)
    return (idx.blocks_score, idx.blocks_sq, idx.block_ids, qp, q_sq, bids,
            metric), kw


def routed_timing(idx, q, probes: int, r: int, card: str, what: str):
    """stage1_timing at the index's own routed bids (routed_args)."""
    args, kw = routed_args(idx, q, probes)
    return stage1_timing(args, kw, r, card, what)


def topk_order_scan(flat, q, k: int):
    """The oracle as it was before its ties followed lax.top_k: the same
    tiled f32 scan with torch.topk per tile and per merge, every query at
    once. Kept only to time the repair against it."""
    q_sq = (q * q).sum(1)
    best_d = torch.full((q.shape[0], 0), torch.inf, device=q.device)
    best_i = torch.full((q.shape[0], 0), -1, dtype=torch.int64,
                        device=q.device)
    for off in range(0, flat.n, flat._tile):
        xb = flat.vectors[off:off + flat._tile]
        sc = torch.clamp_min(q_sq[:, None] + flat.vectors_sq[None, off:off
                             + xb.shape[0]] - 2.0 * (q @ xb.T), 0.0)
        tv, ti = torch.topk(sc, k, largest=False)
        best_d, sel = torch.topk(torch.cat([best_d, tv], 1),
                                 min(k, best_d.shape[1] + k), largest=False)
        best_i = torch.gather(torch.cat([best_i, ti + off], 1), 1, sel)
    return best_d, best_i


def oracle_timing(oracle, qdev, card: str):
    """Ground truth by FlatIndex.search(exact=True) (keyed top-k, ties to
    the lower row, 1024-query slices) timed beside the torch.topk-order
    scan it replaced, in turns (old, new, new, old; host clock around
    synchronized calls). Returns (ids, numbers); the two agree on every
    distance to f32 rounding."""
    def new():
        out = oracle.search_device(qdev, k=10, exact=True)
        torch.cuda.synchronize()
        return out

    def old():
        out = topk_order_scan(oracle, qdev, 10)
        torch.cuda.synchronize()
        return out

    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        fn = new if name == "new" else old
        t0 = time.perf_counter()
        res = fn()
        times[name].append((time.perf_counter() - t0) * 1e3)
        if name == "new":
            gt_d, gt = res
        else:
            old_d = res[0]
    # GEMMs of 1024 and 4096 rows may sum in other orders: the f32 bound
    tol = oracle.dim * float(np.finfo(np.float32).eps) * (
        oracle.vectors_sq.max() + (qdev * qdev).sum(1).max()).item()
    assert ((gt_d.double() ** 2 - old_d.double()).abs() <= tol).all(), \
        "the two scans disagree"
    rec = {"Q": qdev.shape[0], "N": oracle.n, "d": oracle.dim,
           "ms": min(times["new"]), "ms_all": times["new"],
           "torch_topk_order_ms": min(times["old"]),
           "torch_topk_order_ms_all": times["old"]}
    print(f"oracle FlatIndex.search(exact=True) at {oracle.n} x "
          f"{oracle.dim}, {rec['Q']} queries: {rec['ms']:.1f} ms (keyed "
          f"top-k, lax.top_k's ties) against {rec['torch_topk_order_ms']:.1f}"
          f" ms for the torch.topk-order scan it replaced; calls "
          f"{[round(t, 1) for t in times['new']]} / "
          f"{[round(t, 1) for t in times['old']]} [{card}]", flush=True)
    return gt.cpu().numpy(), rec


#: op classes of a flat scan's device time (``device_breakdown``): the
#: GEMMs (cuBLAS f32 and int8), the keyed top-k (radix select and sorts),
#: copies (dtype casts and any layout copy); the rest ("other") is the
#: score epilogue and the select's key arithmetic
SCAN_CLASSES = {"gemm": ("gemm", "Gemm", "xmma", "cutlass", "cublas"),
                "topk": ("topk", "TopK", "radix", "Radix", "sort", "Sort",
                         "Kth", "bitonic"),
                "copy": ("copy",)}


def int8_scan_timing(flat, qdev, gt: np.ndarray, card: str,
                     what: str) -> dict:
    """``FlatIndex(scan_dtype="int8")`` over ``flat``'s own device table
    (the f32 table shared, its int8 copy and scales added) beside the
    default scan of the same table: each index's build seconds; the two
    ``search_device`` calls over every query in turns (default, int8, int8,
    default; host clock around synchronized calls), QPS from the mean of
    each pair; recall@10 against ``gt`` (int8 must reach 0.99, the
    reference test's floor); device memory resident and the peak above it
    during a call; a profiled 1024-query call of each, by op class; one
    tile of each scan against those queries in its parts (GEMM, score
    epilogue, the keyed select of 40 candidates; CUDA events), each part's
    share of the profiled call at that call's tile count; and the bytes
    ``torch._int_mm`` allocates beyond its product (a hidden copy of the
    transposed tile would add the tile's bytes)."""
    out = {"of": what, "Q": qdev.shape[0], "N": flat.n, "d": flat.dim}
    scans = {}
    for name, kw in (("default", {}), ("int8", {"scan_dtype": "int8"})):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        scans[name] = FlatIndex(flat.vectors, flat.metric, **kw)
        torch.cuda.synchronize()
        out[f"{name}_build_s"] = time.perf_counter() - t0
        out[f"{name}_index_GB"] = (torch.cuda.memory_allocated() - before
                                   + flat.vectors.numel() * 4) / 1e9
    for f in scans.values():  # warm-up: cuBLAS(Lt) and allocator state
        f.search_device(qdev[:CHUNK], k=10)
    ms, ids = {"default": [], "int8": []}, {}
    for name in ("default", "int8", "int8", "default"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        _, i = scans[name].search_device(qdev, k=10)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_search_peak_GB"] = (torch.cuda.max_memory_allocated()
                                         - resident) / 1e9
        ids[name] = i.cpu().numpy()
    for name in ms:
        out[f"{name}_ms_all"] = ms[name]
        out[f"{name}_qps"] = qdev.shape[0] / (float(np.mean(ms[name])) / 1e3)
        out[f"{name}_recall"] = recall_at_k(ids[name], gt, 10)
    out["int8_over_default_qps"] = out["int8_qps"] / out["default_qps"]
    print(f"flat scans at {what}, {qdev.shape[0]} queries, k=10: default "
          f"{out['default_qps']:.1f} QPS (calls {ms['default']} ms, recall@10 "
          f"{out['default_recall']:.4f}, build {out['default_build_s']:.3f} "
          f"s, index {out['default_index_GB']:.3f} GB, search peak above "
          f"it {out['default_search_peak_GB']:.3f} GB); int8 "
          f"{out['int8_qps']:.1f} QPS (calls {ms['int8']} ms, recall@10 "
          f"{out['int8_recall']:.4f}, build {out['int8_build_s']:.3f} s, "
          f"index {out['int8_index_GB']:.3f} GB, search peak above it "
          f"{out['int8_search_peak_GB']:.3f} GB); int8 / default QPS "
          f"{out['int8_over_default_qps']:.3f} [{card}]", flush=True)
    assert out["int8_recall"] >= 0.99, out
    q1 = qdev[:CHUNK]
    out["breakdown"] = {name: device_breakdown(
        lambda f=f: f.search_device(q1, k=10), card,
        f"{name} flat scan at {what}, one {CHUNK}-query search_device call",
        top=12, classes=SCAN_CLASSES) for name, f in scans.items()}
    # one tile of each scan in its parts, at the scan's shapes
    i8 = scans["int8"]
    tile = min(i8._tile, flat.n)
    tile -= tile % 8
    xb8, scl = i8._xs8[:tile], i8._scales[:tile]
    qf = q1.contiguous()
    q8, q_scl = FL._quantize_rows(F.pad(qf, (0, xb8.shape[1] - flat.dim)))
    torch._int_mm(q8, xb8.T)  # warm-up: cuBLASLt's workspace is kept
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    dots_i = torch._int_mm(q8, xb8.T)
    torch.cuda.synchronize()
    out["int_mm_extra_bytes"] = (torch.cuda.max_memory_allocated() - before
                                 - dots_i.numel() * 4)
    assert out["int_mm_extra_bytes"] < xb8.numel(), \
        f"torch._int_mm copied the transposed tile: {out}"
    xb32, q_sq, x_sq = flat.vectors[:tile], (qf * qf).sum(1), \
        flat.vectors_sq[:tile]
    dots_f = qf @ xb32.T

    def tail(dots):  # the L2 or IP step both scans share
        if flat.metric is Metric.L2:
            return torch.clamp_min(q_sq[:, None] + x_sq[None, :] - 2.0 * dots,
                                   0.0)
        return -dots

    sc = tail(dots_f)
    cand = 40  # 4k candidates a tile at k = 10
    parts = {"default": {"gemm": lambda: qf @ xb32.T,
                         "epilogue": lambda: tail(dots_f)},
             "int8": {"gemm": lambda: torch._int_mm(q8, xb8.T),
                      "epilogue": lambda: tail(
                          dots_i.float() * (q_scl[:, None] * scl[None, :]))}}
    select_ms = cuda_ms(lambda: T.topk_smallest_by_index(sc, cand), 5)
    tiles = -(-flat.n // i8._tile)
    out["tile_parts"] = {"rows": tile, "tiles_per_call": tiles}
    for name, fns in parts.items():
        rec = {part: cuda_ms(fn, 10) for part, fn in fns.items()}
        rec["keyed_select"] = select_ms
        busy = out["breakdown"][name]["device_busy_ms"]
        rec["share_of_call"] = {part: tiles * ms / busy
                                for part, ms in list(rec.items())}
        out["tile_parts"][name] = rec
    print(f"flat scan parts of one {tile}-row tile against {CHUNK} queries "
          f"(CUDA events; share of the profiled call's device time at "
          f"{tiles} tiles a call): {json.dumps(out['tile_parts'])}; bytes "
          f"torch._int_mm allocated beyond its product "
          f"{out['int_mm_extra_bytes']} [{card}]", flush=True)
    return out


def main_path(base: np.ndarray, queries: np.ndarray, card: str,
              dev: torch.device):
    """Build twice, grade, pick probes, measure QPS. Returns the numbers
    and the device-input index."""
    cfg = HnswConfig(dim=DIM, m=16, ef_construction=64, seed=0)
    out = {}
    idx_host = BlockHnswIndex(cfg, block_size=BLOCK, device=dev).build(base)
    xdev = torch.from_numpy(base).to(dev)
    torch.cuda.synchronize()
    idx = BlockHnswIndex(cfg, block_size=BLOCK, device=dev).build(xdev)
    for name, ix in (("host", idx_host), ("device", idx)):
        st = ix.build_stats
        print(f"build from {name} input: {st['total_s']} s, "
              f"{st['vectors_per_sec']} vec/s, n_blocks {ix.n_blocks}, "
              f"stages {json.dumps(st)} [{card}]", flush=True)
        out[f"build_{name}_s"] = st["total_s"]
        out[f"build_{name}_vps"] = st["vectors_per_sec"]
    oracle = FlatIndex(xdev, Metric.L2)
    qdev = torch.from_numpy(queries).to(dev)
    gt, out["oracle"] = oracle_timing(oracle, qdev, card)
    out["flat_int8"] = int8_scan_timing(oracle, qdev, gt, card,
                                        f"{N} x {DIM} L2")
    launches_before_search = X.LAUNCHES
    chosen = None
    for p in (p for p in PROBE_GRID if p <= idx.n_blocks):
        d, ids = idx.search(qdev, k=10, probes=p)
        r = recall_at_k(ids, gt, 10)
        print(f"probes {p}: recall@10 {r:.4f} [{card}]", flush=True)
        if r >= TARGET_RECALL:
            chosen, out["recall"] = p, r
            break
    assert chosen is not None, "no probe count reached the target recall"
    assert X.LAUNCHES > launches_before_search, "search did not launch"
    out["probes"] = chosen
    # results are well-formed, and distances are exact L2 of the ids
    assert d.shape == (NQ, 10) and np.isfinite(d).all()
    assert ((ids >= 0) & (ids < N)).all()
    exact = np.sqrt(((queries[:, None, :] - base[ids]) ** 2).sum(-1))
    scale = float((base ** 2).sum(1).max() + (queries ** 2).sum(1).max())
    assert np.abs(d.astype(np.float64) ** 2 - exact.astype(np.float64) ** 2
                  ).max() <= DIM * np.finfo(np.float32).eps * scale
    _, ids_h = idx_host.search(qdev, k=10, probes=chosen)
    out["recall_host_build"] = recall_at_k(ids_h, gt, 10)
    print(f"chosen probes {chosen}: recall@10 {out['recall']:.4f} "
          f"(host-input build {out['recall_host_build']:.4f}) [{card}]",
          flush=True)

    def serve_pass():
        for s in range(0, NQ, CHUNK):
            _, last = idx.search_device(qdev[s:s + CHUNK], k=10,
                                        probes=chosen)
        torch.cuda.synchronize()
        return last.cpu()  # host fetch of the last batch's ids

    serve_pass()  # warm-up
    # serving is host-launch-bound, so windows spread: report them all
    windows = []
    for _ in range(9):
        t0 = time.perf_counter()
        serve_pass()
        windows.append(NQ / (time.perf_counter() - t0))
    out["qps"] = float(np.median(windows))
    out["qps_windows"] = windows
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"QPS {out['qps']:.1f} (median of {len(windows)} windows of "
          f"{NQ} queries, min {min(windows):.1f}, max {max(windows):.1f}) "
          f"at probes {chosen}, {CHUNK}-query chunks, peak device memory "
          f"{out['peak_mem_GB']:.2f} GB [{card}]", flush=True)
    return out, idx, gt


def timed_build(name: str):
    t0 = time.perf_counter()
    path, log = _nvcc.build_library(name)
    return path, log, time.perf_counter() - t0


def ptxas_summary(log: str) -> dict:
    """Registers, spill bytes and shared memory of each kernel entry in an
    nvcc -Xptxas=-v log, by mangled name."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            out[name] = {}
        elif name and "spill stores" in line:
            out[name]["spill_bytes"] = [int(w) for w in line.replace(
                ",", " ").split() if w.isdigit()][1:3]
        elif name and "Used" in line and "registers" in line:
            words = line.replace(",", " ").split()
            out[name]["registers"] = int(words[words.index("Used") + 1])
            if "smem" in words:
                out[name]["smem_bytes"] = int(words[words.index("smem") - 2])
    return out


def build_phase(names=(X.NAME, H.NAME, R.NAME, BM.NAME)) -> dict:
    """The kernel libraries, compiled by one nvcc process each at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        done = {n: pool.submit(timed_build, n) for n in names}
        built = {n: f.result() for n, f in done.items()}
    for name, (path, log, secs) in built.items():
        print(f"kernel library {name}: {path} built in {secs:.2f} s",
              flush=True)
        if log:
            print(log.strip(), flush=True)
            print(f"{name} -Xptxas=-v per kernel: "
                  f"{json.dumps(ptxas_summary(log))}", flush=True)
    wall = time.perf_counter() - t0
    print(f"kernel libraries built in {wall:.2f} s", flush=True)
    return {n: b[2] for n, b in built.items()}


#: the route's shapes: (what, Q, groups, centroids a group, d, metric, p,
#: live centroids or None for all): the block cells' (p 8), the graph
#: cell's dense route (p 1 over ~62,400 upper vectors of a table padded to
#: a multiple of 256), the CLI eval sweep's 512-query chunks of the 1M x
#: 128 index at 34 and 105 probes, and the bench grid's widest p
ROUTE_SHAPES = (("sift1m.bulk", 4096, 1, 4102, 128, Metric.L2, 8, None),
                ("deep10m.bulk", 4096, 8, 5127, 96, Metric.IP, 8, None),
                ("sift1m.interactive", 32, 1, 4102, 128, Metric.L2, 8,
                 None),
                ("sift1m-graph.bulk", 4096, 1, 62464, 128, Metric.L2, 1,
                 62400),
                ("cli.eval.p34", 512, 1, 4102, 128, Metric.L2, 34, None),
                ("cli.eval.p105", 512, 1, 4102, 128, Metric.L2, 105, None),
                ("bench.grid.p128", 4096, 1, 4102, 128, Metric.L2, 128,
                 None))


def route_operands(dev, seed: int, Q: int, L: int, b: int, d: int,
                   metric: Metric, ints: bool, live: int | None = None):
    """(centroids [L, b, d], c_sq, q, q_sq) on the card: integers in [-4, 4]
    (every f32 dot exact, ties everywhere) or normal rows (unit rows for
    IP, as DEEP's); centroids from ``live`` on are zero rows (the graph
    table's sentinel)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if ints:
        c = torch.randint(-4, 5, (L, b, d), generator=g, device=dev).float()
        q = torch.randint(-4, 5, (Q, d), generator=g, device=dev).float()
    else:
        c = torch.randn((L, b, d), generator=g, device=dev)
        q = torch.randn((Q, d), generator=g, device=dev)
        if metric is Metric.IP:
            c, q = F.normalize(c, dim=-1), F.normalize(q, dim=-1)
    if live is not None:
        c[:, live:] = 0.0
    return c, (c * c).sum(-1), q, (q * q).sum(-1)


def route_f64_gap(ids, c, q, metric: Metric,
                  live=None) -> tuple[float, float, float]:
    """(widest margin by which a chosen centroid's float64 score is worse
    than an unchosen live one's, widest inversion of the chosen order, the
    f32 tolerance d * eps * (max |q|^2 + max |c|^2))."""
    c64, q64 = c.double(), q.double()
    dots = torch.einsum("qd,lbd->qlb", q64, c64)
    sc = ((q64 * q64).sum(1)[:, None, None] + (c64 * c64).sum(-1)[None]
          - 2 * dots) if metric is Metric.L2 else -dots
    if live is not None:
        sc[..., live:] = torch.inf
    chosen = torch.gather(sc, 2, ids)
    others = sc.scatter(2, ids, torch.inf).amin(-1)
    worst = (chosen.amax(-1) - others).clamp_min(0).max().item()
    order = ((chosen[..., :-1] - chosen[..., 1:]).clamp_min(0).max().item()
             if chosen.shape[-1] > 1 else 0.0)
    tol = c.shape[-1] * float(np.finfo(np.float32).eps) * (
        (q * q).sum(1).max().item() + (c * c).sum(-1).max().item())
    return worst, order, tol


def route_phase(card: str, dev: torch.device) -> list:
    """The route kernel (``csrc/route_topk.cu``, ``ops/route.py``) at
    ``ROUTE_SHAPES``: on integer rows its ids equal the plain version's
    (ties to the lower index); on normal rows every chosen centroid is
    within the f32 tolerance of float64 and few rows differ from the plain
    version's (a cuBLAS GEMM, another summation order). Timed by CUDA
    events beside its bound (``bound(bytes, 2 Q L b d, "float32")``), the
    plain version and the library chain (the f32 GEMM, +inf padding, then
    ``topk_smallest_fast``: a radix ``torch.topk`` over these rows), at
    every shape, whichever ``route_topk`` takes there (``path``); the
    route's counters must equal the calls made on each path. A shape with
    a live count (the graph route's table: its rows past the count are the
    sentinel's zero row) passes it to every path."""
    out = []
    for what, Q, L, b, d, metric, p, n_live in ROUTE_SHAPES:
        live = (None if n_live is None else
                torch.full((L,), n_live, dtype=torch.int32, device=dev))
        kw = dict(live=live)
        exact = route_operands(dev, 1, Q, L, b, d, metric, ints=True,
                               live=n_live)
        want = R.route_topk_reference(*exact, p, metric, **kw)
        got = R._launch(*exact, p, metric, live, False)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"route ids differ at {what}"
        ops = route_operands(dev, 2, Q, L, b, d, metric, ints=False,
                             live=n_live)
        got = R._launch(*ops, p, metric, live, False)
        want = R.route_topk_reference(*ops, p, metric, **kw)
        worst, order, tol = route_f64_gap(got, ops[0], ops[2], metric,
                                          n_live)
        assert worst <= tol and order <= tol, (what, worst, order, tol)
        differ = (got != want).any(-1).float().mean().item()
        assert differ < 0.01, (what, differ)
        path = "fused" if R.fused(ops[0], p) else "gemm_topk"
        with counted_routes() as calls:
            ms, smi = sampled_ms(lambda: R.route_topk(*ops, p, metric,
                                                      **kw))
        launches = route_launches(calls, kernel=path == "fused")
        kernel = lambda: R._launch(*ops, p, metric, live, False)  # noqa
        kernel_ms, dev_ms = cuda_ms(kernel, 20), device_ms(kernel)
        plain_ms = cuda_ms(lambda: R.route_topk_reference(*ops, p, metric,
                                                          **kw), 5)
        chain = lambda: R.route_topk_reference(  # noqa: E731
            *ops, p, metric, select=T.topk_smallest_fast, **kw)
        lib_ms, lib_dev_ms = cuda_ms(chain, 20), device_ms(chain)
        nbytes = 4 * (Q * d + Q + L * b * d + L * b) + 8 * Q * L * p
        flops = 2 * Q * L * (b if n_live is None else n_live) * d
        bound_ms, by = bound(nbytes, flops, "float32")
        row = {"of": what, "Q": Q, "groups": L, "centroids": b,
               "live": n_live, "d": d, "metric": metric.value, "p": p,
               "path": path,
               "split": R.split_count(Q, L, b, p,
                                      R._slots(dev.index or 0, p)),
               "ms": kernel_ms, "device_ms": dev_ms, "route_ms": ms,
               "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_device_ms": lib_dev_ms,
               "kernel_over_library": kernel_ms / lib_ms,
               "bound_ms": bound_ms, "bound_by": by,
               "roofline_pct": 100.0 * bound_ms / kernel_ms,
               "tflops": flops / kernel_ms / 1e9, "launches": launches,
               "f64_worst": worst, "f64_order": order, "f64_tol": tol,
               "rows_differing_from_plain": differ, "nvidia_smi": smi,
               "card": card}
        print(f"route at {what}: {json.dumps(row)}", flush=True)
        out.append(row)
        del exact, ops, want, got
        torch.cuda.empty_cache()
    return out


def sq_bound(*arrays) -> float:
    """d * eps_f32 * sum of max squared norms: the f32 summation bound of
    the |q|^2 + |x|^2 - 2 q.x form over d terms."""
    return arrays[0].shape[1] * float(np.finfo(np.float32).eps) * sum(
        float((a.astype(np.float64) ** 2).sum(1).max()) for a in arrays)


def lifecycle_phase(idx, base: np.ndarray, queries: np.ndarray, chosen: int,
                    card: str, dev: torch.device) -> dict:
    """Filter, add, delete, filtered iterative scan, compact and a
    save/load round trip on the 1M x 128 index."""
    out = {}
    qdev = torch.from_numpy(queries).to(dev)
    fmask = BN.filter_mask(N)
    allowed_ids = np.where(fmask)[0]
    fsub = FlatIndex(torch.from_numpy(base[allowed_ids]).to(dev), Metric.L2)
    fgt = allowed_ids[fsub.search(qdev, k=10, exact=True)[1]]
    del fsub
    t0 = time.perf_counter()
    _, fids = idx.search(qdev, k=10, probes=2 * chosen, filter_mask=fmask)
    out["filtered_s"] = time.perf_counter() - t0
    assert (fids >= 0).all() and fmask[fids].all(), "a filtered-out id"
    out["filtered_recall"] = recall_at_k(fids, fgt, 10)
    print(f"filter {FILTER_SHARE:.0%} (bench.py mask): recall@10 "
          f"{out['filtered_recall']:.4f} at probes {2 * chosen}, no "
          f"disallowed id [{card}]", flush=True)

    rng = np.random.default_rng(7)
    extra = (base[rng.integers(0, N, N_ADD)]
             + rng.normal(0.0, 0.5, size=(N_ADD, DIM))).astype(np.float32)
    t0 = time.perf_counter()
    new_ids = idx.add(extra)
    out["add_s"] = time.perf_counter() - t0
    assert (new_ids == np.arange(N, N + N_ADD)).all()
    probe = extra[:256]
    d, ids = idx.search(probe, k=1, probes=chosen)
    assert (ids[:, 0] == new_ids[:256]).all(), "an added row is not found"
    out["added_self_dist_max"] = float(d[:, 0].max())
    assert (d[:, 0].astype(np.float64) ** 2 <= sq_bound(probe, probe)).all()

    victims = rng.choice(N + N_ADD, (N + N_ADD) // 100, replace=False)
    t0 = time.perf_counter()
    idx.delete(victims)
    out["delete_s"] = time.perf_counter() - t0
    for qs in (qdev, probe):
        _, ids = idx.search(qs, k=10, probes=chosen)
        assert not np.isin(ids, victims).any(), "a deleted id came back"
    _, ids = idx.search(qdev, k=10, probes=2 * chosen, filter_mask=fmask)
    assert not np.isin(ids, victims).any() and fmask[ids[ids >= 0]].all()
    print(f"add {N_ADD} rows {out['add_s']:.3f} s (self distance max "
          f"{out['added_self_dist_max']:.3g}), delete {len(victims)} ids "
          f"{out['delete_s']:.3f} s: none comes back [{card}]", flush=True)

    passes = np.random.default_rng(FILTER_SEED + 1).random(N + N_ADD) \
        < FILTER_SHARE
    t0 = time.perf_counter()
    _, ids = idx.search_iterative(queries[:CHUNK], k=10,
                                  predicate=lambda i: passes[i])
    out["iterative_s"] = time.perf_counter() - t0
    got = ids[ids >= 0]
    assert passes[got].all() and not np.isin(got, victims).any()
    out["iterative_filled"] = float((ids >= 0).mean())
    print(f"search_iterative, 10% predicate, {CHUNK} queries: "
          f"{out['iterative_s']:.3f} s, {out['iterative_filled']:.4f} of "
          f"slots filled, every id passes [{card}]", flush=True)

    t0 = time.perf_counter()
    idx.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    assert idx.tail_n == 0 and idx.size == N + N_ADD - len(victims)
    # the added rows now live in blocks: all probes find each one exactly
    _, ids = idx.search(probe, k=1, probes=idx.n_blocks)
    alive = ~np.isin(new_ids[:256], victims)
    assert (ids[alive, 0] == new_ids[:256][alive]).all()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        idx.save(tmp)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx2 = BlockHnswIndex.load(tmp, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    d1, i1 = idx.search(qdev, k=10, probes=chosen)
    d2, i2 = idx2.search(qdev, k=10, probes=chosen)
    assert np.array_equal(i1, i2) and np.array_equal(d1, d2), "save/load"
    del idx2
    print(f"compact {out['compact_s']:.3f} s ({idx.n_blocks} blocks); "
          f"save {out['save_s']:.3f} s, load {out['load_s']:.3f} s: "
          f"identical ids and distances [{card}]", flush=True)
    return out



# ---------------------------------------------------------------------------
# the port's CLI, its bench headline, the planner and the profiler ranges
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
CLI_INDEX = "cli_block"  # the CLI's saved index, under the phase's tmp dir
# runs ``python -m tpu_hnsw_torch.cli ARGS`` in this process and then
# prints the kernel launch counters of the run on stderr
CLI_RUNNER = (
    "import json, runpy, sys\n"
    "from tpu_hnsw_torch.ops import expand as X\n"
    "sys.argv = ['tpu_hnsw_torch.cli', *sys.argv[1:]]\n"
    "try:\n"
    "    runpy.run_module('tpu_hnsw_torch.cli', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "finally:\n"
    "    print('LAUNCHES ' + json.dumps({\n"
    "        'expand_score': X.LAUNCHES - X.TOPR_LAUNCHES,\n"
    "        'expand_topr': X.TOPR_LAUNCHES,\n"
    "        **{'expand_topr_' + k: v\n"
    "           for k, v in X.TOPR_ROUTE_LAUNCHES.items()}}),\n"
    "          file=sys.stderr, flush=True)\n")


def run_cli(args: list, timeout: float) -> dict:
    """``python -m tpu_hnsw_torch.cli`` as a subprocess on the card: its
    stdout, stderr, seconds and expand launches. Fails on a non-zero
    exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CLI_RUNNER, *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"tpu_hnsw_torch.cli {' '.join(args)} exited "
                           f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-6000:]}")
    tag = [ln for ln in proc.stderr.splitlines() if ln.startswith("LAUNCHES ")]
    return {"stdout": proc.stdout, "stderr": proc.stderr, "s": secs,
            "launches": json.loads(tag[-1][len("LAUNCHES "):])}


def json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def data_files_phase(base: np.ndarray, queries: np.ndarray, tmp: str,
                     card: str) -> tuple[dict, dict]:
    """The rows and queries as .fvecs and a uint8 copy of the rows as
    .bvecs; each read back through the native parser and through numpy:
    equal arrays, GB/s of each (the best of two turns, native first)."""
    assert native.load() is not None, "the native IO library did not load"
    paths = {"base": os.path.join(tmp, "base.fvecs"),
             "queries": os.path.join(tmp, "queries.fvecs"),
             "base_u8": os.path.join(tmp, "base.bvecs")}
    u8 = np.clip(np.rint(base * 8.0 + 128.0), 0, 255).astype(np.uint8)
    t0 = time.perf_counter()
    DS.write_fvecs(paths["base"], base)
    DS.write_fvecs(paths["queries"], queries)
    DS.write_bvecs(paths["base_u8"], u8)
    out = {"write_s": time.perf_counter() - t0}
    for name, path, want, nat, nump in (
            ("fvecs", paths["base"], base, native.read_fvecs_native,
             DS.read_fvecs_numpy),
            ("bvecs", paths["base_u8"], u8, native.read_bvecs_native,
             DS.read_bvecs_numpy)):
        gb = os.path.getsize(path) / 1e9
        times = {"native": [], "numpy": []}
        for which in ("native", "numpy", "native", "numpy"):
            t0 = time.perf_counter()
            got = (nat if which == "native" else nump)(path)
            times[which].append(time.perf_counter() - t0)
            assert got is not None and np.array_equal(got, want), \
                f"{which} {name} reader disagrees with the rows written"
        rec = {"GB": gb, "native_s": min(times["native"]),
               "numpy_s": min(times["numpy"])}
        rec["native_GBps"] = gb / rec["native_s"]
        rec["numpy_GBps"] = gb / rec["numpy_s"]
        out[name] = rec
        print(f"{name} {gb:.3f} GB: native reader {rec['native_GBps']:.2f} "
              f"GB/s, numpy {rec['numpy_GBps']:.2f} GB/s, arrays equal "
              f"(page cache warm) [{card}]", flush=True)
    return out, paths


def cli_phase(base: np.ndarray, gt: np.ndarray, paths: dict, tmp: str,
              card: str) -> dict:
    """``tpu_hnsw_torch.cli`` build --type block, search and eval (with the
    oracle's ground truth as .ivecs), each a subprocess on the card."""
    out = {"launches": dict.fromkeys(expand_launches(), 0)}
    gt_path = os.path.join(tmp, "gt.ivecs")
    DS.write_ivecs(gt_path, gt.astype(np.int32))
    idx_dir = os.path.join(tmp, CLI_INDEX)
    r = run_cli(["build", "--type", "block", "--input", paths["base"],
                 "--out", idx_dir], timeout=600)
    out["build"] = json_lines(r["stdout"])[-1]
    out["build"]["process_s"] = r["s"]
    assert out["build"]["built"] == N
    print(f"cli build --type block: {out['build']['vectors_per_sec']} vec/s "
          f"({out['build']['seconds']} s in the process, {r['s']:.1f} s "
          f"with start-up, read and save) [{card}]", flush=True)
    r = run_cli(["search", "--index", idx_dir, "--queries", paths["queries"],
                 "--k", "10", "--ef", "40", "--print-rows", "5"], timeout=600)
    out["search"] = json_lines(r["stderr"])[-1]
    rows = [ln.split() for ln in r["stdout"].splitlines() if ":" in ln]
    assert len(rows) == 5 and all(len(row) == 10 for row in rows)
    ids = np.array([[int(t.split(":")[0]) for t in row] for row in rows])
    dist = np.array([[float(t.split(":")[1]) for t in row] for row in rows])
    qs = DS.read_fvecs(paths["queries"])[:5]
    exact = ((qs[:, None, :].astype(np.float64) - base[ids]) ** 2).sum(-1)
    # the f32 bound of the |q|^2 + |x|^2 - 2 q.x form (as main_path's),
    # plus the printed 4 decimals
    err = np.abs(dist.astype(np.float64) ** 2 - exact)
    assert (err <= sq_bound(base, qs) + 2 * dist * 5e-5 + 1e-8).all(), \
        f"cli search distances are not the ids' L2 (off by {err.max()})"
    for k, v in r["launches"].items():
        out["launches"][k] += v
    print(f"cli search ef 40: {out['search']['qps']} QPS over "
          f"{out['search']['queries']} queries (one host call), printed "
          f"distances exact [{card}]", flush=True)
    r = run_cli(["eval", "--index", idx_dir, "--queries", paths["queries"],
                 "--gt", gt_path, "--k", "10"], timeout=900)
    out["eval"] = json_lines(r["stdout"])
    for k, v in r["launches"].items():
        out["launches"][k] += v
    for row in out["eval"]:
        print(f"cli eval: ef_search {row['ef_search']} recall@10 "
              f"{row['recall']:.4f} QPS {row['qps']:.1f} [{card}]",
              flush=True)
    best = max(row["recall"] for row in out["eval"])
    assert best >= TARGET_RECALL, f"cli eval reached recall {best}"
    assert out["launches"]["expand_topr"] > 0, \
        "the CLI's search and eval never launched expand_topr"
    return out


def bench_phase(card: str) -> dict:
    """``tpu_hnsw_torch.cli bench`` at its default 1M x 128: its JSON
    line, with the root bench.py's keys and the recall target met."""
    r = run_cli(["bench"], timeout=1000)
    rec = json_lines(r["stdout"])[-1]
    print(f"cli bench ({r['s']:.1f} s): {json.dumps(rec)} [{card}]",
          flush=True)
    assert tuple(rec) == BN.RESULT_KEYS, f"bench keys {list(rec)}"
    differ = sorted(set(rec["extra"]) ^ set(BN.EXTRA_KEYS))
    assert not differ, f"bench extra keys differ: {differ}"
    assert rec["extra"]["recall_target_met"], "bench missed its target"
    assert r["launches"]["expand_topr"] > 0, "bench never launched expand_topr"
    return {"json": rec, "s": r["s"], "launches": r["launches"]}


def cli_bench_shapes(idx_dir: str, queries: np.ndarray, bench: dict,
                     card: str, dev: torch.device, timings: list) -> list:
    """expand_topr against its plain version at the shapes the CLI and the
    bench launched it at, on the bids that the CLI's saved 1M x 128 index
    routes (the bench builds that index from the same rows and queries):
    ``search``'s one 4,096-query call at ef_search 40; ``eval``'s chunks
    (``measure_qps``'s pipeline) at every probe count of its sweep; the
    bench's 4,096-query calls at each grid point up to its probes and, with
    its 10% filter mask, at twice them. The stage-1 width is the index's
    (rerank_width, k 10); int8 keys exactly equal. Stage 1 is also timed
    (``stage1_timing``, appended to ``timings``) at the eval chunk of the
    most probes, the shape with the most candidates a query."""
    idx = BlockHnswIndex.load(idx_dir, device=dev)
    nq = len(queries)
    q = torch.from_numpy(queries).to(dev)
    r = max(idx.rerank_width, 10)
    probes = bench["extra"]["probes"]
    eval_q = max(64, nq // E.PIPELINE)
    cases = [("cli search ef_search 40", nq, idx.probes_for_ef(40), None)]
    cases += [(f"cli eval chunk, probes {p}", eval_q, p, None)
              for p in sorted({idx.probes_for_ef(ef) for ef in E.SWEEP_EFS
                               if ef >= 10})]
    cases += [(f"bench grid, probes {p}", nq, p, None)
              for p in PROBE_GRID if p <= probes]
    cases.append((f"bench filtered, probes {2 * probes}", nq, 2 * probes,
                   BN.filter_mask(idx.n_total)))
    recs = []
    most = max(p for what, _, p, _ in cases if what.startswith("cli eval"))
    for what, n_q, p, mask in cases:
        args, kw = routed_args(idx, q[:n_q], p)
        if mask is not None:
            kw["allowed"] = idx._filter_device(mask)[0]
        recs.extend(topr_variants(args, kw, "int8", card, 0.0,
                                  f"{what} (routed bids)", rs=(r,),
                                  nqs=(n_q,)))
        recs[-1]["p"] = p
        if what.startswith("cli eval") and p == most:
            timings.append(stage1_timing(args, kw, r, card,
                                         f"{what}, 1M x 128 CLI index, "
                                         "routed bids"))
    del idx
    torch.cuda.empty_cache()
    return recs


def planner_phase(base: np.ndarray, bench: dict, card: str) -> dict:
    """``planner.calibrate()`` on the card (its expand_topr launches
    counted, its stage-1 call held against the plain version), each
    estimator beside the bench's QPS, the two constants that
    ``planner.anchor`` solves from this run, and ``choose_engine(1M, 128)``
    on a sample of the bench's own rows. The plan must be the engine that
    was fastest in the bench. It may differ only as the known reference
    defect (ROADMAP queue 3): the structure gate refuses the ANN engines
    and picks flat, while with the gate off the estimators, at the
    defaults and at the calibrated rates, pick the fastest; that case is
    recorded as an expected failure."""
    reset_expand_counts()
    t0 = time.perf_counter()
    raw = PL.calibrate()
    out = {"calibrate_s": time.perf_counter() - t0,
           "launches": expand_launches()}
    assert out["launches"]["expand_topr"] > 0, \
        "calibrate never launched expand_topr"
    out["calibrated"] = dataclasses.asdict(raw)
    assert all(math.isfinite(v) and v > 0 for v in out["calibrated"].values())
    print(f"planner.calibrate() ({out['calibrate_s']:.2f} s): "
          f"{json.dumps(out['calibrated'])} [{card}]", flush=True)
    args, kw, r = PL.stage1_case()
    out["topr"] = topr_variants(args, kw, "int8", card, 0.0,
                                "planner.calibrate stage 1 (random bids)",
                                rs=(r,), nqs=(args[3].shape[0],))
    del args, kw
    ex = bench["extra"]
    measured = {"flat": ex["flat_qps"], "block": bench["value"],
                "graph": ex["hnsw_graph_qps"]}
    anchored = PL.anchor(raw, N, DIM, block_qps=measured["block"],
                         graph_qps=measured["graph"])
    models = {"default": PL.HardwareModel(), "calibrated": raw,
              "anchored": anchored}
    est = {name: {"flat": PL.estimate_flat_qps(N, DIM, hw=hw),
                  "block": PL.estimate_block_qps(N, DIM, hw=hw),
                  "graph": PL.estimate_graph_qps(N, DIM, hw=hw)}
           for name, hw in models.items()}
    for eng in ("flat", "block", "graph"):
        print(f"planner {eng}: measured {measured[eng]:.1f} QPS, estimated "
              f"{est['default'][eng]:.1f} (defaults) / "
              f"{est['calibrated'][eng]:.1f} (calibrated) [{card}]",
              flush=True)
    print(f"HardwareModel constants solved from this run (planner.anchor): "
          f"{json.dumps(dataclasses.asdict(anchored))} [{card}]", flush=True)
    fastest = max(measured, key=measured.get)
    sample = base[np.random.default_rng(0).choice(N, 8192, replace=False)]
    plan = PL.choose_engine(N, DIM, sample=sample)
    ungated = {name: PL.choose_engine(N, DIM, hw=models[name]).engine
               for name in ("default", "calibrated")}
    check = {"engine": plan.engine, "est_qps": plan.est_qps,
             "params": plan.params, "reason": plan.reason,
             "structure_score": PL.cluster_structure_score(sample),
             "fastest_in_bench": fastest, "gate_off": ungated,
             "expected_failure": None}
    if plan.engine != fastest:
        known = (plan.engine == "flat" and "refused" in plan.reason
                 and check["structure_score"] < PL.STRUCTURE_MIN
                 and all(e == fastest for e in ungated.values()))
        assert known, f"choose_engine picked {plan.engine}, the bench's " \
            f"fastest is {fastest}: {check}"
        check["expected_failure"] = (
            "reference parity (ROADMAP queue 3): the structure gate refuses "
            "the ANN engines on these rows")
    print(f"choose_engine(1M, 128, sample of the bench rows): {plan.engine} "
          f"at {plan.est_qps:.1f} est. QPS, structure score "
          f"{check['structure_score']:.3f}, bench fastest {fastest}, gate "
          f"off {json.dumps(ungated)} ({plan.reason})"
          f"{'; EXPECTED FAILURE: ' + check['expected_failure'] if check['expected_failure'] else ''}"
          f" [{card}]", flush=True)
    out.update(measured=measured, estimates=est, bench_probes=ex["probes"],
               anchored_from_this_run=dataclasses.asdict(anchored),
               plan=check)
    return out


def profile_phase(idx, qchunk, probes: int, card: str) -> dict:
    """One 1024-query block chunk under ``profiling.trace``: device busy,
    device span and host ms by range (``profiling.range_times``); and what
    an annotation costs outside a trace."""
    idx.search_device(qchunk, k=10, probes=probes)  # warm, untraced
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            idx.search_device(qchunk, k=10, probes=probes)
        out = {"ranges": profiling.range_times(
            os.path.join(tmp, profiling.TRACE_FILE), ("route", "expand"))}
    for name, rec in out["ranges"].items():
        assert rec["count"] == 1 and rec["device_ms"] > 0, \
            f"range {name} not traced on the device: {rec}"
    calls = 200_000
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        with profiling.annotate("route"):
            pass
    out["annotate_off_ns"] = (time.perf_counter_ns() - t0) / calls
    print(f"profiled {CHUNK}-query block chunk by range: "
          f"{json.dumps(out['ranges'])}; an annotation outside a trace "
          f"costs {out['annotate_off_ns']:.1f} ns of host time [{card}]",
          flush=True)
    return out

GRAPH_LADDER = BN.GRAPH_LADDER  # bench.py:258-261
N_DELETE = 1_000           # keeps compact's repair batch near 32k rows
BIN_GRAPH_N = 1_000_000    # rows of the binary graph (cut first if slow)
JACCARD_GRAPH_N = 100_000


def ladder_kw(point) -> dict:
    dce, ef, exp, ms = point
    return dict(ef_search=ef, expand=exp, descent_ef=dce, max_steps=ms)


def walk_ladder(search, grade, card: str, what: str):
    """The first GRAPH_LADDER point whose ``grade(search(kw))`` reaches
    TARGET_RECALL: (search kwargs, grade, result)."""
    for point in GRAPH_LADDER:
        kw = ladder_kw(point)
        res = search(kw)
        r = grade(res)
        print(f"{what} {json.dumps(kw)}: recall@10 {r:.4f} [{card}]",
              flush=True)
        if r >= TARGET_RECALL:
            return kw, r, res
    raise AssertionError(f"{what}: no ladder point reached the target")


def qps_windows(search_chunk, n_queries: int, reps: int = 9):
    """QPS over 1024-query chunks: windows that each end in a synchronize
    and the host fetch of the last chunk's ids; (median, windows)."""
    def serve_pass():
        for s in range(0, n_queries, CHUNK):
            last = search_chunk(s)
        torch.cuda.synchronize()
        return np.asarray(last.cpu() if isinstance(last, torch.Tensor)
                          else last)

    serve_pass()  # warm-up
    windows = []
    for _ in range(reps):
        t0 = time.perf_counter()
        serve_pass()
        windows.append(n_queries / (time.perf_counter() - t0))
    return float(np.median(windows)), windows


def graph_phase(base: np.ndarray, queries: np.ndarray, gt: np.ndarray,
                card: str, dev: torch.device):
    """HnswIndex at 1M x 128: bulk build from a CUDA tensor, bench.py's
    ladder to recall@10 >= 0.95, QPS, counters, descent routing at the same
    point, a profiled chunk. Returns (numbers, index, search kwargs,
    breakdown)."""
    out = {}
    cfg = HnswConfig(dim=DIM, m=16, ef_construction=64, seed=0)
    xdev = torch.from_numpy(base).to(dev)
    qdev = torch.from_numpy(queries).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    idx = HnswIndex(cfg, device=dev).build(xdev)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["build_vps"] = N / out["build_s"]
    out["build_stages"] = idx.build_stats["stages"]
    idx_r = HnswIndex(cfg, device=dev)
    t0 = time.perf_counter()
    build_bulk(idx_r, xdev, refine_rounds=1)
    torch.cuda.synchronize()
    refine = {"build_s": time.perf_counter() - t0,
              "stages": idx_r.build_stats["stages"]}
    del xdev
    st = idx.stats()
    out["bytes_per_element"] = st["bytes_per_element"]
    out["level_counts"] = st["level_counts"]
    print(f"graph build from a CUDA tensor: {out['build_s']:.3f} s, "
          f"{out['build_vps']:.1f} vec/s, stages "
          f"{json.dumps(out['build_stages'])}, levels {st['level_counts']}, "
          f"{st['bytes_per_element']} bytes/element [{card}]", flush=True)
    kw, out["recall"], (d, ids) = walk_ladder(
        lambda kw: idx.search(qdev, k=10, **kw),
        lambda res: recall_at_k(res[1], gt, 10), card, "graph 1M x 128")
    out["point"] = kw
    assert d.shape == (NQ, 10) and np.isfinite(d).all()
    assert ((ids >= 0) & (ids < N)).all()
    exact = np.sqrt(((queries[:, None, :] - base[ids]) ** 2).sum(-1))
    assert np.abs(d.astype(np.float64) ** 2 - exact.astype(np.float64) ** 2
                  ).max() <= sq_bound(base, queries), "graph distances"
    # one NN-descent round (refine_rounds=1) beside the default build, at
    # the ladder's first two points
    refine["recall"] = [{
        **ladder_kw(p), "refine0": recall_at_k(
            idx.search(qdev, k=10, **ladder_kw(p))[1], gt, 10),
        "refine1": recall_at_k(
            idx_r.search(qdev, k=10, **ladder_kw(p))[1], gt, 10)}
        for p in GRAPH_LADDER[:2]]
    del idx_r
    out["refine"] = refine
    print(f"graph bulk build with refine_rounds=1: {refine['build_s']:.3f} s "
          f"(refine_rounds=0: {out['build_s']:.3f} s), stages "
          f"{json.dumps(refine['stages'])}; recall@10 at the ladder's first "
          f"two points {json.dumps(refine['recall'])} [{card}]", flush=True)
    out["qps"], out["qps_windows"] = qps_windows(
        lambda s: idx.search_device(qdev[s:s + CHUNK], k=10, **kw)[1], NQ)
    # the route of each request: one launch of the route kernel, no chain
    with counted_routes() as calls:
        for s in range(0, NQ, CHUNK):
            idx.search_device(qdev[s:s + CHUNK], k=10, **kw)
        torch.cuda.synchronize()
    out["route_launches"] = route_launches(calls)
    assert out["route_launches"] == {"fused": -(-NQ // CHUNK),
                                     "gemm_topk": 0, "plain": 0}, \
        out["route_launches"]
    _, _, counters = idx.search_with_stats(qdev, k=10, **kw)
    out["counters"] = counters
    _, ids_desc = idx.search(qdev, k=10, route="descent", **kw)
    out["descent_recall"] = recall_at_k(ids_desc, gt, 10)
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"graph QPS {out['qps']:.1f} (median of 9 windows of {NQ} "
          f"queries, min {min(out['qps_windows']):.1f}, max "
          f"{max(out['qps_windows']):.1f}) at {json.dumps(kw)}, recall@10 "
          f"{out['recall']:.4f} (scan routing; descent routing "
          f"{out['descent_recall']:.4f}); per query {json.dumps(counters)}; "
          f"peak device memory {out['peak_mem_GB']:.2f} GB [{card}]",
          flush=True)
    qchunk = qdev[:CHUNK]
    breakdown = device_breakdown(
        lambda: idx.search_device(qchunk, k=10, **kw), card,
        f"graph path, one {CHUNK}-query HnswIndex.search_device chunk")
    return out, idx, kw, breakdown


def beam_against_loop(g, q, seeds, ef: int, metric: Metric) -> dict:
    """The kernel and the loop on the same beam: rows whose ids (the whole
    pool) and whose top 10 differ, and the steps, evals and rings of the
    rows that agree. ``tie_gap``: at each differing row's first differing
    slot, the float64 score gap of the two ids over the f32 rounding scale
    (``2 d eps`` times the terms' absolute sum): at most 1 where the two
    orders differ at a tie within rounding."""
    max_steps = ef + 16
    ring = SE.ring_width(max_steps, 1)
    kd, ki, kh, khops, kevals = BM.beam_level0(
        g, q, seeds, ef=ef, max_steps=max_steps, metric=metric, ring=ring)
    ld, li, st = SE._search_layer_body(
        g, q, seeds, 0, level0=True, ef=ef, expand=1, max_steps=max_steps,
        metric=metric, skip_deleted=True, mask_deleted_results=True,
        with_counters=True, return_state=True)
    same = (ki == li).all(1)
    out = {"Q": q.shape[0], "ef": ef, "metric": metric.value,
           "rows_differing": int((~same).sum()),
           "top10_rows_differing": int((~(ki[:, :10] == li[:, :10]).all(1))
                                       .sum()),
           "counters_equal": bool(torch.equal(khops[same], st[4][same])
                                  and torch.equal(kevals[same],
                                                  st[5][same])),
           "rings_equal": (bool(torch.equal(kh[same], st[3][same]))
                           if max_steps <= ring else None),
           "score_gap": float((kd - ld)[same & torch.isfinite(kd).all(1)]
                              .abs().max()) if bool(same.any()) else 0.0,
           "longest": int(khops.max())}
    gaps = []
    for r in torch.nonzero(~same).reshape(-1).tolist()[:64]:
        c = int(torch.nonzero(ki[r] != li[r])[0])
        ids = torch.stack([ki[r, c], li[r, c]]).long()
        x = g.vectors[ids].double()
        qq = q[r].double()
        if metric is Metric.L2:
            terms = (qq - x) ** 2
        elif metric is Metric.L1:
            terms = (qq - x).abs()
        else:
            terms = -(qq * x)
        sc = terms.sum(1)
        tol = 2 * q.shape[1] * float(np.finfo(np.float32).eps) * float(
            terms.abs().sum(1).max())
        gaps.append(abs(float(sc[0] - sc[1])) / tol)
    out["tie_gap"] = max(gaps, default=0.0)
    return out


def beam_phase(idx, qdev, card: str) -> dict:
    """The level-0 beam kernel (``csrc/beam_search.cu``, ``ops/beam.py``)
    at the graph cell's shape: the 1M x 128 bulk-built graph (m 16,
    ef_construction 64), 4,096 queries at ef 40, seeded by the dense route.
    Held to the loop: on the rows as they are, ids on >= 99.9% of rows
    (ties within f32 rounding flip the rest) and the counters of the rows
    that agree; on integer-valued rows (every f32 sum exact in any order)
    everything equal, at ef 40 and 256 and in each metric. Timed by CUDA
    events beside its bound (``hnswbench/roofline_graph.py``'s bytes of
    the expanded rows and distinct vectors ``search._count_beam`` counts)
    and the loop; ``BEAM_LAUNCHES`` must equal the calls made on each
    path."""
    g, Q, ef = idx.graph, qdev.shape[0], 40
    metric = idx.cfg.metric
    seeds = SE.scan_seeds(g, qdev, idx._route_table()[0], descent_ef=1,
                          metric=metric)
    out = {"real": beam_against_loop(g, qdev, seeds, ef, metric)}
    assert out["real"]["rows_differing"] <= Q // 1000, out["real"]
    assert out["real"]["counters_equal"] and out["real"]["rings_equal"]
    gen = torch.Generator(device=qdev.device).manual_seed(3)
    ints = g._replace(vectors=torch.randint(
        -4, 5, g.vectors.shape, generator=gen, device=qdev.device).float())
    ints.vectors[g.sentinel] = 0
    qi = torch.randint(-4, 5, qdev.shape, generator=gen,
                       device=qdev.device).float()
    out["integer"] = []
    for e, m in ((40, Metric.L2), (256, Metric.L2), (40, Metric.IP),
                 (40, Metric.L1)):
        r = beam_against_loop(ints, qi[:1024] if e > 40 else qi,
                              seeds[:1024] if e > 40 else seeds, e, m)
        out["integer"].append(r)
        assert r["rows_differing"] == 0 and r["score_gap"] == 0.0, r
        assert r["counters_equal"] and r["rings_equal"] in (True, None), r
    del ints, qi
    max_steps = ef + 16
    ring = SE.ring_width(max_steps, 1)
    kernel = lambda: BM.beam_level0(  # noqa: E731
        g, qdev, seeds, ef=ef, max_steps=max_steps, metric=metric, ring=ring)
    loop = lambda: SE._search_layer_body(  # noqa: E731
        g, qdev, seeds, 0, level0=True, ef=ef, expand=1, max_steps=max_steps,
        metric=metric, skip_deleted=True, mask_deleted_results=True)
    out["ms"], out["nvidia_smi"] = sampled_ms(kernel)
    out["device_ms"] = device_ms(kernel)
    out["plain_ms"] = cuda_ms(loop, 3)
    _, _, hist, hops, _ = kernel()
    r0, v0 = SE.BEAM_ROWS, SE.BEAM_VECTORS
    assert SE._count_beam(g, seeds, hist, hops, 1, None) <= max_steps
    rows, vectors = SE.BEAM_ROWS - r0, SE.BEAM_VECTORS - v0
    out["least_bytes"] = roofline_graph.beam_bytes(
        rows, vectors, g.neighbors0.shape[1], g.dim)
    out["bound_ms"] = roofline_graph.beam_least_ms(
        rows, vectors, g.neighbors0.shape[1], g.dim)
    out["bound_by"] = "bytes"
    out["roofline_pct"] = 100.0 * out["bound_ms"] / out["ms"]
    out["steps_mean"] = float(hops.float().mean())
    out["steps_max"] = int(hops.max())
    # BEAM_LAUNCHES: one kernel launch a search() call; expand 2 and an ef
    # past BEAM_MAX_EF take the loop
    for k in BM.BEAM_LAUNCHES:
        BM.BEAM_LAUNCHES[k] = 0
    for _ in range(3):
        idx.search_device(qdev, k=10, ef_search=ef)
    idx.search_device(qdev[:256], k=10, ef_search=ef, expand=2)
    idx.search_device(qdev[:256], k=10, ef_search=BM.BEAM_MAX_EF + 1)
    torch.cuda.synchronize()
    out["launches"] = dict(BM.BEAM_LAUNCHES)
    assert out["launches"] == {"kernel": 3, "loop": 2, "plain": 0}, \
        out["launches"]
    out["card"] = card
    print(f"beam at the sift1m-graph.bulk shape: {json.dumps(out)}",
          flush=True)
    return out


def block_graph_routed(base: np.ndarray, queries: np.ndarray, gt, card: str,
                       dev: torch.device) -> dict:
    """BlockHnswIndex(routing="graph") on the same data: the centroid graph
    routes, the fused stage 1 expands. Its launch counters are reset here
    and read by the caller."""
    out = {}
    cfg = HnswConfig(dim=DIM, m=16, ef_construction=64, seed=0)
    qdev = torch.from_numpy(queries).to(dev)
    bidx = BlockHnswIndex(cfg, block_size=BLOCK, routing="graph",
                          device=dev).build(torch.from_numpy(base).to(dev))
    st = bidx.build_stats
    out["build_s"], out["build_vps"] = st["total_s"], st["vectors_per_sec"]
    out["centroid_graph_s"] = st["centroid_graph_s"]
    assert bidx.stats()["routing"] == "graph"
    print(f"graph-routed block build: {st['total_s']} s "
          f"({st['vectors_per_sec']} vec/s), centroid graph over "
          f"{bidx.n_blocks} centroids {st['centroid_graph_s']} s [{card}]",
          flush=True)
    # the first grid probe count at TARGET_RECALL, else the best: the
    # centroid graph's beam misses some nearest centroids (PERF.md §7)
    grid = {}
    for p in (p for p in PROBE_GRID if p <= bidx.n_blocks):
        _, ids = bidx.search(qdev, k=10, probes=p)
        grid[p] = recall_at_k(ids, gt, 10)
        print(f"graph-routed probes {p}: recall@10 {grid[p]:.4f} [{card}]",
              flush=True)
        if grid[p] >= TARGET_RECALL:
            break
    out["probes"] = min(grid, key=lambda p: (grid[p] < TARGET_RECALL,
                                             -grid[p] if grid[p]
                                             < TARGET_RECALL else p))
    out["recall"], out["grid"] = grid[out["probes"]], grid
    out["reached_target"] = out["recall"] >= TARGET_RECALL
    assert out["recall"] >= 0.9, "graph routing lost the blocks"
    out["qps"], out["qps_windows"] = qps_windows(
        lambda s: bidx.search_device(qdev[s:s + CHUNK], k=10,
                                     probes=out["probes"])[1], NQ, 3)
    print(f"graph-routed block QPS {out['qps']:.1f} (median of 3 windows) "
          f"at probes {out['probes']}, recall@10 {out['recall']:.4f} "
          f"(target {TARGET_RECALL} reached: {out['reached_target']}) "
          f"[{card}]", flush=True)
    return out


def graph_lifecycle(idx, base: np.ndarray, queries: np.ndarray, kw: dict,
                    card: str, dev: torch.device) -> dict:
    """Wave adds, deletes, compact, a filtered search_iterative and a
    save/load round trip on the 1M x 128 HnswIndex."""
    out = {}
    qdev = torch.from_numpy(queries).to(dev)
    rng = np.random.default_rng(7)
    extra = (base[rng.integers(0, N, N_ADD)]
             + rng.normal(0.0, 0.5, size=(N_ADD, DIM))).astype(np.float32)
    t0 = time.perf_counter()
    new_ids = idx.add(extra)
    torch.cuda.synchronize()
    out["add_s"] = time.perf_counter() - t0
    assert (new_ids == np.arange(N, N + N_ADD)).all() and idx.n == N + N_ADD
    # each added row finds itself: at the serving point (a few beam steps)
    # and with the beam run to convergence
    for name, skw in (("added_found", kw),
                      ("added_found_converged", {**kw, "ef_search": 64,
                                                 "max_steps": 0})):
        _, ids = idx.search(extra[:256], k=1, **skw)
        out[name] = float((ids[:, 0] == new_ids[:256]).mean())
    print(f"graph add {N_ADD} rows (waves of {idx.cfg.wave_size}): "
          f"{out['add_s']:.3f} s; of 256 added rows, "
          f"{out['added_found']:.4f} find themselves first at the serving "
          f"point, {out['added_found_converged']:.4f} with ef 64 run to "
          f"convergence [{card}]", flush=True)
    assert out["added_found_converged"] >= 0.9

    victims = rng.choice(N + N_ADD, N_DELETE, replace=False)
    idx.delete(victims)
    live = np.setdiff1d(np.arange(N + N_ADD), victims)
    every = np.concatenate([base, extra])
    lflat = FlatIndex(torch.from_numpy(every[live]).to(dev), Metric.L2,
                      device=dev)
    lgt = live[lflat.search(qdev, k=10, exact=True)[1]]
    del lflat, every
    _, ids = idx.search(qdev, k=10, **kw)
    assert not np.isin(ids, victims).any(), "a deleted id came back"
    out["recall_before_compact"] = recall_at_k(ids, lgt, 10)
    t0 = time.perf_counter()
    out["repaired"] = idx.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    _, ids = idx.search(qdev, k=10, **kw)
    assert not np.isin(ids, victims).any(), "a deleted id came back"
    out["recall_after_compact"] = recall_at_k(ids, lgt, 10)
    print(f"graph delete {N_DELETE} ids, compact {out['compact_s']:.3f} s: "
          f"{out['repaired']} lists repaired; recall@10 against the live "
          f"rows {out['recall_before_compact']:.4f} before, "
          f"{out['recall_after_compact']:.4f} after [{card}]", flush=True)

    passes = np.random.default_rng(FILTER_SEED + 1).random(N + N_ADD) \
        < FILTER_SHARE
    t0 = time.perf_counter()
    _, ids = idx.search_iterative(queries[:CHUNK], k=10,
                                  predicate=lambda i: passes[i])
    out["iterative_s"] = time.perf_counter() - t0
    got = ids[ids >= 0]
    assert passes[got].all() and not np.isin(got, victims).any()
    out["iterative_filled"] = float((ids >= 0).mean())
    print(f"graph search_iterative, 10% predicate, {CHUNK} queries: "
          f"{out['iterative_s']:.3f} s, {out['iterative_filled']:.4f} of "
          f"slots filled, every id passes [{card}]", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        idx.save(tmp)
        out["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        idx2 = HnswIndex.load(tmp, device=dev)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    d1, i1 = idx.search(qdev, k=10, **kw)
    d2, i2 = idx2.search(qdev, k=10, **kw)
    assert np.array_equal(i1, i2) and np.array_equal(d1, d2), "save/load"
    del idx2
    print(f"graph save {out['save_s']:.3f} s, load {out['load_s']:.3f} s: "
          f"identical ids and distances [{card}]", flush=True)
    return out


def chunked_search(index, q, **kw):
    """BinaryHnswIndex.search over CHUNK-query slices (bounds the step's
    [Q, expand * 2m, d] gathers at d = 1536)."""
    parts = [index.search(q[s:s + CHUNK], **kw) for s in range(0, len(q),
                                                                CHUNK)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


def binary_graph(bits_dev, qbits: np.ndarray, qp, xp, gt_d, gt, card: str,
                 dev: torch.device) -> dict:
    """BinaryHnswIndex(engine="graph") at 1536 bits: hamming over the first
    BIN_GRAPH_N rows (the ladder to tie-aware recall@10 >= 0.95, exact
    integer distances, QPS) and jaccard (rerank_k=100) over the first
    JACCARD_GRAPH_N rows (exact distances)."""
    out = {"rows": BIN_GRAPH_N}
    n = BIN_GRAPH_N
    if n < N:
        out["reduced"] = f"hamming graph over the first {n} of {N} rows"
        gt_d, gt = BinaryFlatIndex(xp[:n], metric="hamming",
                                   device=dev).search(qp, k=10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gidx = BinaryHnswIndex(BIN_DIM, "hamming", device=dev).build(
        bits_dev[:n])
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["build_stages"] = gidx.inner.build_stats["stages"]
    print(f"binary graph (hamming) build over {n} rows: "
          f"{out['build_s']:.3f} s, stages {json.dumps(out['build_stages'])}"
          f" [{card}]", flush=True)

    def grade(res):
        true = true_hamming(qp, xp, res[1])
        grade.true = true
        return float((true <= gt_d[:, 9:10]).mean())

    kw, out["tie_recall"], (d, ids) = walk_ladder(
        lambda kw: chunked_search(gidx, qbits, k=10, **kw), grade, card,
        "binary graph hamming (tie-aware)")
    out["point"], out["id_recall"] = kw, recall_at_k(ids, gt, 10)
    assert (ids >= 0).all() and np.array_equal(
        d, grade.true.astype(np.float32)), \
        "hamming distances must be the exact popcounts"
    out["qps"], out["qps_windows"] = qps_windows(
        lambda s: gidx.search(qbits[s:s + CHUNK], k=10, **kw)[1], NQ, 5)
    print(f"binary graph hamming at {json.dumps(kw)}: tie-aware recall@10 "
          f"{out['tie_recall']:.4f}, id recall@10 {out['id_recall']:.4f}, "
          f"exact integer distances, QPS {out['qps']:.1f} (median of 5 "
          f"windows through BinaryHnswIndex.search) [{card}]", flush=True)
    del gidx
    nj = JACCARD_GRAPH_N
    jg = BinaryHnswIndex(BIN_DIM, "jaccard", device=dev).build(bits_dev[:nj])
    jgt_d, jgt = BinaryFlatIndex(xp[:nj], metric="jaccard",
                                 device=dev).search(qp[:CHUNK], k=10)
    # the cosine beam runs to convergence: rerank_k candidates need a full
    # pool, which the ladder's few-step points do not fill
    d, ids = jg.search(qbits[:CHUNK], k=10, rerank_k=100,
                       **{**kw, "max_steps": 0})
    rows = xp[torch.from_numpy(ids.astype(np.int64)).to(dev)]
    true = BO.jaccard_distance(qp[:CHUNK, None, :].expand_as(rows),
                               rows).cpu().numpy()
    assert (ids >= 0).all() and np.array_equal(d, true), \
        "jaccard distances must be exact"
    out["jaccard_rows"] = nj
    out["jaccard_tie_recall"] = float((true <= jgt_d[:, 9:10]).mean())
    out["jaccard_id_recall"] = recall_at_k(ids, jgt, 10)
    print(f"binary graph jaccard over {nj} rows, rerank_k 100, {CHUNK} "
          f"queries: tie-aware recall@10 {out['jaccard_tie_recall']:.4f}, "
          f"id recall@10 {out['jaccard_id_recall']:.4f}, exact distances "
          f"[{card}]", flush=True)
    return out


def hamming_bound(Q: int, N: int, W: int, out_bytes: int):
    """Both hamming entries: the words and row popcounts read once, the
    output written once; the 2 Q N bits operations as int8 MACs."""
    return bound(4 * (Q + N) * (W + 1) + out_bytes, 2 * Q * N * W * 32,
                 "int8")


def hamming_variant(q, x, card: str, what: str, keep: bool = False):
    """hamming_scan against its plain version on the same card tensors:
    exactly equal int32. The plain version's time is that of the full-size
    call the equality check makes (CUDA events, one call). With ``keep``
    the plain counts are returned too."""
    Q, W = q.shape
    n = x.shape[0]
    got = H.hamming_scan(q, x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = H.hamming_scan_reference(q, x)
    end.record()
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    err = 0 if equal else (got.long() - want.long()).abs().max().item()
    del got
    ms, smi = sampled_ms(lambda: H.hamming_scan(q, x))
    rec = {"Q": Q, "N": n, "W": W, "bits": W * 32, "shape_of": what,
           "exact_equal": equal, "max_abs_err": err, "ms": ms,
           "plain_ms": start.elapsed_time(end), "smi": smi}
    rec["bound_ms"], rec["bound_by"] = hamming_bound(Q, n, W, 4 * Q * n)
    rec["TOPs_int8_equiv"] = 2 * Q * n * W * 32 / ms / 1e9
    print(f"hamming_scan Q={Q} N={n} W={W} ({what}): {ms:.3f} ms (plain "
          f"{rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.3f} ms by "
          f"{rec['bound_by']}), {rec['TOPs_int8_equiv']:.0f} TOP/s "
          f"int8-equivalent, exactly equal {equal}, nvidia-smi "
          f"{json.dumps(smi)} [{card}]", flush=True)
    assert equal, rec
    return (rec, want) if keep else rec


def topk_variants(q, x, h_ref, scan_plain_ms: float, card: str,
                  ks=(1, 10, 100), nqs=None) -> list:
    """hamming_topk against its plain version on the same card tensors, at
    ``nqs`` query counts (default: Q and RAGGED_Q), both metrics, k in
    ``ks``: distances and ids exactly equal. The plain version starts from
    ``h_ref``, the plain all-pairs counts of these queries; its time at Q
    is that call's (``scan_plain_ms``) plus the distance and keyed top-k
    passes."""
    Q, W = q.shape
    n = x.shape[0]
    pq, px = H.row_popcount(q), H.row_popcount(x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    recs = []
    for metric in H.METRICS:
        start.record()
        d_ref = H.distances(h_ref, pq, px, metric)
        end.record()
        torch.cuda.synchronize()
        dist_ms = start.elapsed_time(end)
        for k in ks:
            for nq in nqs or (Q, RAGGED_Q):
                start.record()
                want = T.topk_smallest_by_index(d_ref[:nq], k)
                end.record()
                got = H.hamming_topk(q[:nq], x, pq[:nq], px, k, metric)
                torch.cuda.synchronize()
                equal = (torch.equal(got[0], want[0])
                         and torch.equal(got[1], want[1].to(torch.int32)))
                call = (lambda: H.hamming_topk(q[:nq], x, pq[:nq], px, k,
                                               metric))
                ms, smi = sampled_ms(call) if nq == Q else (
                    cuda_ms(call, 10), None)
                rec = {"metric": metric, "k": k, "Q": nq, "N": n, "W": W,
                       "exact_equal": equal,
                       "max_abs_err": (got[0] - want[0]).abs().max().item(),
                       "ms": ms, "smi": smi,
                       "plain_ms": (scan_plain_ms + dist_ms
                                    + start.elapsed_time(end))
                       if nq == Q else None}
                rec["bound_ms"], rec["bound_by"] = hamming_bound(
                    nq, n, W, 8 * nq * k)
                print(f"hamming_topk {metric} k={k} Q={nq} N={n} W={W}: "
                      f"{ms:.3f} ms (plain {rec['plain_ms']} ms, bound "
                      f"{rec['bound_ms']:.3f} ms by {rec['bound_by']}), "
                      f"exactly equal {equal}, nvidia-smi "
                      f"{json.dumps(smi)} [{card}]", flush=True)
                assert equal, rec
                recs.append(rec)
        del d_ref
    return recs


def library_yardstick(q, x, h_ref, card: str) -> dict:
    """The one library call for the and-counts: ``torch._int_mm`` of the
    0/1 int8 expansions (1.5 GB for the table, built here and freed), with
    hamming's affine step; checked equal to the plain counts, then timed.
    The port never calls it."""
    Q, W = q.shape
    n = x.shape[0]
    shifts = torch.arange(32, device=q.device, dtype=torch.int32)

    def spread(w):
        return ((w[:, :, None] >> shifts) & 1).to(torch.int8).reshape(
            w.shape[0], W * 32)

    qe = spread(q)
    xe = torch.empty((n, W * 32), dtype=torch.int8, device=q.device)
    for s in range(0, n, 1 << 17):
        xe[s:s + (1 << 17)] = spread(x[s:s + (1 << 17)])
    pq, px = H.row_popcount(q), H.row_popcount(x)

    def gemm():
        return torch._int_mm(qe, xe.t())

    def call():
        return pq[:, None] + px[None, :] - 2 * gemm()

    assert torch.equal(call(), h_ref), "library counts"
    ms, smi = sampled_ms(call)
    gemm_ms, gemm_smi = sampled_ms(gemm)
    del qe, xe
    torch.cuda.empty_cache()
    rec = {"call": "pq[:, None] + px[None, :] - 2 * torch._int_mm(q01, "
                   "x01.t())", "Q": Q, "N": n, "W": W, "ms": ms,
           "smi": smi, "int_mm_ms": gemm_ms, "int_mm_smi": gemm_smi}
    print(f"library yardstick {rec['call']}: {ms:.3f} ms, equal to the "
          f"plain counts, nvidia-smi {json.dumps(smi)}; the bare "
          f"torch._int_mm (and-counts only): {gemm_ms:.3f} ms, nvidia-smi "
          f"{json.dumps(gemm_smi)} [{card}]", flush=True)
    return rec


def flat_serving(xp, qp, card: str) -> dict:
    """BinaryFlatIndex.search over the NQ queries, k=10, both metrics: the
    fused top-k against the all-pairs design (``[chunk, N]`` matrices, then
    the keyed top-k), same results; QPS as the median of windows that each
    end in the host fetch ``search`` makes, and the peak device memory above
    what was allocated before the call."""
    out = {}
    for metric in H.METRICS:
        flat = BinaryFlatIndex(xp, metric=metric, device=xp.device)

        def all_pairs():
            # a comparison, not the path: its launches are not counted
            counts = H.LAUNCHES, H.TOPK_LAUNCHES
            d, i = flat._search_all_pairs(qp, H.row_popcount(qp), 10)
            H.LAUNCHES, H.TOPK_LAUNCHES = counts
            return d.cpu().numpy(), i.cpu().numpy()

        runs = {}
        for name, fn, reps in (("fused", lambda: flat.search(qp, k=10), 9),
                               ("all_pairs", all_pairs, 3)):
            res = fn()  # warm-up
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            extra = torch.cuda.max_memory_allocated() - base_mem
            windows = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                windows.append(NQ / (time.perf_counter() - t0))
            runs[name] = {"qps": float(np.median(windows)),
                          "qps_windows": windows,
                          "search_s": NQ / float(np.median(windows)),
                          "peak_extra_MB": extra / 1e6, "result": res}
        f, a = runs["fused"].pop("result"), runs["all_pairs"].pop("result")
        assert np.array_equal(f[0], a[0]) and np.array_equal(f[1], a[1]), \
            f"{metric}: fused and all-pairs results differ"
        out[metric] = runs
        print(f"BinaryFlatIndex {metric}, {NQ} queries, k=10: fused "
              f"{runs['fused']['search_s'] * 1e3:.2f} ms a search "
              f"({runs['fused']['qps']:.0f} QPS, peak extra "
              f"{runs['fused']['peak_extra_MB']:.1f} MB); all-pairs design "
              f"{runs['all_pairs']['search_s'] * 1e3:.2f} ms "
              f"({runs['all_pairs']['peak_extra_MB']:.1f} MB); same ids and "
              f"distances [{card}]", flush=True)
    return out


def all_pairs_chunks(n_queries: int) -> list[tuple[int, int]]:
    """(start, stop) of the first and the last query chunk that
    BinaryFlatIndex's all-pairs branch hands hamming_scan over N rows: the
    last one ends in a partly filled query tile."""
    step = max(1, BO._SCAN_CHUNK_ELEMS // N)
    last = (n_queries - 1) // step * step
    return [(0, min(step, n_queries)), (last, n_queries)]


def true_hamming(qp, xp, ids: np.ndarray) -> np.ndarray:
    """Exact hamming distances of the returned ids, popcount(q ^ x)."""
    rows = xp[torch.from_numpy(ids.astype(np.int64)).to(xp.device)]
    return BO.hamming_distance(qp[:, None, :], rows).cpu().numpy()


def binary_phase(card: str, dev: torch.device, data) -> dict:
    """The binary path at 1M x 1536 bits: kernel checks, the flat oracle,
    the hamming and jaccard indexes. ``data``:
    ``HostData.take("binary")``."""
    out = {}
    (bits, qbits), out["data_s"] = data
    print(f"binary data {bits.shape} in {out['data_s']:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    bits_dev = torch.from_numpy(bits).to(dev)
    xp = BO.pack_bits(bits_dev)                           # [N, 48] words
    qp = BO.pack_bits(torch.from_numpy(qbits).to(dev))    # [NQ, 48]
    qk = qp[:KERNEL_Q]
    rec, h_ref = hamming_variant(qk, xp, card, "full tiles", keep=True)
    ham = [rec]
    topk = topk_variants(qk, xp, h_ref, rec["plain_ms"], card)
    lib = library_yardstick(qk, xp, h_ref, card)
    del h_ref
    # a ragged W = 47 (4-byte loads, 3 chunks a tile): both entries
    q47 = BO.pack_bits(torch.from_numpy(qbits[:KERNEL_Q, :1500]).to(dev))
    x47 = BO.pack_bits(bits_dev[:, :1500])
    rec, h_ref = hamming_variant(q47, x47, card, "ragged W", keep=True)
    ham.append(rec)
    topk.extend(topk_variants(q47, x47, h_ref, rec["plain_ms"], card,
                              ks=(10, 100), nqs=(KERNEL_Q,)))
    del h_ref, q47, x47
    # the all-pairs branch's own chunks, over NQ and over CHUNK queries
    chunks = {}
    for nq in (NQ, CHUNK):
        for se in all_pairs_chunks(nq):
            chunks.setdefault(se, []).append(str(nq))
    for (s, e), of in sorted(chunks.items()):
        ham.append(hamming_variant(
            qp[s:e], xp, card, f"all-pairs chunk {s}:{e} of {'+'.join(of)}"))
    torch.cuda.empty_cache()

    # count only the binary path's launches
    H.LAUNCHES = H.TOPK_LAUNCHES = 0
    reset_expand_counts()
    t0 = time.perf_counter()
    gt_d, gt = BinaryFlatIndex(xp, metric="hamming").search(qp, k=10)
    out["flat_oracle_s"] = time.perf_counter() - t0
    out["flat_serving"] = flat_serving(xp, qp, card)
    # k above the fused limit: the all-pairs branch, whose first columns
    # are the fused top-k's
    kmax = H.TOPK_MAX_K
    flat = BinaryFlatIndex(xp, metric="jaccard")
    d_big, i_big = flat.search(qp[:CHUNK], k=kmax + 1)
    d_top, i_top = flat.search(qp[:CHUNK], k=kmax)
    assert np.array_equal(d_big[:, :kmax], d_top) and np.array_equal(
        i_big[:, :kmax], i_top), "k above the fused limit disagrees"
    del flat
    print(f"BinaryFlatIndex jaccard k={kmax + 1} (all-pairs branch) over "
          f"{CHUNK} queries: its first {kmax} columns equal the fused "
          f"k={kmax} [{card}]", flush=True)
    hidx = BinaryHnswIndex(BIN_DIM, "hamming", engine="block",
                           block_size=BLOCK, device=dev).build(bits_dev)
    st = hidx.inner.build_stats
    out["build_s"], out["build_vps"] = st["total_s"], st["vectors_per_sec"]
    print(f"BinaryFlatIndex oracle, {NQ} queries: "
          f"{out['flat_oracle_s']:.3f} s; hamming index build "
          f"{st['total_s']} s, {st['vectors_per_sec']} vec/s, "
          f"{hidx.inner.n_blocks} blocks, stages {json.dumps(st)} [{card}]",
          flush=True)
    chosen = None
    for p in (p for p in PROBE_GRID if p <= hidx.inner.n_blocks):
        d, ids = hidx.search(qbits, k=10, probes=p)
        true = true_hamming(qp, xp, ids)
        tie = float((true <= gt_d[:, 9:10]).mean())
        r = recall_at_k(ids, gt, 10)
        print(f"hamming probes {p}: tie-aware recall@10 {tie:.4f}, id "
              f"recall@10 {r:.4f} [{card}]", flush=True)
        if tie >= TARGET_RECALL:
            chosen = p
            out.update(probes=p, tie_recall=tie, id_recall=r)
            break
    assert chosen is not None, "no probe count reached the target recall"
    assert (ids >= 0).all() and np.array_equal(d, true.astype(np.float32)), \
        "hamming distances must be the exact popcounts"

    def serve_pass():
        for s in range(0, NQ, CHUNK):
            _, last = hidx.search(qbits[s:s + CHUNK], k=10, probes=chosen)
        return last

    serve_pass()
    windows = []
    for _ in range(9):
        t0 = time.perf_counter()
        serve_pass()
        windows.append(NQ / (time.perf_counter() - t0))
    out["qps"], out["qps_windows"] = float(np.median(windows)), windows
    print(f"hamming QPS {out['qps']:.1f} (median of 9 windows of {NQ} "
          f"queries through BinaryHnswIndex.search, min {min(windows):.1f}, "
          f"max {max(windows):.1f}) at probes {chosen}, exact integer "
          f"distances [{card}]", flush=True)

    jidx = BinaryHnswIndex(BIN_DIM, "jaccard", engine="block",
                           block_size=BLOCK, device=dev).build(bits_dev)
    jgt_d, jgt = BinaryFlatIndex(xp, metric="jaccard").search(qp[:CHUNK],
                                                              k=10)
    d, ids = jidx.search(qbits[:CHUNK], k=10, probes=chosen, rerank_k=100)
    rows = xp[torch.from_numpy(ids.astype(np.int64)).to(dev)]
    true = BO.jaccard_distance(qp[:CHUNK, None, :].expand_as(rows),
                               rows).cpu().numpy()
    assert (ids >= 0).all() and np.array_equal(d, true), \
        "jaccard distances must be exact"
    out["jaccard_tie_recall"] = float((true <= jgt_d[:, 9:10]).mean())
    out["jaccard_id_recall"] = recall_at_k(ids, jgt, 10)
    out["jaccard_build_s"] = jidx.inner.build_stats["total_s"]
    print(f"jaccard index build {out['jaccard_build_s']} s; probes {chosen}, "
          f"rerank_k 100, {CHUNK} queries: tie-aware recall@10 "
          f"{out['jaccard_tie_recall']:.4f}, id recall@10 "
          f"{out['jaccard_id_recall']:.4f}, exact distances [{card}]",
          flush=True)
    assert out["jaccard_tie_recall"] >= 0.85
    out["launches"] = {"hamming_scan": H.LAUNCHES - H.TOPK_LAUNCHES,
                       "hamming_topk": H.TOPK_LAUNCHES, **expand_launches()}
    # both indexes keep r <= 128 rows a query: stage 1 is the fused entry
    # (on whichever route topr_route picks)
    assert min(out["launches"][k] for k in (
        "hamming_scan", "hamming_topk", "expand_topr")) > 0, out["launches"]
    out["peak_mem_GB"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"binary path launches {json.dumps(out['launches'])}, peak device "
          f"memory {out['peak_mem_GB']:.2f} GB [{card}]", flush=True)

    # expand_score at d = 1536 on each index's own int8 copy and queries
    # (after the counts were read): the hamming index's L2 with a filter
    # mask, the jaccard index's cosine (the IP epilogue) as it serves
    rng = np.random.default_rng(3)
    qb = torch.from_numpy(qbits[:KERNEL_Q]).to(dev)
    wide = []
    for ix, allow in ((hidx, True), (jidx, False)):
        inner = ix.inner
        q = inner._queries(qb)
        q8, q_scl = _quantize_rows(q)
        B = inner.n_blocks
        bids = torch.from_numpy(
            rng.integers(0, B, size=(KERNEL_Q, chosen))).to(dev)
        kw = dict(q8=q8, q_scale=q_scl, score_scale=inner.score_scale)
        if allow:
            kw["allowed"] = torch.from_numpy(
                rng.random((B, BLOCK)) < FILTER_SHARE).to(dev)
        q_sq = (q * q).sum(1)
        metric = inner.cfg.metric
        wide.append(expand_variant(
            (inner.blocks_score, inner.blocks_sq, inner.block_ids, q, q_sq,
             bids, metric), kw, "int8", metric, card,
            (inner.blocks_sq.max() + q_sq.max()).item(),
            shape=dict(Q=KERNEL_Q, p=chosen, S=BLOCK, d=BIN_DIM, B=B)))
    # expand_topr at d = 1536 on both copies, masked and not (the hamming
    # index's L2, the jaccard index's cosine: the IP epilogue), keys
    # exactly equal; then stage 1 at the routed bids each index serves
    topr = []
    for ix in (hidx, jidx):
        inner = ix.inner
        q = inner._queries(qb)
        q8, q_scl = _quantize_rows(q)
        q_sq = (q * q).sum(1)
        B = inner.n_blocks
        bids = torch.from_numpy(
            rng.integers(0, B, size=(KERNEL_Q, chosen))).to(dev)
        args = (inner.blocks_score, inner.blocks_sq, inner.block_ids, q,
                q_sq, bids, inner.cfg.metric)
        cscale = (inner.blocks_sq.max() + q_sq.max()).item()
        for allow in (False, True):
            kw = dict(q8=q8, q_scale=q_scl, score_scale=inner.score_scale)
            if allow:
                kw["allowed"] = torch.from_numpy(
                    rng.random((B, BLOCK)) < FILTER_SHARE).to(dev)
            topr.extend(topr_variants(args, kw, "int8", card, cscale,
                                      f"{ix.metric} index, random bids"))
    timings = [routed_timing(ix.inner, qb, chosen, r, card,
                             f"{ix.metric} index (d=1536), routed bids")
               for ix, r in ((hidx, 40), (jidx, 100))]
    chunk_bits = qbits[:CHUNK]
    breakdown = device_breakdown(
        lambda: hidx.search(chunk_bits, k=10, probes=chosen), card,
        f"binary hamming path, one {CHUNK}-query BinaryHnswIndex.search "
        "chunk")
    del hidx, jidx
    torch.cuda.empty_cache()
    out["graph"] = binary_graph(bits_dev, qbits, qp, xp, gt_d, gt, card, dev)
    return {"numbers": out, "hamming": ham, "topk": topk, "library": lib,
            "expand_d1536": wide, "topr_d1536": topr, "timings": timings,
            "breakdown": breakdown}


IVF_LISTS = N // 1000      # pgvector's README: rows / 1000 up to 1M rows
IVF_PROBES = (1, 2, 4, 8, 16, 32)
D_N, D_DIM, D_NQ, D_SEED, D_PARTS = 10_000_000, 96, 8192, 13, 8
SUB_GRAPH_N = 200_000      # rows of the graph-engine partitioned index


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def ivf_phase(base: np.ndarray, queries: np.ndarray, gt: np.ndarray,
              card: str, dev: torch.device) -> dict:
    """IvfFlatIndex(128, L2, lists=1000) on the 1M x 128 rows: build, the
    recall/QPS curve over IVF_PROBES through measure_qps (1024-query
    chunks), peak memory; then add, delete, a filtered search_iterative
    and a save/load round trip."""
    out = {"lists": IVF_LISTS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ivf = IvfFlatIndex(DIM, Metric.L2, lists=IVF_LISTS, device=dev).build(
        base)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["maxlen"] = int(ivf.ids_by_list.shape[1])
    print(f"IVF build, lists {IVF_LISTS}: {out['build_s']:.3f} s, lists "
          f"padded to {out['maxlen']} slots [{card}]", flush=True)
    curve = []
    for p in IVF_PROBES:
        st = {}
        qps, ids = measure_qps(ivf, queries, 10, 0, repeats=5,
                               pipeline=NQ // CHUNK, stats_out=st, probes=p)
        row = {"probes": p, "recall": recall_at_k(ids, gt, 10), "qps": qps,
               **st}
        curve.append(row)
        print(f"IVF probes {p}: recall@10 {row['recall']:.4f}, QPS "
              f"{qps:.1f} (cv {st['qps_cv']}, min {st['qps_min']}, max "
              f"{st['qps_max']}) [{card}]", flush=True)
    assert curve[-1]["recall"] > curve[0]["recall"]
    out["curve"] = curve
    out["peak_mem_GB"] = peak_gb()
    print(f"IVF peak device memory {out['peak_mem_GB']:.2f} GB [{card}]",
          flush=True)
    rng = np.random.default_rng(11)
    extra = (base[rng.integers(0, N, N_ADD)]
             + rng.normal(0.0, 0.5, size=(N_ADD, DIM))).astype(np.float32)
    t0 = time.perf_counter()
    new_ids = ivf.add(extra)
    out["add_s"] = time.perf_counter() - t0
    assert (new_ids == np.arange(N, N + N_ADD)).all()
    _, ids = ivf.search(extra[:256], k=1, probes=1)
    assert (ids[:, 0] == new_ids[:256]).all(), "an added row is not found"
    victims = rng.choice(N + N_ADD, N_DELETE, replace=False)
    t0 = time.perf_counter()
    ivf.delete(victims)
    out["delete_s"] = time.perf_counter() - t0
    assert ivf.n == N + N_ADD - N_DELETE
    _, ids = ivf.search(queries, k=10, probes=8)
    assert not np.isin(ids, victims).any(), "a deleted id came back"
    passes = np.random.default_rng(FILTER_SEED + 2).random(N + N_ADD) \
        < FILTER_SHARE
    t0 = time.perf_counter()
    _, ids = ivf.search_iterative(queries[:CHUNK], k=10, probes=1,
                                  predicate=lambda i: passes[i])
    out["iterative_s"] = time.perf_counter() - t0
    got = ids[ids >= 0]
    assert passes[got].all() and not np.isin(got, victims).any()
    out["iterative_filled"] = float((ids >= 0).mean())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ivf.save(tmp)
        back = IvfFlatIndex.load(tmp, device=dev)
        out["save_load_s"] = time.perf_counter() - t0
    d1, i1 = ivf.search(queries, k=10, probes=8)
    d2, i2 = back.search(queries, k=10, probes=8)
    assert np.array_equal(i1, i2) and np.array_equal(d1, d2), "save/load"
    print(f"IVF add {N_ADD} rows {out['add_s']:.3f} s (found), delete "
          f"{N_DELETE} {out['delete_s']:.3f} s (gone), filtered "
          f"search_iterative {out['iterative_s']:.3f} s "
          f"({out['iterative_filled']:.4f} filled, every id passes), "
          f"save+load {out['save_load_s']:.3f} s: identical ids and "
          f"distances [{card}]", flush=True)
    return out


def partition_modes(base: np.ndarray, queries: np.ndarray, gt: np.ndarray,
                    card: str, dev: torch.device) -> dict:
    """PartitionedHnswIndex on the 1M x 128 rows at a smaller depth:
    centroid routing (route_k 2, 5% multi-assign replicas, block engine):
    recall and no duplicate id in a row; adds found, deletes gone, compact,
    a filtered search_iterative, save/load; then the graph engine over 4
    hash partitions of the first 200,000 rows. Launch counters are reset
    by the caller."""
    out = {}
    cfg = HnswConfig(dim=DIM, m=16, ef_construction=64, seed=0)
    qdev = torch.from_numpy(queries).to(dev)
    t0 = time.perf_counter()
    pidx = PartitionedHnswIndex(cfg, D_PARTS, router="centroid", route_k=2,
                                multi_assign_frac=0.05, engine="block",
                                block_size=BLOCK, device=dev).build(base)
    torch.cuda.synchronize()
    out["centroid_build_s"] = time.perf_counter() - t0
    out["replicas"] = int((pidx._replica_part >= 0).sum())
    out["part_rows"] = [pidx._part_rows(p) for p in range(D_PARTS)]

    def no_dups(ids):
        for row in ids:
            live = row[row >= 0]
            assert len(np.unique(live)) == len(live), "a duplicate id"

    _, ids = pidx.search(queries, k=10, ef_search=40)
    no_dups(ids)
    out["centroid_recall"] = recall_at_k(ids, gt, 10)
    _, dids = pidx.search_device(qdev, k=10, ef_search=40)
    dids = dids.cpu().numpy()
    no_dups(dids)
    out["centroid_all_parts_recall"] = recall_at_k(dids, gt, 10)
    print(f"centroid partitions ({D_PARTS}, route_k 2, "
          f"{out['replicas']} replicas, rows {out['part_rows']}): build "
          f"{out['centroid_build_s']:.3f} s; recall@10 at ef 40 "
          f"{out['centroid_recall']:.4f} routed, "
          f"{out['centroid_all_parts_recall']:.4f} over every partition "
          f"(search_device); no duplicate id in a row [{card}]", flush=True)
    rng = np.random.default_rng(23)
    extra = (base[rng.integers(0, N, N_ADD)]
             + rng.normal(0.0, 0.5, size=(N_ADD, DIM))).astype(np.float32)
    t0 = time.perf_counter()
    gids = pidx.add(extra)
    out["add_s"] = time.perf_counter() - t0
    assert (gids == np.arange(N, N + N_ADD)).all()
    _, ids = pidx.search(extra[:256], k=1, ef_search=40)
    assert (ids[:, 0] == gids[:256]).all(), "an added row is not found"
    replicated = np.where(pidx._replica_part >= 0)[0]
    victims = np.concatenate([replicated[:N_DELETE // 2], rng.choice(
        N + N_ADD, N_DELETE - N_DELETE // 2, replace=False)])
    t0 = time.perf_counter()
    pidx.delete(victims)
    out["delete_s"] = time.perf_counter() - t0
    for search in (lambda: pidx.search(queries, k=10, ef_search=40)[1],
                   lambda: pidx.search_device(qdev, k=10)[1].cpu().numpy()):
        assert not np.isin(search(), victims).any(), "a deleted id came back"
    t0 = time.perf_counter()
    pidx.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    # the added rows now live in blocks: every block of every partition
    alive = ~np.isin(gids[:256], victims)
    ids = pidx.search_device(extra[:256], k=1, probes=1 << 30)[1]
    assert (ids.cpu().numpy()[alive, 0] == gids[:256][alive]).all(), \
        "lost by compact"
    _, ids = pidx.search(queries, k=10, ef_search=40)
    no_dups(ids)
    assert not np.isin(ids, victims).any()
    out["recall_after_compact"] = recall_at_k(ids, gt, 10)
    passes = np.random.default_rng(FILTER_SEED + 3).random(N + N_ADD) \
        < FILTER_SHARE
    t0 = time.perf_counter()
    _, ids = pidx.search_iterative(queries[:CHUNK], k=10, ef_search=40,
                                   predicate=lambda i: passes[i])
    out["iterative_s"] = time.perf_counter() - t0
    got = ids[ids >= 0]
    assert passes[got].all() and not np.isin(got, victims).any()
    out["iterative_filled"] = float((ids >= 0).mean())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pidx.save(tmp)
        back = PartitionedHnswIndex.load(tmp, device=dev)
        out["save_load_s"] = time.perf_counter() - t0
    d1, i1 = pidx.search(queries, k=10, ef_search=40)
    d2, i2 = back.search(queries, k=10, ef_search=40)
    assert np.array_equal(i1, i2) and np.array_equal(d1, d2), "save/load"
    print(f"centroid partitions: add {N_ADD} {out['add_s']:.3f} s (found), "
          f"delete {N_DELETE} ({N_DELETE // 2} replicated) "
          f"{out['delete_s']:.3f} s (gone), compact {out['compact_s']:.3f} "
          f"s (recall@10 {out['recall_after_compact']:.4f}), filtered "
          f"search_iterative {out['iterative_s']:.3f} s "
          f"({out['iterative_filled']:.4f} filled, every id passes), "
          f"save+load {out['save_load_s']:.3f} s: identical ids and "
          f"distances [{card}]", flush=True)
    del back
    torch.cuda.empty_cache()

    sub = base[:SUB_GRAPH_N]
    sgt = FlatIndex(sub, Metric.L2, device=dev).search(qdev, k=10,
                                                       exact=True)[1]
    t0 = time.perf_counter()
    gidx = PartitionedHnswIndex(cfg, 4, router="hash", engine="graph",
                                device=dev).build(sub)
    torch.cuda.synchronize()
    out["graph_build_s"] = time.perf_counter() - t0
    kw = dict(ef_search=40, descent_ef=8)
    d, ids = gidx.search(queries, k=10, **kw)
    out["graph_recall"] = recall_at_k(ids, sgt, 10)
    dd, dids = gidx.search_device(qdev, k=10, **kw)
    out["graph_tie_rows"] = same_up_to_ties(d, ids, dd.cpu().numpy(),
                                            dids.cpu().numpy())
    print(f"graph-engine partitions (4 hash over {SUB_GRAPH_N} rows): build "
          f"{out['graph_build_s']:.3f} s, recall@10 {out['graph_recall']:.4f}"
          f" at {json.dumps(kw)}; search_device ids equal search's but for "
          f"the order of equal distances in {out['graph_tie_rows']} rows "
          f"[{card}]", flush=True)
    out["stacked"] = stacked_modes(pidx, gidx, queries, qdev, card)
    return out


def same_up_to_ties(dh, ih, dd, idd, rtol: float = 0.0) -> int:
    """The host loop's numpy merge (the reference's unstable np.argsort)
    against the device merge (lax.top_k's order): the same distances, and
    the same ids wherever a distance is not tied with another candidate's
    (a tie at the k-th place may keep either row). With ``rtol`` two
    distances count as equal within rtol of the row's largest finite
    magnitude (f32 rounding of a product batched differently). Returns the
    rows that differ."""
    assert np.array_equal(np.isinf(dh), np.isinf(dd)), "missing results"
    fin = np.isfinite(dh)
    tol = rtol * np.maximum(np.abs(np.where(fin, dh, 0)).max(1), 1.0)
    diff = np.where(fin, np.abs(dh - np.where(fin, dd, 0)), 0)
    assert (diff <= tol[:, None]).all(), \
        f"host loop and device distances differ by {diff.max()}"
    rows = 0
    for r in np.where((ih != idd).any(1))[0]:
        rows += 1
        with np.errstate(invalid="ignore"):  # inf - inf
            near = (dh[r][:, None] == dh[r][None, :]) | (
                np.abs(dh[r][:, None] - dh[r][None, :]) <= tol[r])
        for c in np.where(ih[r] != idd[r])[0]:
            tied = near[c].sum() > 1 or near[c, -1]
            assert tied, "an id with an untied distance differs"
    return rows


def config_d_data():
    """scripts/config_d.py:35-56: the DEEP-10M-shaped rows and queries,
    L2-normalised (DEEP's 96-d vectors are near unit norm)."""
    base, queries = synthetic_clustered(D_N, D_DIM, n_queries=D_NQ,
                                        seed=D_SEED)
    base /= np.maximum(np.linalg.norm(base, axis=1, keepdims=True), 1e-12)
    queries /= np.maximum(np.linalg.norm(queries, axis=1, keepdims=True),
                          1e-12)
    return base, queries


def config_d_phase(card: str, dev: torch.device, data) -> dict:
    """Config D at full width: 10M x 96 inner product over 8 hash
    partitions of BlockHnswIndex (block 256) on one card. The oracle over
    all 10M rows; expand_topr at d=96 IP held to its plain version before
    anything is timed; then the path itself with its launch counters set
    to 0: build, recall@10 over the probe grid to the first point >= 0.95,
    QPS there through measure_qps (1024-query chunks), launches per chunk,
    a profiled chunk, host-loop ids against search_device's, peak
    memory. ``data``: ``HostData.take("config_d")``."""
    out = {}
    (base, queries), out["data_s"] = data
    qdev = torch.from_numpy(queries).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    oracle = FlatIndex(base, Metric.IP, device=dev)
    gt = np.concatenate([oracle.search(qdev[s:s + CHUNK], k=10,
                                       exact=True)[1]
                         for s in range(0, D_NQ, CHUNK)])
    out["oracle_s"] = time.perf_counter() - t0
    print(f"config D data {base.shape} in {out['data_s']:.1f} s; exact "
          f"oracle over {D_N} rows, {D_NQ} queries in {CHUNK}-query chunks: "
          f"{out['oracle_s']:.3f} s [{card}]", flush=True)
    out["flat_int8"] = int8_scan_timing(oracle, qdev[:NQ], gt[:NQ], card,
                                        f"config D {D_N} x {D_DIM} IP")
    del oracle
    torch.cuda.empty_cache()

    cfg = HnswConfig(dim=D_DIM, metric=Metric.IP, m=16, ef_construction=64,
                     seed=0)
    t0 = time.perf_counter()
    pidx = PartitionedHnswIndex(cfg, D_PARTS, router="hash", engine="block",
                                block_size=BLOCK, device=dev).build(base)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t0
    out["build_vps"] = D_N / out["build_s"]
    out["n_blocks"] = [s.n_blocks for s in pidx.parts]
    print(f"config D build, {D_PARTS} hash partitions: {out['build_s']:.3f} "
          f"s, {out['build_vps']:.1f} vec/s, blocks {out['n_blocks']} "
          f"[{card}]", flush=True)

    # expand_topr at the path's new shape, before anything is timed
    sub, q0 = pidx.parts[0], qdev[:KERNEL_Q]
    args, kw = routed_args(sub, q0, 8)
    cscale = (args[1].max() + args[4].max()).item()
    topr = topr_variants(args, kw, "int8", card, cscale,
                         "config D partition 0, routed bids")
    reset_expand_counts()  # the comparisons are not the path's

    chosen, curve = None, []
    for p in PROBE_GRID:
        ids = np.concatenate([pidx.search_device(
            qdev[s:s + CHUNK], k=10, probes=p)[1].cpu().numpy()
            for s in range(0, D_NQ, CHUNK)])
        r = recall_at_k(ids, gt, 10)
        curve.append({"probes": p, "recall": r})
        print(f"config D probes {p}: recall@10 {r:.4f} [{card}]", flush=True)
        if r >= TARGET_RECALL:
            chosen = p
            break
    out["curve"] = curve
    assert chosen is not None, \
        f"config D: no probe count reached {TARGET_RECALL}: {curve}"
    out["probes"], out["recall"] = chosen, curve[-1]["recall"]
    assert ((ids >= 0) & (ids < D_N)).all()
    st = {}
    build_peak = peak_gb()
    torch.cuda.reset_peak_memory_stats()
    out["qps"], _ = measure_qps(pidx, queries, 10, 0,
                                pipeline=D_NQ // CHUNK, stats_out=st,
                                probes=chosen)
    out["serve_peak_GB"] = peak_gb()
    out["qps_stats"] = st
    qchunk = qdev[:CHUNK]
    before = X.TOPR_LAUNCHES
    d, i = pidx.search_device(qchunk, k=10, probes=chosen)
    out["topr_launches_per_chunk"] = X.TOPR_LAUNCHES - before
    assert out["topr_launches_per_chunk"] == D_PARTS, out
    # distances are inner products of the returned rows
    ids0 = i.cpu().numpy()
    want = -(queries[:CHUNK, None, :] * base[ids0]).sum(-1)
    assert np.abs(d.cpu().numpy() - want).max() <= \
        2 * D_DIM * float(np.finfo(np.float32).eps)  # unit rows
    print(f"config D QPS {out['qps']:.1f} at probes {chosen} (recall@10 "
          f"{out['recall']:.4f}; {CHUNK}-query chunks, cv {st['qps_cv']}, "
          f"min {st['qps_min']}, max {st['qps_max']}); expand_topr "
          f"launches per chunk {out['topr_launches_per_chunk']} [{card}]",
          flush=True)
    out["breakdown"] = device_breakdown(
        lambda: pidx.search_device(qchunk, k=10, probes=chosen), card,
        f"config D, one {CHUNK}-query search_device chunk (8 partitions and "
        f"the merge)")
    dh, ih = pidx.search(queries[:CHUNK], k=10, ef_search=40)
    dd, idd = pidx.search_device(qchunk, k=10, ef_search=40)
    out["host_loop_tie_rows"] = same_up_to_ties(dh, ih, dd.cpu().numpy(),
                                                idd.cpu().numpy())
    out["launches"] = expand_launches()
    out["peak_mem_GB"] = max(build_peak, peak_gb())
    print(f"config D: host-loop search ids equal search_device's on "
          f"{CHUNK} queries (ef 40) but for the order of equal distances in "
          f"{out['host_loop_tie_rows']} rows; peak device memory "
          f"{out['peak_mem_GB']:.2f} GB [{card}]", flush=True)
    out["timing"] = routed_timing(sub, q0, chosen, 40, card,
                                  "config D partition 0 (10M x 96 IP), "
                                  "routed bids")
    out["topr_d96"] = topr
    # the same index served through the stacked searcher, in this call
    out["stacked"] = config_d_stacked(pidx, queries, qdev, gt, out, card)
    return out


#: distances of the stacked searcher against the host loop: equal within this
#: share of a row's largest magnitude (its rerank batches the f32 products of
#: every partition into one call)
STACKED_RTOL = 1e-6


def stacked_args(sh, q, probes: int):
    """Stage 1's operands as a stacked search makes them (the int8 copy
    with its scales, or the bf16 one): the ``[P*b, S, dp]`` stacked table,
    ``Q*P`` virtual queries (query-major) and the block ids the stacked
    routing gives them at ``probes``."""
    L, b, S = sh.blocks.shape[:3]
    q_sq = (q * q).sum(1)
    bids = sh._route(q, q_sq, None, probes)
    qv = _pad_cols(q.repeat_interleave(L, 0), sh.blocks_score.shape[3])
    args = (sh.blocks_score.view(L * b, S, -1), sh.blocks_sq.view(L * b, S),
            sh.block_gids.view(L * b, S), qv, q_sq.repeat_interleave(L, 0),
            bids, sh.parent.cfg.metric)
    if sh.score_scales is None:
        return args, {}
    q8, q_scl = _quantize_rows(qv)
    return args, dict(q8=q8, q_scale=q_scl,
                      score_scale=sh.score_scales.view(-1))


def config_d_stacked(pidx, queries: np.ndarray, qdev, gt, host: dict,
                     card: str) -> dict:
    """Config D served through ``pidx.sharded()``: one route GEMM, one
    expand_topr launch and one rerank a chunk for all 8 partitions. Its
    ids against the host loop's search_device (equal up to tied
    distances), ``release_parts_device_state``, then the stacked path with
    its launch counters set to 0: recall@10 over the probe grid to the
    first point >= 0.95, QPS through measure_qps, launches a chunk, a
    profiled chunk and the serving peak, beside the host loop's from this
    call. Then (not counted) expand_topr at the stacked shape held to its
    plain version and timed."""
    out = {}
    probes, qchunk = host["probes"], qdev[:CHUNK]
    hd, hi = pidx.search_device(qchunk, k=10, probes=probes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sh = pidx.sharded()
    torch.cuda.synchronize()
    out["assemble_s"] = time.perf_counter() - t0
    out["state_GB"] = sh.stats()["memory_total_bytes"] / 1e9
    reset_expand_counts()
    d, ids = sh.search(qchunk, k=10, probes=probes)
    out["host_loop_tie_rows"] = same_up_to_ties(
        hd.cpu().numpy(), hi.cpu().numpy(), d, ids, rtol=STACKED_RTOL)
    out["max_abs_dist_diff"] = float(np.abs(d - hd.cpu().numpy())[
        np.isfinite(d)].max())
    print(f"config D stacked: sharded() in {out['assemble_s']:.3f} s "
          f"({out['state_GB']:.3f} GB stacked); ids equal the host loop's "
          f"search_device on {CHUNK} queries at probes {probes} but for the "
          f"order of equal distances in {out['host_loop_tie_rows']} rows "
          f"(distances within {out['max_abs_dist_diff']:.3g}) [{card}]",
          flush=True)
    sh.release_parts_device_state()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["after_release_GB"] = torch.cuda.memory_allocated() / 1e9
    chosen, curve = None, []
    for p in PROBE_GRID:
        got = np.concatenate([sh.search_device(
            qdev[s:s + CHUNK], k=10, probes=p)[1].cpu().numpy()
            for s in range(0, D_NQ, CHUNK)])
        r = recall_at_k(got, gt, 10)
        curve.append({"probes": p, "recall": r})
        print(f"config D stacked probes {p}: recall@10 {r:.4f} [{card}]",
              flush=True)
        if r >= TARGET_RECALL:
            chosen = p
            break
    out["curve"] = curve
    assert chosen == probes, f"stacked recall curve {curve} against {host}"
    out["probes"], out["recall"] = chosen, curve[-1]["recall"]
    st = {}
    out["qps"], _ = measure_qps(sh, queries, 10, 0, pipeline=D_NQ // CHUNK,
                                stats_out=st, probes=chosen)
    out["qps_stats"] = st
    before = X.TOPR_LAUNCHES
    sh.search_device(qchunk, k=10, probes=chosen)
    out["topr_launches_per_chunk"] = X.TOPR_LAUNCHES - before
    assert out["topr_launches_per_chunk"] == 1, out
    out["breakdown"] = device_breakdown(
        lambda: sh.search_device(qchunk, k=10, probes=chosen), card,
        f"config D stacked, one {CHUNK}-query search_device chunk (8 "
        f"partitions in one batch and the merge)")
    out["launches"] = expand_launches()
    out["serve_peak_GB"] = peak_gb()
    hb, sb = host["breakdown"], out["breakdown"]
    print(f"config D, host loop | stacked, at probes {chosen} [{card}]: "
          f"QPS {host['qps']:.1f} | {out['qps']:.1f} (cv "
          f"{host['qps_stats']['qps_cv']} | {st['qps_cv']}); device busy "
          f"{hb['busy_share']:.1%} | {sb['busy_share']:.1%}; device ops a "
          f"chunk {hb['kernels']} | {sb['kernels']}; host wall a chunk "
          f"{hb['host_wall_ms']:.3f} | {sb['host_wall_ms']:.3f} ms; "
          f"expand_topr launches a chunk {host['topr_launches_per_chunk']} | "
          f"{out['topr_launches_per_chunk']}; serving peak "
          f"{host['serve_peak_GB']:.2f} | {out['serve_peak_GB']:.2f} GB",
          flush=True)

    # expand_topr at the stacked shape, before it is timed (not counted)
    args, kw = stacked_args(sh, qchunk, chosen)
    cscale = (args[1].max() + args[4].max()).item()
    what = (f"config D stacked, {args[5].shape[0]} virtual queries, "
            f"B={args[0].shape[0]}")
    out["topr"] = topr_variants(args, kw, "int8", card, cscale, what,
                                nqs=(args[5].shape[0], RAGGED_Q))
    out["timing"] = stage1_timing(args, kw, 40, card, what)
    reset_expand_counts()
    return out


def stacked_modes(pidx, gidx, queries: np.ndarray, qdev, card: str) -> dict:
    """The stacked searchers on the partitioned-modes indexes: the 8
    compacted centroid partitions through sharded() against the host loop
    over every partition, ring against gather, then save and from_saved
    with slabs of a quarter of a partition: ids equal to the in-memory
    searcher's, and the load's peak device memory within the serving bytes
    plus one slab and the slab's temporaries (one more slab) and 16 MB;
    the 4 graph partitions through ShardedHnswSearcher against the host
    loop."""
    out = {}
    qchunk = qdev[:CHUNK]
    sh = pidx.sharded()
    hd, hi = pidx.search_device(qchunk, k=10, ef_search=40)
    d, ids = sh.search(qchunk, k=10, ef_search=40, route_k=pidx.p)
    out["host_loop_tie_rows"] = same_up_to_ties(
        hd.cpu().numpy(), hi.cpu().numpy(), d, ids, rtol=STACKED_RTOL)
    dr, ir = sh.search(qchunk, k=10, ef_search=40, merge="ring")
    dg, ig = sh.search(qchunk, k=10, ef_search=40)
    assert np.array_equal(ir, ig) and np.array_equal(dr, dg), "ring"
    S, dim = sh.blocks.shape[2], sh.blocks.shape[3]
    slab = max(1, max(s.n_blocks for s in pidx.parts) // 4)
    chunk_bytes = slab * S * dim * 4
    with tempfile.TemporaryDirectory() as tmp:
        pidx.save(tmp)
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ld = ShardedBlockSearcher.from_saved(tmp, chunk_bytes=chunk_bytes)
        torch.cuda.synchronize()
        out["from_saved_s"] = time.perf_counter() - t0
        out["from_saved_peak_MB"] = (torch.cuda.max_memory_allocated()
                                     - base_bytes) / 1e6
    serving = sum(t.numel() * t.element_size() for t in (
        ld.blocks, ld.blocks_score, ld.blocks_sq, ld.block_gids,
        ld.centroids, ld.centroids_sq, ld.score_scales))
    out["serving_MB"], out["slab_MB"] = serving / 1e6, chunk_bytes / 1e6
    out["slabs_per_partition"] = -(-ld.blocks.shape[1] // slab)
    assert out["slabs_per_partition"] >= 4, out
    bound = serving + 2 * chunk_bytes + (16 << 20)
    assert out["from_saved_peak_MB"] * 1e6 <= bound, out
    d0, i0 = sh.search(qchunk, k=10, ef_search=40)
    d1, i1 = ld.search(qchunk, k=10, ef_search=40)
    assert np.array_equal(i0, i1), "from_saved ids differ from in memory"
    out["from_saved_max_dist_diff"] = float(np.abs(d0 - d1)[
        np.isfinite(d0)].max())
    print(f"centroid partitions stacked: ids equal the host loop's over "
          f"every partition but for the order of equal distances in "
          f"{out['host_loop_tie_rows']} rows; ring equals gather; "
          f"from_saved ({out['slabs_per_partition']} slabs of "
          f"{out['slab_MB']:.1f} MB a partition) in {out['from_saved_s']:.3f}"
          f" s, ids equal the in-memory searcher's (distances within "
          f"{out['from_saved_max_dist_diff']:.3g}), peak "
          f"{out['from_saved_peak_MB']:.1f} MB over {out['serving_MB']:.1f} "
          f"MB of serving state (bound: + 2 slabs + 16 MB) [{card}]",
          flush=True)
    del sh, ld
    torch.cuda.empty_cache()
    kw = dict(ef_search=40, descent_ef=8)
    gsh = gidx.sharded()
    dh, ih = gidx.search(queries[:CHUNK], k=10, **kw)
    dg, ig = gsh.search(queries[:CHUNK], k=10, **kw)
    out["graph_tie_rows"] = same_up_to_ties(dh, ih, dg, ig,
                                            rtol=STACKED_RTOL)
    print(f"graph partitions through ShardedHnswSearcher ({json.dumps(kw)}): "
          f"ids equal the host loop's but for the order of equal distances "
          f"in {out['graph_tie_rows']} rows [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# config E: one card's share of LAION-100M (scripts/config_e_12m5.py)
# ---------------------------------------------------------------------------

#: 100M x 512 bf16 cosine (BASELINE.json config E) over four cards is 25M
#: rows a card, served here as eight hash partitions of the reference's own
#: shape: 3.125M rows, S 128, slack 1.10, 26,856 blocks each
E_PARTS, E_SHARD, E_DIM = 8, 3_125_000, 512
E_N = E_PARTS * E_SHARD
E_BLOCK, E_SLACK, E_RERANK = 128, 1.10, 128
E_CENTRES, E_NQ, E_CHUNK = 8192, 512, 256
E_SLAB = 312_500            # rows made at a time (the reference's slab)
E_LOAD_CHUNK = 1 << 27      # from_saved's slab, bytes as f32 (its default)
#: probes a partition: the reference's sweep (its probes_for_ef(16/32/64)
#: with its loader's default slack, 1.05; the port's loader reads the
#: saved 1.10 and maps those efs one probe higher), doubled up to
#: E_PROBES_MAX while no point reaches TARGET_RECALL
E_PROBES, E_PROBES_MAX = (8, 17, 34), 136
#: benchmarks/config_e_12m5.json: the reference's recall@10 over its own
#: 12.5M rows of this recipe (a TPU run; other draws, so a comparison)
E_REFERENCE_RECALL = {8: 0.9451, 17: 0.9537, 34: 0.9596}
#: returned cosine distances against 1 - q.x from the stored bf16 rows: both
#: are f32 sums over the same rows and unit query, so they differ by f32
#: rounding (d * eps, twice for the query's renormalisation), far inside
#: the bf16 rounding of a row (2^-8)
E_DIST_TOL = 2 * E_DIM * float(np.finfo(np.float32).eps)
#: stage 1's operation classes in a profiled chunk (device_breakdown); the
#: rest as the flat scans' classes (the route GEMM, its top-k, copies such
#: as the centroids' f32 upcast)
E_CLASSES = {"stage1": ("group_kernel", "grouped_kernel", "merge_kernel",
                        "stage_kernel", "select_kernel"), **SCAN_CLASSES}


def e_rows(g: torch.Generator, centres: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` rows of the reference's recipe (scripts/config_e_12m5.py:62-72)
    made on the card from ``g``, ``E_SLAB`` at a time: ``4 * centre[a] +
    N(0, 1)`` with ``a`` uniform, unit-normalised, cast to bf16."""
    dev = centres.device
    out = torch.empty((n, centres.shape[1]), dtype=torch.bfloat16,
                      device=dev)
    for s in range(0, n, E_SLAB):
        m = min(E_SLAB, n - s)
        a = torch.randint(0, len(centres), (m,), generator=g, device=dev)
        x = torch.randn((m, centres.shape[1]), generator=g, device=dev)
        x.add_(centres[a], alpha=4.0)
        out[s:s + m] = x / x.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return out


def e_part_oracle(idx, q: torch.Tensor):
    """The reference's oracle (scripts/config_e_12m5.py:120-161) over one
    resident part: ``FlatIndex(IP).search(exact=True)`` over the rows read
    back from the index (the f32 upcast of its bf16 blocks, with their
    ids) for unit queries. Returns (distances, local ids) ``[Q, 10]``."""
    flat_ids = idx.block_ids.reshape(-1)
    live = flat_ids >= 0
    oracle = FlatIndex(idx.blocks.reshape(-1, idx.cfg.dim)[live], Metric.IP,
                       dtype=torch.float32, device=idx.device)
    d, pos = oracle.search_device(q, k=10, exact=True)
    return d, flat_ids[live][pos].long()


def e_build_parts(path: str, centres, q, card: str) -> tuple:
    """Build, grade, save and free the parts one at a time, as the
    reference does (scripts/config_e_12m5.py:100-196): each part from its
    own generator on the card, its exact top-10 while it is resident, its
    directory and global ids; then the merged oracle (the keyed top-10 of
    the parts' 80 candidates, ties to the lower global id),
    ``partitioned.json`` and ``router.npz``. Returns (oracle ids, one
    record a part)."""
    cfg = HnswConfig(dim=E_DIM, metric=Metric.COSINE, m=16,
                     ef_construction=64, dtype="bfloat16", seed=0)
    g = torch.Generator(device=q.device)
    gt_d, gt_i, parts = [], [], []
    for p in range(E_PARTS):
        rec = {"part": p}
        t0 = time.perf_counter()
        corpus = e_rows(g.manual_seed(1 + p * 1000), centres, E_SHARD)
        torch.cuda.synchronize()
        rec["gen_s"] = time.perf_counter() - t0
        idx = BlockHnswIndex(cfg, block_size=E_BLOCK, block_slack=E_SLACK,
                             device=q.device)
        idx.score_dtype = "bf16"
        t0 = time.perf_counter()
        idx.build(corpus)
        torch.cuda.synchronize()
        rec["build_s"] = time.perf_counter() - t0
        del corpus
        assert idx.blocks_score is idx.blocks, "bf16 scoring must alias"
        rec["n_blocks"], rec["build_stats"] = idx.n_blocks, idx.build_stats
        t0 = time.perf_counter()
        d, ids = e_part_oracle(idx, q)
        torch.cuda.synchronize()
        rec["oracle_s"] = time.perf_counter() - t0
        gt_d.append(d)
        gt_i.append(ids + p * E_SHARD)
        t0 = time.perf_counter()
        part = os.path.join(path, f"part{p}")
        idx.save(part)
        np.save(os.path.join(part, "global_ids.npy"),
                np.arange(idx.n_total, dtype=np.int32) + p * E_SHARD)
        rec["save_s"] = time.perf_counter() - t0
        rec["peak_GB"] = peak_gb()
        print(f"config E part {p}: {E_SHARD} x {E_DIM} bf16 made in "
              f"{rec['gen_s']:.3f} s, built in {rec['build_s']:.3f} s "
              f"({rec['n_blocks']} blocks; build_stats "
              f"{json.dumps(rec['build_stats'])}), oracle "
              f"{rec['oracle_s']:.3f} s, saved in {rec['save_s']:.3f} s; "
              f"peak {rec['peak_GB']:.2f} GB [{card}]", flush=True)
        parts.append(rec)
        del idx, d, ids
        torch.cuda.empty_cache()
    gd, gi = torch.cat(gt_d, 1), torch.cat(gt_i, 1)
    order = torch.argsort(gi, dim=1)  # the keyed top-k: ties to the lower id
    gd, gi = gd.gather(1, order), gi.gather(1, order)
    gt = gi.gather(1, T.topk_smallest_by_index(gd, 10)[1]).cpu().numpy()
    with open(os.path.join(path, "partitioned.json"), "w") as f:
        json.dump({"p": E_PARTS, "router": "hash", "route_k": 0, "n": E_N,
                   "engine": "block", "block_size": E_BLOCK}, f)
    np.savez(os.path.join(path, "router.npz"), centroids=np.zeros(0),
             part_of=np.zeros(0, np.int32), local_of=np.zeros(0, np.int32))
    return gt, parts


def e_disk_need() -> int:
    """Bytes the saved parts take: each part's raw bf16 blocks, its block
    ids and slot map, and its global ids."""
    B = math.ceil(E_SHARD * E_SLACK / E_BLOCK)
    return E_PARTS * (B * E_BLOCK * (E_DIM * 2 + 4) + E_SHARD * (8 + 4))


def e_load(path: str, card: str) -> tuple:
    """``ShardedBlockSearcher.from_saved`` of the saved parts with its
    bounded-memory check: the peak above what was allocated before the
    load is at most the serving bytes plus two slabs and 16 MB. Returns
    (searcher, numbers)."""
    out = {}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sh = ShardedBlockSearcher.from_saved(path, chunk_bytes=E_LOAD_CHUNK)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["max_memory_allocated_GB"] = torch.cuda.max_memory_allocated() / 1e9
    out["load_peak_above_GB"] = (torch.cuda.max_memory_allocated()
                                 - before) / 1e9
    assert sh.blocks_score is sh.blocks, "bf16 scoring must alias"
    out["stats"] = sh.stats()
    out["stacked_bytes"] = sh.blocks.numel() * sh.blocks.element_size()
    assert out["stacked_bytes"] > 2 ** 32, out
    serving = out["stats"]["memory_total_bytes"]
    bound = serving + 2 * E_LOAD_CHUNK + (16 << 20)
    out["load_bound_GB"] = bound / 1e9
    assert out["load_peak_above_GB"] * 1e9 <= bound, out
    assert out["max_memory_allocated_GB"] < 80, out
    files = sum(os.path.getsize(os.path.join(dp, f))
                for dp, _, fs in os.walk(path) for f in fs)
    out["files_GB"] = files / 1e9
    out["read_GBps"] = out["files_GB"] / out["load_s"]
    print(f"config E from_saved: {E_PARTS} parts, {out['files_GB']:.3f} GB "
          f"of files in {out['load_s']:.3f} s ({out['read_GBps']:.3f} GB/s); "
          f"stacked blocks {out['stacked_bytes']} bytes (> 2^32), "
          f"blocks_score is blocks; peak {out['load_peak_above_GB']:.3f} GB "
          f"above the {before / 1e9:.3f} GB before it (bound: serving "
          f"{serving / 1e9:.3f} GB + 2 slabs of {E_LOAD_CHUNK / 1e9:.3f} GB "
          f"+ 16 MB), max_memory_allocated "
          f"{out['max_memory_allocated_GB']:.3f} GB; stats "
          f"{json.dumps(out['stats'])} [{card}]", flush=True)
    return sh, out


def e_check_results(sh, queries: np.ndarray, d: np.ndarray,
                    ids: np.ndarray) -> float:
    """Ids distinct in each row and in [0, E_N); distances equal to 1 - q.x
    from the stored rows within E_DIST_TOL. Returns the largest gap."""
    assert ((ids >= 0) & (ids < E_N)).all(), "ids outside [0, 25M)"
    srt = np.sort(ids, axis=1)
    assert (srt[:, 1:] != srt[:, :-1]).all(), "an id repeats in a row"
    dev = sh.device
    flat = sh.block_gids.view(-1)
    live = torch.nonzero(flat >= 0)[:, 0]
    slot = torch.full((E_N,), -1, dtype=torch.int64, device=dev)
    slot[flat[live].long()] = live
    x = sh.blocks.view(-1, E_DIM)[slot[torch.from_numpy(ids).to(dev)]]
    q = torch.from_numpy(queries).to(dev)
    want = 1.0 - (x.float() @ q[:, :, None])[..., 0]
    gap = float((torch.from_numpy(d).to(dev) - want).abs().max())
    assert gap <= E_DIST_TOL, (gap, E_DIST_TOL)
    return gap


def e_sweep(sh, queries: np.ndarray, gt: np.ndarray, card: str) -> dict:
    """Recall@10, QPS (measure_qps over the queries in E_CHUNK-query
    chunks) and the checked results at the reference's probe counts,
    doubling past them up to E_PROBES_MAX while none reaches
    TARGET_RECALL; exactly one expand_topr launch a chunk."""
    out = {"probes_for_ef": {ef: sh.probes_for_ef(ef) for ef in (16, 32, 64)},
           "curve": []}
    print(f"config E probes_for_ef(16/32/64): "
          f"{list(out['probes_for_ef'].values())}, beside the reference's "
          f"probes {list(E_PROBES)} [{card}]", flush=True)
    probes = list(E_PROBES)
    while probes:
        p = probes.pop(0)
        st = {}
        before = X.TOPR_LAUNCHES
        qps, ids = measure_qps(sh, queries, 10, 0, pipeline=E_NQ // E_CHUNK,
                               stats_out=st, probes=p)
        passes = 2 + st["windows"] * st["window_passes"]
        launches = X.TOPR_LAUNCHES - before
        assert launches == passes * (E_NQ // E_CHUNK), (launches, passes)
        d, got = zip(*(sh.search(queries[s:s + E_CHUNK], k=10, probes=p)
                       for s in range(0, E_NQ, E_CHUNK)))
        d, got = np.concatenate(d), np.concatenate(got)
        assert np.array_equal(got, ids), "measured ids differ from search's"
        row = {"probes": p, "recall": recall_at_k(ids, gt, 10), "qps": qps,
               "qps_stats": st, "topr_launches_per_chunk": launches // (
                   passes * (E_NQ // E_CHUNK)),
               "max_dist_gap": e_check_results(sh, queries, d, ids),
               "reference_recall": E_REFERENCE_RECALL.get(p)}
        out["curve"].append(row)
        print(f"config E probes {p} a partition: recall@10 "
              f"{row['recall']:.4f} (reference {row['reference_recall']}), "
              f"QPS {qps:.1f} ({E_CHUNK}-query chunks, cv {st['qps_cv']}, "
              f"min {st['qps_min']}, max {st['qps_max']}); expand_topr "
              f"launches a chunk {row['topr_launches_per_chunk']}; ids "
              f"distinct and in range, distances within "
              f"{row['max_dist_gap']:.3g} of 1 - q.x [{card}]", flush=True)
        if (not probes and 2 * p <= E_PROBES_MAX
                and max(r["recall"] for r in out["curve"]) < TARGET_RECALL):
            probes.append(2 * p)
    ok = [r for r in out["curve"] if r["recall"] >= TARGET_RECALL]
    assert ok, f"config E: no probe count reached {TARGET_RECALL}"
    out["chosen"] = ok[0]["probes"]
    return out


def e_kernel_checks(sh, qchunk, chosen: int, card: str) -> tuple:
    """expand_topr in bf16 at the stacked shape (E_CHUNK queries, so
    E_CHUNK * E_PARTS virtual queries, r = E_RERANK) against its plain
    version within RTOL: at the routed bids of p = 17 and of p = 8 (both
    routes), and at p = 17 bids drawn from the top quarter of the stacked
    table (every read past 2^32 bytes); each then timed (stage1_timing,
    both routes in turns where both apply). Not counted."""
    topr, timings = [], []
    for p, past in ((17, False), (17, True), (8, False)):
        args, kw = stacked_args(sh, qchunk, p)
        nb = args[0].shape[0]
        if past:
            first = 3 * nb // 4
            assert first * args[0][0].numel() * args[0].element_size() \
                > 2 ** 32
            bids = first + torch.rand((args[5].shape[0], nb - first),
                                      device=qchunk.device).argsort(1)[:, :p]
            args = (*args[:5], bids, args[6])
        what = (f"config E stacked, {args[5].shape[0]} virtual queries, "
                f"B={nb}, p={p}, "
                + ("bids in the top quarter (past 2^32 bytes)" if past
                   else "routed bids"))
        cscale = (args[1].max() + args[4].max()).item()
        topr.extend(topr_variants(args, kw, "bfloat16", card, cscale, what,
                                  rs=(E_RERANK,), nqs=(args[5].shape[0],)))
        timings.append(stage1_timing(args, kw, E_RERANK, card, what))
        del args, kw
    return topr, timings


def config_e_phase(card: str, dev: torch.device) -> dict:
    """Config E's per-card shard at full width: 25M x 512 bf16 cosine, one
    card's quarter of LAION-100M, as eight hash partitions of the
    reference's 3.125M-row shape, built, graded against the exact oracle,
    saved and freed one at a time into a temporary directory (which must
    hold e_disk_need() bytes, or the phase raises), then loaded by
    ``ShardedBlockSearcher.from_saved`` with the bf16 scoring copy aliasing
    the blocks, ``rerank_width`` 128. With the launch counters at 0: the
    sweep (e_sweep) and a profiled chunk at its operating point. Then, not
    counted, expand_topr at the stacked shape (e_kernel_checks)."""
    import shutil

    out = {}
    g = torch.Generator(device=dev)
    centres = torch.randn((E_CENTRES, E_DIM), generator=g.manual_seed(0),
                          device=dev)
    q = e_rows(g.manual_seed(1000), centres, E_NQ).float()
    q += 0.05 * torch.randn(q.shape, generator=g.manual_seed(999),
                            device=dev)
    q /= q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    queries = q.cpu().numpy()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_config_e_") as tmp:
        usage = shutil.disk_usage(tmp)
        out["disk"] = {"total_GB": usage.total / 1e9,
                       "free_GB": usage.free / 1e9,
                       "need_GB": e_disk_need() / 1e9}
        print(f"config E disk at {tmp}: {json.dumps(out['disk'])} "
              f"[{card}]", flush=True)
        if usage.free < e_disk_need():
            raise RuntimeError(f"config E needs {e_disk_need()} bytes of "
                               f"disk, {usage.free} are free")
        t0 = time.perf_counter()
        gt, out["parts"] = e_build_parts(tmp, centres, q, card)
        out["build_grade_save_s"] = time.perf_counter() - t0
        out["build_peak_GB"] = peak_gb()
        del centres, q
        torch.cuda.empty_cache()
        sh, out["load"] = e_load(tmp, card)
    sh.rerank_width = E_RERANK
    reset_expand_counts()
    out["sweep"] = e_sweep(sh, queries, gt, card)
    chosen = out["sweep"]["chosen"]
    qchunk = torch.from_numpy(queries[:E_CHUNK]).to(dev)
    out["breakdown"] = device_breakdown(
        lambda: sh.search_device(qchunk, k=10, probes=chosen), card,
        f"config E stacked, one {E_CHUNK}-query search_device chunk at "
        f"probes {chosen} (8 partitions in one batch and the merge)",
        classes=E_CLASSES)
    out["launches"] = expand_launches()
    out["topr"], out["timings"] = e_kernel_checks(sh, qchunk, chosen, card)
    reset_expand_counts()
    out["serve_peak_GB"] = peak_gb()
    del sh, qchunk
    torch.cuda.empty_cache()
    return out


def collectives_phase(card: str, dev: torch.device) -> dict:
    """The three merges of parallel/collectives.py under a one-rank NCCL
    group (a file rendezvous on the loopback device), each equal to the
    local merge on tie-heavy lists with replica ids, with and without
    dedup; the gather's ms beside the local merge's."""
    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 40, size=(CHUNK, 80))).to(dev)
    of_id = torch.from_numpy(rng.integers(0, 6, size=(CHUNK, 40)).astype(
        np.float32)).to(dev)
    d = torch.gather(of_id, 1, ids)
    d[:, -5:], ids[:, -5:] = torch.inf, -1
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=120))
        try:
            world = dist.group.WORLD
            for dedup in (False, True):
                want = C.gather_merge_topk(d, ids, 10, None, dedup=dedup)
                for name, got in (
                        ("gather", C.gather_merge_topk(d, ids, 10, world,
                                                       dedup=dedup)),
                        ("ring", C.ring_merge_topk(d, ids, 10, world,
                                                   dedup=dedup)),
                        ("hierarchical", C.hierarchical_merge_topk(
                            d, ids, 10, world, world, dedup=dedup))):
                    assert torch.equal(got[0], want[0]) and torch.equal(
                        got[1], want[1]), (name, dedup)
            out["gather_ms"] = cuda_ms(lambda: C.gather_merge_topk(
                d, ids, 10, world, dedup=True), 20)
            out["local_ms"] = cuda_ms(lambda: C.gather_merge_topk(
                d, ids, 10, None, dedup=True), 20)
        finally:
            dist.destroy_process_group()
    print(f"collectives under a one-rank NCCL group: gather, ring and "
          f"hierarchical merges of [{CHUNK}, 80] candidates equal the local "
          f"merge, with and without dedup; gather {out['gather_ms']:.4f} ms "
          f"against {out['local_ms']:.4f} ms local [{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# sparse vectors: the 1M SPLADE-shaped cell
# ---------------------------------------------------------------------------

SP_N, SP_VOCAB, SP_NNZ, SP_NQ, SP_SEED = 1_000_000, 30522, 128, 1024, 13
SP_RERANK = (50, 100, 200)  # scripts/config_sparse.py:91-108
# benchmarks/config_sparse.json: the reference's recall@10 at each rerank_k
# (its projections ran at the TPU's default einsum precision)
SP_REFERENCE_RECALL = {50: 0.3941, 100: 0.5073, 200: 0.6160}
SP_SUB_N = 100_000  # the depth cut of the engine and lifecycle checks
SP_ADD = 1000


def sparse_exact_ip(base, queries, ids: np.ndarray):
    """(exact inner products in float64, the sum of |products|) of each
    query with its returned ids, from the original coordinates on the
    host: independent of the index's rank space, store and rerank."""
    qd = np.zeros((queries.n, queries.dim), np.float64)
    rows = np.repeat(np.arange(queries.n), queries.nnz_max)
    ok = queries.indices.ravel() >= 0
    qd[rows[ok], queries.indices.ravel()[ok]] = queries.values.ravel()[ok]
    ci = base.indices[np.clip(ids, 0, None)]          # [Q, k, K]
    cv = base.values[np.clip(ids, 0, None)].astype(np.float64)
    g = qd[np.arange(queries.n)[:, None, None], np.clip(ci, 0, None)]
    g = np.where(ci >= 0, g, 0.0)
    return (g * cv).sum(-1), np.abs(g * cv).sum(-1)


def sparse_distances_exact(d, ids, base, queries, what: str) -> float:
    """Returned IP distances (``<#>``, the negative inner product) against
    the float64 products of sparse_exact_ip: f32 sums of 128 products stay
    within 1e-5 of the sum of |products|. Returns the largest error."""
    ip, mag = sparse_exact_ip(base, queries, ids)
    assert (ids >= 0).all(), f"{what}: a missing id"
    err = np.abs(d.astype(np.float64) + ip)
    assert (err <= 1e-5 * mag + 1e-6).all(), \
        f"{what}: distances differ from the exact products by {err.max()}"
    return float(err.max())


def sparse_phase(card: str, dev: torch.device, data) -> dict:
    """The sparse cell of scripts/config_sparse.py:25-38,91-108 at full
    width: synthetic_splade(1M, vocab 30522, nnz 128, 1024 queries, seed
    13), SparseHnswIndex(ip, block engine, proj_dim 256, block 256, seed
    0). The exact oracle over all rows, the build by stage, R on the card
    against its CPU rows, both expand entries at the path's shapes against
    their plain versions; then the path with its launch counters set to 0:
    recall@10 and QPS at rerank_k 50, 100 and 200 (host input and output),
    exact distances, peak memory, a profiled call. Then the first 100,000
    rows: the graph engine (IP), the block engine in L2 and cosine, add of
    rows with unseen coordinates, delete, compact and save/load.
    ``data``: ``HostData.take("sparse")``."""
    from tpu_hnsw_torch import SparseFlatIndex, SparseHnswIndex
    from tpu_hnsw_torch.index.sparse_ann import proj_rows

    out = {}
    (base, queries), out["data_s"] = data
    out["observed_vocab"] = int(len(base.vocab))
    print(f"sparse data: {SP_N} x {SP_VOCAB} (nnz {SP_NNZ}), "
          f"{SP_NQ} queries, observed vocabulary {out['observed_vocab']}: "
          f"{out['data_s']:.1f} s (numpy, host) [{card}]", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    flat = SparseFlatIndex(base, Metric.IP, device=dev)
    torch.cuda.synchronize()
    out["oracle_upload_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, gt = flat.search(queries, k=10)
    out["oracle_s"] = time.perf_counter() - t0
    out["oracle_peak_GB"] = peak_gb()
    print(f"sparse oracle SparseFlatIndex(IP) over {SP_N} rows: upload "
          f"{out['oracle_upload_s']:.3f} s, {SP_NQ} queries "
          f"{out['oracle_s']:.3f} s (row chunks densified onto the "
          f"vocabulary, f32 GEMM, running top-k), peak "
          f"{out['oracle_peak_GB']:.2f} GB [{card}]", flush=True)
    del flat
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    idx = SparseHnswIndex(metric="ip", engine="block", proj_dim=256,
                          block_size=256, seed=0, device=dev).build(base)
    out["build"] = dict(idx.build_stats)
    out["build_peak_GB"] = peak_gb()
    st = idx.stats()
    out["store_bytes"] = st["sparse_store_bytes"]
    out["block_bytes"] = st["memory_total_bytes"]
    print(f"sparse build: {json.dumps(out['build'])}, store "
          f"{out['store_bytes'] / 1e9:.3f} GB, blocks "
          f"{out['block_bytes'] / 1e9:.3f} GB, R "
          f"{st['sparse_proj_table_bytes'] / 1e6:.1f} MB, peak "
          f"{out['build_peak_GB']:.2f} GB [{card}]", flush=True)

    # R on the card against the same rows drawn on the CPU
    ranks = torch.arange(0, len(idx._vocab), 7)
    r_err = (idx._R[ranks.to(dev)].cpu()
             - proj_rows(0, ranks, 256)).abs().max().item()
    assert r_err <= 1e-6, f"R on the card differs from the CPU by {r_err}"
    out["R_max_abs_err"] = r_err
    print(f"projection table on the card: {len(idx._vocab)} x 256, every "
          f"7th row within {r_err:.3g} of its CPU rows [{card}]", flush=True)

    # both expand entries at this path's shapes, before the path runs
    inner = idx.inner
    qproj = idx._project(*idx._upload_rows(
        queries, idx._rank_of(queries.indices, extend=False))[:2])
    cscale = (inner.blocks_sq.max() + (qproj * qproj).sum(1).max()).item()
    topr, timings, variants = [], [], []
    probes = {rk: inner.probes_for_ef(max(40, rk)) for rk in SP_RERANK}
    for rk in (50, 100):
        args, kw = routed_args(inner, qproj, probes[rk])
        topr.extend(topr_variants(args, kw, "int8", card, cscale,
                                  f"sparse 1M x 256, routed bids p="
                                  f"{probes[rk]}", rs=(rk,),
                                  nqs=(SP_NQ,)))
        timings.append(stage1_timing(args, kw, rk, card,
                                     f"sparse 1M x 256 index, routed bids "
                                     f"p={probes[rk]}"))
    args, kw = routed_args(inner, qproj, probes[200])
    variants.append(expand_variant(
        args, kw, "int8", Metric.IP, card, cscale,
        shape=dict(Q=SP_NQ, p=probes[200], S=256, d=256,
                   B=inner.n_blocks, of="sparse 1M x 256, routed bids")))
    del args, kw, qproj

    reset_expand_counts()
    curve = []
    for rk in SP_RERANK:
        before = expand_launches()
        d, ids = idx.search(queries, k=10, rerank_k=rk)
        grew = {k: v - before[k] for k, v in expand_launches().items()}
        want = "expand_score" if rk > X.TOPR_MAX_R else "expand_topr"
        assert grew[want] > 0, f"rerank_k {rk} never launched {want}"
        err = sparse_distances_exact(d, ids, base, queries,
                                     f"rerank_k {rk}")
        rec = {"rerank_k": rk, "probes": probes[rk],
               "recall": recall_at_k(ids, gt, 10),
               "reference_recall": SP_REFERENCE_RECALL[rk],
               "launches": grew, "max_dist_err": err}
        idx.search(queries, k=10, rerank_k=rk)  # warm-up
        windows = []
        for _ in range(9):
            t0 = time.perf_counter()
            idx.search(queries, k=10, rerank_k=rk)
            windows.append(SP_NQ / (time.perf_counter() - t0))
        rec["qps"], rec["qps_windows"] = float(np.median(windows)), windows
        curve.append(rec)
        print(f"sparse rerank_k {rk} (probes {probes[rk]}): recall@10 "
              f"{rec['recall']:.4f} (the reference's, from "
              f"benchmarks/config_sparse.json: {rec['reference_recall']}), "
              f"QPS {rec['qps']:.1f} (median of 9 windows of {SP_NQ} "
              f"queries, host in and out; min {min(windows):.1f}, max "
              f"{max(windows):.1f}), launches {json.dumps(grew)}, "
              f"distances exact to {err:.3g} [{card}]", flush=True)
    launches = expand_launches()
    out["curve"] = curve
    out["peak_GB"] = peak_gb()
    print(f"sparse path peak device memory {out['peak_GB']:.2f} GB, "
          f"launches {json.dumps(launches)} [{card}]", flush=True)
    breakdown = device_breakdown(
        lambda: idx.search(queries, k=10, rerank_k=100), card,
        f"sparse path, one {SP_NQ}-query search at rerank_k 100")
    del idx
    torch.cuda.empty_cache()
    out["sub"] = sparse_sub_phase(base, queries, card, dev)
    return {"numbers": out, "launches": launches, "topr": topr,
            "timings": timings, "variants": variants,
            "breakdown": breakdown}


def sparse_sub_phase(base, queries, card: str, dev: torch.device) -> dict:
    """The first SP_SUB_N rows: the graph engine (IP) and the block engine
    in L2 and cosine against their oracles; on the L2 index, add of rows
    with coordinates the index has not seen, delete, compact and
    save/load."""
    from tpu_hnsw_torch import SparseFlatIndex, SparseHnswIndex, SparseVecs

    out = {}
    sub = SparseVecs(base.indices[:SP_SUB_N], base.values[:SP_SUB_N],
                     SP_VOCAB)
    held = SparseVecs(base.indices[SP_SUB_N:SP_SUB_N + SP_ADD],
                      base.values[SP_SUB_N:SP_SUB_N + SP_ADD], SP_VOCAB)
    gts = {m: SparseFlatIndex(sub, Metric(m), device=dev).search(
        queries, k=10) for m in ("ip", "l2", "cosine")}
    indexes = {}
    for engine, metric in (("graph", "ip"), ("block", "l2"),
                           ("block", "cosine")):
        t0 = time.perf_counter()
        ix = SparseHnswIndex(metric=metric, engine=engine, proj_dim=256,
                             seed=0, device=dev).build(sub)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gd, gt = gts[metric]
        d, ids = ix.search(queries, k=10, rerank_k=100)
        ok = ids >= 0
        rec = {"build_s": build_s, "recall": recall_at_k(ids, gt, 10)}
        ip, mag = sparse_exact_ip(sub, queries, ids)
        if metric == "ip":
            want = -ip
        else:
            q_sq = (queries.values.astype(np.float64) ** 2).sum(1)
            c_sq = (sub.values[np.clip(ids, 0, None)].astype(np.float64)
                    ** 2).sum(-1)
            want = (np.sqrt(np.maximum(q_sq[:, None] + c_sq - 2 * ip, 0))
                    if metric == "l2" else
                    1 - ip / np.sqrt(q_sq[:, None] * c_sq))
        err = np.abs(d.astype(np.float64) - want)
        rec["max_dist_err"] = float(err.max())
        assert ok.all() and err.max() <= 1e-3, (engine, metric, rec)
        out[f"{engine}_{metric}"] = rec
        indexes[metric] = ix
        print(f"sparse {engine} {metric} over the first {SP_SUB_N} rows: "
              f"build {build_s:.3f} s, recall@10 {rec['recall']:.4f} at "
              f"rerank_k 100, distances within {err.max():.3g} of the exact "
              f"ones [{card}]", flush=True)
    del indexes["ip"], indexes["cosine"]
    ix = indexes["l2"]

    # add: rows holding coordinates the index has not seen
    fresh = np.setdiff1d(np.arange(SP_VOCAB), ix._vocab)
    assert len(fresh), "every coordinate already seen"
    ai, av = held.indices.copy(), held.values.copy()
    ai[:, 0] = fresh[np.arange(SP_ADD) % len(fresh)]
    order = np.argsort(np.where(ai < 0, SP_VOCAB, ai), axis=1, kind="stable")
    add = SparseVecs(np.take_along_axis(ai, order, 1),
                     np.take_along_axis(av, order, 1), SP_VOCAB)
    V0, R0 = len(ix._vocab), ix._R.clone()
    t0 = time.perf_counter()
    new = ix.add(add)
    out["add_s"] = time.perf_counter() - t0
    assert len(ix._vocab) > V0 and torch.equal(ix._R[:V0], R0), \
        "R is not prefix-stable"
    _, got = ix.search(add, k=1, rerank_k=50)
    out["added_found"] = float((got[:, 0] == new).mean())
    assert out["added_found"] >= 0.99, out["added_found"]
    # delete the queries' best hits, then compact
    _, ids = ix.search(queries, k=10, rerank_k=100)
    victims = np.unique(ids[:, :2])
    t0 = time.perf_counter()
    ix.delete(victims)
    out["delete_s"] = time.perf_counter() - t0
    _, ids = ix.search(queries, k=10, rerank_k=100)
    assert not np.isin(ids, victims).any(), "a deleted id came back"
    t0 = time.perf_counter()
    ix.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    d1, i1 = ix.search(queries, k=10, rerank_k=100)
    assert not np.isin(i1, victims).any(), "a deleted id came back"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ix.save(tmp)
        back = SparseHnswIndex.load(tmp, device=dev)
        out["save_load_s"] = time.perf_counter() - t0
    d2, i2 = back.search(queries, k=10, rerank_k=100)
    assert np.array_equal(i1, i2) and np.array_equal(d1, d2), "save/load"
    print(f"sparse lifecycle (block l2, {SP_SUB_N} rows): add {SP_ADD} rows "
          f"with {len(ix._vocab) - V0} unseen coordinates "
          f"{out['add_s']:.3f} s (R prefix-stable, {out['added_found']:.4f} "
          f"find themselves), delete {len(victims)} {out['delete_s']:.3f} s "
          f"(gone), compact {out['compact_s']:.3f} s (gone), save+load "
          f"{out['save_load_s']:.3f} s: identical ids and distances "
          f"[{card}]", flush=True)
    return out


# ---------------------------------------------------------------------------
# the lockstep build of graph partitions
# ---------------------------------------------------------------------------

MESH_N, MESH_P = 200_000, 8
MESH_BIG_N = 1_000_000


def mesh_wave_breakdowns(rows: np.ndarray, cfg, card: str,
                         dev: torch.device, warm: int = 8192,
                         wave: int = 1024) -> dict:
    """One profiled steady-state wave (``wave`` rows a partition): the
    lockstep step over the 8 partitions beside one sequential wave of one
    partition. Both graphs are first grown to ``warm`` rows; each call of
    the profiled function inserts the next wave."""
    from tpu_hnsw_torch.parallel import mesh_build as MB

    P, per = MESH_P, rows.shape[0] // MESH_P
    plans = [MB._ShardPlan(cfg, rows[p::P][:per]) for p in range(P)]
    g = MB._init_union(cfg, P, per, dev)
    MB._boot(g, cfg, plans, per)
    pos = 1
    while pos < warm:
        w = min(cfg.wave_size, pos, warm - pos)
        MB._insert_wave_union(g, cfg, plans, per, w)
        pos += w
    lock = device_breakdown(
        lambda: MB._insert_wave_union(g, cfg, plans, per, wave), card,
        f"lockstep build, one wave of {P} x {wave} rows")
    seq = HnswIndex(cfg, capacity=per, device=dev)
    x = rows[0::P][:per]
    seq.add(x[:warm])
    state = {"pos": warm}

    def one_wave():
        s = state["pos"]
        seq._insert_wave(x[s:s + wave], seq._draw_levels(wave))
        state["pos"] = s + wave

    single = device_breakdown(
        one_wave, card, f"sequential wave build, one wave of {wave} rows")
    return {"lockstep": lock, "sequential": single}


def mesh_build_phase(base: np.ndarray, queries: np.ndarray, gt: np.ndarray,
                     card: str, dev: torch.device) -> dict:
    """PartitionedHnswIndex(8 hash partitions, graph engine) over the first
    200,000 rows built in lockstep (mesh="auto") against each partition's
    rows built by HnswIndex(capacity=25,000).build(mode="wave") in the
    same call: every graph tensor equal, both times; a profiled wave of
    each; recall@10 at ef_search 64 through search and sharded(); the
    sequential bulk build's time for scale; then the lockstep build of all
    1M rows."""
    out = {}
    cfg = HnswConfig(dim=DIM, m=16, ef_construction=64, seed=0)
    qdev = torch.from_numpy(queries).to(dev)
    sub = base[:MESH_N]
    per = MESH_N // MESH_P
    t0 = time.perf_counter()
    lock = PartitionedHnswIndex(cfg, MESH_P, router="hash", engine="graph",
                                device=dev).build(sub, mesh="auto")
    torch.cuda.synchronize()
    out["lockstep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seqs = [HnswIndex(cfg, capacity=per, device=dev).build(
        sub[part._global_ids], mode="wave") for part in lock.parts]
    torch.cuda.synchronize()
    out["sequential_s"] = time.perf_counter() - t0
    for p, (part, seq) in enumerate(zip(lock.parts, seqs)):
        assert part.n == seq.n == per
        assert (part.entry, part.entry_level, part.n_upper) == (
            seq.entry, seq.entry_level, seq.n_upper), f"partition {p}"
        for name in ("vectors", "vectors_sq", "neighbors0", "upper_nbrs",
                     "upper_slot", "levels", "deleted"):
            assert torch.equal(getattr(part.graph, name),
                               getattr(seq.graph, name)), (p, name)
    del seqs
    out["speedup"] = out["sequential_s"] / out["lockstep_s"]
    print(f"lockstep build of {MESH_P} hash partitions x {per} rows: "
          f"{out['lockstep_s']:.3f} s ({MESH_N / out['lockstep_s']:.1f} "
          f"rows/s) against {out['sequential_s']:.3f} s "
          f"({MESH_N / out['sequential_s']:.1f} rows/s) for the {MESH_P} "
          f"sequential wave builds, x{out['speedup']:.2f}; every partition's "
          f"graph tensors, entry, levels and upper count equal [{card}]",
          flush=True)
    sgt = FlatIndex(sub, Metric.L2, device=dev).search(qdev, k=10,
                                                       exact=True)[1]
    d, ids = lock.search(queries, k=10, ef_search=64)
    out["recall"] = recall_at_k(ids, sgt, 10)
    sd, sids = lock.sharded().search(queries, k=10, ef_search=64)
    out["sharded_recall"] = recall_at_k(sids, sgt, 10)
    # search() runs each partition's level-0 beam in the beam kernel,
    # sharded() in the torch loop: one function but for the f32 sum order
    # of the scores (d terms), so ids may part at near-ties
    out["sharded_tie_rows"] = same_up_to_ties(
        d, ids, sd, sids, rtol=DIM * float(np.finfo(np.float32).eps))
    t0 = time.perf_counter()
    PartitionedHnswIndex(cfg, MESH_P, router="hash", engine="graph",
                         device=dev).build(sub)
    torch.cuda.synchronize()
    out["sequential_bulk_s"] = time.perf_counter() - t0
    print(f"lockstep partitions: recall@10 {out['recall']:.4f} at "
          f"ef_search 64 (search), {out['sharded_recall']:.4f} (sharded(), "
          f"ids equal but for near-ties in {out['sharded_tie_rows']} rows); "
          f"the sequential bulk build of the same partitions "
          f"{out['sequential_bulk_s']:.3f} s [{card}]", flush=True)
    del lock
    torch.cuda.empty_cache()
    out["waves"] = mesh_wave_breakdowns(sub, cfg, card, dev, warm=2048)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    big = base[:MESH_BIG_N]
    t0 = time.perf_counter()
    lock = PartitionedHnswIndex(cfg, MESH_P, router="hash", engine="graph",
                                device=dev).build(big, mesh="auto")
    torch.cuda.synchronize()
    out["big_s"] = time.perf_counter() - t0
    out["big_peak_GB"] = peak_gb()
    big_gt = gt if MESH_BIG_N == N else FlatIndex(
        big, Metric.L2, device=dev).search(qdev, k=10, exact=True)[1]
    _, ids = lock.search(queries, k=10, ef_search=64)
    out["big_recall"] = recall_at_k(ids, big_gt, 10)
    out["big_n_upper"] = [p.n_upper for p in lock.parts]
    print(f"lockstep build of {MESH_BIG_N} rows over {MESH_P} hash "
          f"partitions: {out['big_s']:.3f} s ({MESH_BIG_N / out['big_s']:.1f}"
          f" rows/s), upper elements a partition {out['big_n_upper']} "
          f"(dense-scan seeding from {HnswIndex.ROUTE_SCAN_MIN_UPPER}), "
          f"recall@10 {out['big_recall']:.4f} at ef_search 64, peak "
          f"{out['big_peak_GB']:.2f} GB [{card}]", flush=True)
    del lock
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# host data made beside the card's work
# ---------------------------------------------------------------------------

#: the later phases' host data, one spawned process each
HOST_DATA = ("config_d", "sparse", "binary")


def make_host_data(name: str):
    """One phase's numpy data, exactly as the phase would make it."""
    if name == "config_d":
        return config_d_data()
    if name == "sparse":
        from tpu_hnsw_torch import SparseVecs
        from tpu_hnsw_torch.io.datasets import synthetic_splade

        bi, bv, qi, qv = synthetic_splade(SP_N, vocab=SP_VOCAB, nnz=SP_NNZ,
                                          n_queries=SP_NQ, seed=SP_SEED)
        return (SparseVecs(bi, bv, SP_VOCAB), SparseVecs(qi, qv, SP_VOCAB))
    base, queries = synthetic_clustered(N, BIN_DIM, n_queries=NQ,
                                        seed=DATA_SEED)
    return binary_quantize(base).numpy(), binary_quantize(queries).numpy()


def _host_data_worker(name: str, path: str) -> None:
    """Make one phase's data and pickle it, with the seconds it took, to
    ``path`` (a queue pipes gigabytes at tens of MB/s)."""
    import pickle

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    data = make_host_data(name)
    with open(path, "wb") as f:
        pickle.dump((data, time.perf_counter() - t0), f, protocol=5)


class HostData:
    """The numpy data of config D, the sparse cell and the binary path
    (about 130 s of single-threaded host work), made by one spawned
    process each while the kernels build and the 1M x 128 rows are made,
    and passed through files in a temporary directory. ``wait`` joins the
    processes before the first timed phase, so no timed window shares the
    host with them; each phase then takes its data. The processes are
    stopped and the directory removed on exit, finished or not."""

    def __enter__(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_")
        self.procs = {name: ctx.Process(target=_host_data_worker,
                                        args=(name, self._path(name)),
                                        daemon=True)
                      for name in HOST_DATA}
        for proc in self.procs.values():
            proc.start()
        return self

    def _path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.pkl")

    def wait(self) -> None:
        for name, proc in self.procs.items():
            proc.join(timeout=900)
            if proc.exitcode != 0:
                raise RuntimeError(f"host data {name!r} failed "
                                   f"(exit code {proc.exitcode})")

    def take(self, name: str):
        """(data, seconds the worker took to make and write it)."""
        import pickle

        with open(self._path(name), "rb") as f:
            data = pickle.load(f)
        os.remove(self._path(name))
        return data

    def __exit__(self, *exc):
        import shutil

        for proc in self.procs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
        shutil.rmtree(self.dir, ignore_errors=True)
        return False


def main() -> None:
    if sys.argv[1:] not in ([], ["config_e"], ["route"], ["beam"]):
        raise SystemExit("usage: python3 chip_smoke.py [config_e|route|beam]")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs a GPU")
    if sys.argv[1:] == ["config_e"]:
        run_config_e()
        return
    if sys.argv[1:] == ["route"]:
        run_route()
        return
    if sys.argv[1:] == ["beam"]:
        run_beam()
        return
    with HostData() as host:
        run(host)


def run_config_e() -> None:
    """Config E's phase alone, after the kernel builds, in a fresh process:
    its profiled chunk keeps every kernel there (late in the whole run the
    trace loses some; ``device_breakdown``'s ``complete``). Prints the
    phase's numbers as one JSON line, then the card line."""
    card = card_line()
    print(f"card: {card}", flush=True)
    with phase("kernel builds"):
        build_phase()
    with phase("config E"):
        out = config_e_phase(card, torch.device("cuda"))
    print(json.dumps({"config_e": out, "phase_s": PHASE_S}), flush=True)
    print(card, flush=True)


def run_route() -> None:
    """The route kernel's phase alone, after its build."""
    card = card_line()
    print(f"card: {card}", flush=True)
    with phase("kernel builds"):
        build_phase((R.NAME,))
    with phase("route"):
        out = route_phase(card, torch.device("cuda"))
    print(json.dumps({"route": out, "phase_s": PHASE_S}), flush=True)
    print(card, flush=True)


def run_beam() -> None:
    """The beam kernel's phase alone: its build, the 1M x 128 rows, the
    bulk-built graph at the graph cell's configuration."""
    card = card_line()
    print(f"card: {card}", flush=True)
    with phase("kernel builds"):
        build_phase((BM.NAME,))
    with phase("1M x 128 data"):
        base, queries = synthetic_clustered(N, DIM, n_queries=NQ,
                                            seed=DATA_SEED)
    dev = torch.device("cuda")
    with phase("graph build"):
        idx = HnswIndex(HnswConfig(dim=DIM, m=16, ef_construction=64,
                                   seed=0), device=dev).build(
            torch.from_numpy(base).to(dev))
    with phase("beam"):
        out = beam_phase(idx, torch.from_numpy(queries).to(dev), card)
    print(json.dumps({"beam": out, "phase_s": PHASE_S}), flush=True)
    print(card, flush=True)


def run(host: HostData) -> None:
    card = card_line()
    print(f"card: {card}", flush=True)
    with phase("kernel builds"):
        builds = build_phase()
    with phase("1M x 128 data"):
        base, queries = synthetic_clustered(N, DIM, n_queries=NQ,
                                            seed=DATA_SEED)
    # every later phase is timed: the data workers end first
    with phase("host data wait"):
        host.wait()
    dev = torch.device("cuda")
    with phase("collectives"):
        merges = collectives_phase(card, dev)
    with phase("expand kernel checks"):
        variants, topr, random_timing = kernel_phase(base, queries, card,
                                                     dev)
    with phase("route"):
        route = route_phase(card, dev)

    with phase("block path"):
        # count only the block path's launches
        H.LAUNCHES = 0
        reset_expand_counts()
        with counted_routes() as calls:
            numbers, idx, gt = main_path(base, queries, card, dev)
        launches = expand_launches()
        assert launches["expand_topr"] > 0, \
            "the block path never launched expand_topr"
        route_paths = {"block_1Mx128": route_launches(calls)}
        timings = [random_timing, routed_timing(
            idx, torch.from_numpy(queries[:KERNEL_Q]).to(dev),
            numbers["probes"], 40, card, "1M x 128 index, routed bids")]
        qchunk = torch.from_numpy(queries[:CHUNK]).to(dev)
        breakdowns = [device_breakdown(
            lambda: idx.search_device(qchunk, k=10,
                                      probes=numbers["probes"]),
            card, f"block path, one {CHUNK}-query search_device chunk")]
        ranges = profile_phase(idx, qchunk, numbers["probes"], card)
    with phase("block lifecycle"):
        reset_expand_counts()
        life = lifecycle_phase(idx, base, queries, numbers["probes"], card,
                               dev)
        life_launches = expand_launches()
        assert life_launches["expand_topr"] > 0, \
            "filter/lifecycle never launched expand_topr"
        assert life_launches["expand_score"] > 0, \
            "search_iterative never widened past the fused limit"
        del idx, qchunk
        torch.cuda.empty_cache()

    # the port's CLI (subprocesses on the card) on the same rows, written
    # as data files; its bench headline; the planner against it
    with tempfile.TemporaryDirectory() as tmp:
        with phase("data files"):
            files, paths = data_files_phase(base, queries, tmp, card)
        with phase("CLI"):
            cli = cli_phase(base, gt, paths, tmp, card)
        with phase("bench"):
            bench = bench_phase(card)
        # comparison launches: after the counted runs
        with phase("CLI and bench shapes"):
            topr.extend(cli_bench_shapes(os.path.join(tmp, CLI_INDEX),
                                         queries, bench["json"], card, dev,
                                         timings))
    with phase("planner"):
        plan = planner_phase(base, bench["json"], card)
        topr.extend(plan.pop("topr"))

    # the graph engine on the same data and ground truth
    with phase("graph"):
        graph, gidx, gkw, gbreak = graph_phase(base, queries, gt, card, dev)
        route_paths["graph_1Mx128"] = graph.pop("route_launches")
        breakdowns.append(gbreak)
    with phase("beam"):
        beam = beam_phase(gidx, torch.from_numpy(queries).to(dev), card)
    with phase("graph-routed block"):
        reset_expand_counts()
        routed = block_graph_routed(base, queries, gt, card, dev)
        routed_launches = expand_launches()
        assert routed_launches["expand_topr"] > 0, \
            "the graph-routed block path never launched expand_topr"
        graph["block_graph_routed"] = routed
    with phase("graph lifecycle"):
        graph["lifecycle"] = graph_lifecycle(gidx, base, queries, gkw, card,
                                             dev)
        del gidx
        torch.cuda.empty_cache()

    # IVF (no kernel of its own), then the partitioned index's other modes
    with phase("IVF"):
        ivf = ivf_phase(base, queries, gt, card, dev)
        torch.cuda.empty_cache()
    with phase("partition modes"):
        reset_expand_counts()
        modes = partition_modes(base, queries, gt, card, dev)
        modes_launches = expand_launches()
        assert modes_launches["expand_topr"] > 0, \
            "the centroid-partitioned block path never launched expand_topr"
        torch.cuda.empty_cache()
    with phase("mesh build"):
        reset_expand_counts()
        mesh = mesh_build_phase(base, queries, gt, card, dev)
        mesh_launches = expand_launches()  # the graph engine has no kernel
        del base, queries
        torch.cuda.empty_cache()

    # config D at full width: its launch counters are kept by the phase
    with phase("config D"):
        with counted_routes() as calls:
            cfg_d = config_d_phase(card, dev, host.take("config_d"))
        route_paths["config_d_10Mx96"] = route_launches(calls)
        d_launches = cfg_d.pop("launches")
        assert d_launches["expand_topr"] > 0, \
            "config D never launched expand_topr"
        topr.extend(cfg_d.pop("topr_d96"))
        timings.append(cfg_d.pop("timing"))
        breakdowns.append(cfg_d.pop("breakdown"))
        stacked = cfg_d["stacked"]
        d_stacked_launches = stacked.pop("launches")
        assert d_stacked_launches["expand_topr"] > 0, \
            "stacked config D never launched expand_topr"
        topr.extend(stacked.pop("topr"))
        stacked_timing = stacked.pop("timing")
        timings.append(stacked_timing)
        breakdowns.append(stacked.pop("breakdown"))
        torch.cuda.empty_cache()

    # config E's per-card shard: its launch counters are kept by the phase
    with phase("config E"):
        cfg_e = config_e_phase(card, dev)
        e_launches = cfg_e.pop("launches")
        assert e_launches["expand_topr"] > 0, \
            "config E never launched expand_topr"
        topr.extend(cfg_e.pop("topr"))
        timings.extend(cfg_e.pop("timings"))
        breakdowns.append(cfg_e.pop("breakdown"))

    # the sparse cell: its launch counters are kept by the phase
    with phase("sparse"):
        sparse = sparse_phase(card, dev, host.take("sparse"))
        sp_launches = sparse["launches"]
        assert sp_launches["expand_topr"] > 0, \
            "the sparse path never launched expand_topr"
        assert sp_launches["expand_score"] > 0, \
            "the sparse path at rerank_k 200 never launched expand_score"
        topr.extend(sparse["topr"])
        variants.extend(sparse["variants"])
        timings.extend(sparse["timings"])
        breakdowns.append(sparse["breakdown"])
        torch.cuda.empty_cache()

    with phase("binary"):
        binary = binary_phase(card, dev, host.take("binary"))
    variants.extend(binary["expand_d1536"])
    topr.extend(binary["topr_d1536"])
    timings.extend(binary["timings"])
    breakdowns.append(binary["breakdown"])
    ham = binary["hamming"]
    head = next(v for v in variants if v["dtype"] == "int8"
                and v["metric"] == "l2" and v["p"] == 8 and v["d"] == DIM
                and not v["masked"])
    print(json.dumps({"main_path": numbers, "lifecycle": life,
                      "profile_ranges": ranges, "data_files": files,
                      "cli": cli, "bench_s": bench["s"], "planner": plan,
                      "route": route, "route_launches": route_paths,
                      "graph": graph, "beam": beam, "ivf": ivf, "partition_modes": modes,
                      "config_d": cfg_d, "config_e": cfg_e,
                      "mesh_build": mesh,
                      "sparse": sparse["numbers"],
                      "binary": binary["numbers"],
                      "collectives": merges,
                      "nvcc_s": builds, "phase_s": PHASE_S, "card": card}),
          flush=True)
    topk = binary["topk"]
    fused = next(v for v in topk if v["metric"] == "hamming"
                 and v["k"] == 10 and v["Q"] == KERNEL_Q
                 and v["W"] == BIN_DIM // 32)
    lib_ms = binary["library"]["ms"]
    int_mm_ms = binary["library"]["int_mm_ms"]
    launches_bin = binary["numbers"]["launches"]
    by_path = {name: {"block_1Mx128": launches[name],
                      "block_lifecycle": life_launches[name],
                      "cli_search_eval_1Mx128": cli["launches"][name],
                      "bench_1Mx128": bench["launches"][name],
                      "planner_calibrate": plan["launches"][name],
                      "block_graph_routed_1Mx128": routed_launches[name],
                      "partitioned_centroid_1Mx128": modes_launches[name],
                      "config_d_10Mx96": d_launches[name],
                      "config_d_stacked_10Mx96": d_stacked_launches[name],
                      "config_e_25Mx512": e_launches[name],
                      "mesh_build_8x25k_and_1M": mesh_launches[name],
                      "sparse_1Mx30522": sp_launches[name],
                      "binary_1Mx1536": launches_bin[name]}
               for name in ("expand_score", "expand_topr",
                            "expand_topr_grouped", "expand_topr_ring")}
    # each route of the fused entry served some path in the counted runs
    for name in ("expand_topr_grouped", "expand_topr_ring"):
        assert sum(by_path[name].values()) > 0, f"no path launched {name}"
    print(json.dumps({"stage1_timings": timings,
                      "device_breakdowns": breakdowns}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "expand_score", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/expand_score.cu "
                  "(expand_score_launch)",
        "replaces": "tpu_hnsw/ops/pallas_expand.py:141",
        "launches": sum(by_path["expand_score"].values()),
        "launches_by_path": by_path["expand_score"],
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": head["ms"], "device_ms": random_timing["all_device_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "timed_at": "int8 l2 Q=1024 p=8 S=256 d=128, random bids; ms: "
                    "CUDA events over back-to-back calls, device_ms: the "
                    "span of one call behind a spin kernel",
        "variants": variants,
        "at_sparse_shape": sparse["variants"],
    }, *[{
        "name": f"expand_topr_{route}", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/expand_score.cu " + entry,
        "replaces": "tpu_hnsw/ops/pallas_expand.py:141 with the "
                    "approx_min_k of tpu_hnsw/index/block.py:212",
        "launches": sum(by_path[f"expand_topr_{route}"].values()),
        "launches_by_path": by_path[f"expand_topr_{route}"],
        "max_abs_err": max(v["max_abs_err"] for v in topr),
        "ms": at[f"{route}_ms"], "device_ms": at["fused_device_ms"],
        "plain_ms": at["plain_fused_ms"],
        "bound_ms": at["fused_bound_ms"], "bound_by": at["fused_bound_by"],
        "library_ms": None,
        "composite_ms": at["composite_ms"],
        "composite_device_ms": at["composite_device_ms"],
        "composite_of": "expand_score_launch, then torch.topk over "
                        "[Q, p*S] (the earlier design's stage 1)",
        "other_route_ms": at["ring_ms" if route == "grouped"
                             else "grouped_ms"],
        "timed_at": f"{at['of']}: int8 Q={at['Q']} p={at['p']} "
                    f"S={at['S']} d={at['d']} r={at['r']}, where "
                    "topr_route picks this route; ms: CUDA events over "
                    "back-to-back calls, routes in turns; device_ms: the "
                    "span of one call behind a spin kernel",
        "variants": [v for v in topr if route in v["routes"]],
        "at_every_stage1_shape": [
            {k: t[k] for k in ("of", "dtype", "Q", "p", "d", "r", "route",
                               "grouped_ms", "ring_ms", "fused_bound_ms",
                               "composite_ms", "chosen_is_faster")}
            for t in timings],
    } for route, entry, at in (
        ("grouped", "(expand_topr_grouped_launch: grouped_kernel<TOPR>, "
                    "merge_kernel)", random_timing),
        ("ring", "(expand_topr_launch: stage_kernel, select_kernel)",
         stacked_timing))], *[{
        "name": "route_topk", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/route_topk.cu (route_topk_launch: "
                  "route_topk_tile, route_topk_reduce)",
        "replaces": "the XLA dot and top_k of tpu_hnsw/index/block.py:287 "
                    "(_route_exact_body) and of tpu_hnsw/index/search.py:"
                    "405-442 (_scan_seeds_body); no Pallas kernel",
        "launches_by_path": route_paths,
        "ms": at["ms"], "device_ms": at["device_ms"],
        "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
        "bound_by": at["bound_by"], "library_ms": at["library_ms"],
        "library_of": "f32 GEMM, then topk_smallest_fast (torch.topk)",
        "timed_at": f"{at['of']}: Q={at['Q']} groups={at['groups']} "
                    f"b={at['centroids']} d={at['d']} p={at['p']}; ms: CUDA "
                    "events over back-to-back calls",
    } for at in route], {
        "name": "beam_level0", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/beam_search.cu (beam_level0_launch: "
                  "beam_kernel)",
        "replaces": "the lax.while_loop of tpu_hnsw/index/search.py:243 "
                    "(_search_layer_body); no Pallas kernel",
        "launches_by_path": {"graph_1Mx128": beam["launches"]},
        "ms": beam["ms"], "device_ms": beam["device_ms"],
        "plain_ms": beam["plain_ms"], "bound_ms": beam["bound_ms"],
        "bound_by": beam["bound_by"], "library_ms": None,
        "timed_at": "the 1M x 128 bulk-built graph, m 16, Q=4096, ef 40, "
                    "route-scan seeds; ms: CUDA events over back-to-back "
                    "calls; plain_ms: the torch loop",
    }, {
        "name": "hamming_scan", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/hamming_scan.cu",
        "replaces": "tpu_hnsw/ops/pallas_hamming.py:52",
        "launches": launches_bin["hamming_scan"],
        "launches_by_path": {"binary_1Mx1536": launches_bin["hamming_scan"]},
        "max_abs_err": max(v["max_abs_err"] for v in ham),
        "ms": ham[0]["ms"], "plain_ms": ham[0]["plain_ms"],
        "bound_ms": ham[0]["bound_ms"], "bound_by": ham[0]["bound_by"],
        "library_ms": lib_ms, "library_int_mm_ms": int_mm_ms,
        "library": binary["library"],
        "timed_at": "Q=1024 N=1000000 W=48 (1536 bits)",
        "variants": ham,
    }, {
        "name": "hamming_topk", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/hamming_scan.cu",
        "replaces": "tpu_hnsw/ops/pallas_hamming.py:52 with the top_k of "
                    "tpu_hnsw/ops/bitops.py:90",
        "launches": launches_bin["hamming_topk"],
        "launches_by_path": {"binary_1Mx1536": launches_bin["hamming_topk"]},
        "max_abs_err": max(v["max_abs_err"] for v in topk),
        "ms": fused["ms"], "plain_ms": fused["plain_ms"],
        "bound_ms": fused["bound_ms"], "bound_by": fused["bound_by"],
        "library_ms": lib_ms, "library_int_mm_ms": int_mm_ms,
        "library_of": "the and-counts and hamming step (no top-k); "
                      "library_int_mm_ms: the and-counts alone",
        "timed_at": "hamming k=10 Q=1024 N=1000000 W=48 (1536 bits)",
        "variants": topk,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
