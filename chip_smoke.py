"""Drive the PyTorch port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):

1. require CUDA, then print the card (``nvidia-smi`` name and power limit);
2. build both kernel libraries (``expand_score``, ``hamming_scan``) from
   ``tpu_hnsw_torch/csrc`` with two ``nvcc`` processes started together;
   once the host data is made (below), the three merges of
   ``parallel/collectives.py`` under a one-rank NCCL group (a file
   rendezvous on the loopback device), each equal to the local merge;
3. hold both entries of ``csrc/expand_score.cu`` against their plain
   PyTorch versions at main-path shapes (Q=1024, S=256, d=128, B=4102,
   uniform random bids): ``expand_score`` at p in {8, 32} in f32, bf16 and
   int8, L2 and IP, plus the filter mask (int8, p=8); ``expand_topr``
   (int8: keys exactly equal, L2 and IP, masked and not, r in {1, 40, 100,
   128}, Q=1024 and a ragged 76; f32 and bf16 at r=40 within RTOL); time
   both entries and the earlier design's composite (all scores, then
   ``torch.topk``) with CUDA events;
4. the block path at full size: ``BlockHnswIndex`` over
   ``synthetic_clustered(1_000_000, 128, n_queries=4096, seed=42)``, built
   from host input and from a CUDA tensor, graded against the port's
   ``FlatIndex.search(exact=True)`` over bench.py's probe grid until
   recall@10 >= 0.95, then QPS over 1024-query chunks; stage 1 timed at
   the routed bids of the first 1024 queries; a ``torch.profiler``
   breakdown of one 1024-query ``search_device`` chunk (top device ops,
   device-busy time over the unprofiled host wall time); the oracle timed
   beside the ``torch.topk``-order scan it replaced;
5. filter and lifecycle on that index: the 10%-selectivity filter of
   bench.py, add, delete, filtered ``search_iterative``, ``compact`` and a
   ``save``/``load`` round trip; then the graph engine on the same rows
   (bulk build, bench.py's ladder, QPS, graph-routed ``BlockHnswIndex``,
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
   rows; ``expand_topr`` at d=96 IP against its plain version; recall@10
   over the probe grid to the first point >= 0.95, QPS there, 8
   ``expand_topr`` launches a chunk, a profiled chunk, the host-loop
   ``search`` against ``search_device`` (equal up to tied distances), peak
   memory; then the same index through ``sharded()``: ids against the host
   loop's ``search_device``, ``release_parts_device_state``, the probe grid,
   QPS, one ``expand_topr`` launch a chunk, a profiled chunk and the
   serving peak beside the host loop's, and ``expand_topr`` at the stacked
   shape (8,192 virtual queries over the 41,016 stacked blocks) against
   its plain version and timed;
8. the lockstep build (``parallel/mesh_build.py``): 8 hash partitions of
   the graph engine over the first 200,000 of the 1M x 128 rows built with
   ``build(mesh="auto")`` against each partition's rows built by
   ``HnswIndex(capacity=25_000).build(mode="wave")`` in turn (every graph
   tensor, entry and level equal), both times; a profiled steady wave of
   each; recall@10 at ef_search 64 through ``search`` and ``sharded()``;
   the sequential bulk build's time for scale; then the lockstep build of
   all 1M rows (dense-scan seeding past 4,096 upper elements a
   partition), its time and recall@10;
9. the sparse cell of ``scripts/config_sparse.py``: ``synthetic_splade(
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
10. the binary path at full width: ``binary_quantize`` of
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
11. print each phase's seconds, the kernel table as one JSON line
    (launches per path, times, bounds), the card line, and last ``{"ok":
    true, "device": {...}}``.

The host data of config D, the sparse cell and the binary path (about 130
s of numpy) is made by three spawned processes while the kernels build
and the 1M x 128 rows are made; they are joined before the first timed
phase (``HostData``) and stopped on exit.

Each path's kernel launch counters are set to 0 just before it and read
just after it; launches made to compare a kernel with its plain version
are not counted. Stage 1 of the block, lifecycle, graph-routed,
partitioned (centroid, config D and stacked config D), sparse and binary
paths must launch ``expand_topr`` (stacked config D once a chunk); the
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

import datetime
import json
import math
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import numpy as np
import torch

from tpu_hnsw_torch import (BinaryFlatIndex, BinaryHnswIndex, BlockHnswIndex,
                            FlatIndex, HnswConfig, HnswIndex, IvfFlatIndex,
                            Metric, PartitionedHnswIndex,
                            ShardedBlockSearcher)
from tpu_hnsw_torch.index.block import (_make_score_copy, _pad_cols,
                                        _quantize_rows, _route_exact)
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import _nvcc
from tpu_hnsw_torch.ops import bitops as BO
from tpu_hnsw_torch.ops import expand as X
from tpu_hnsw_torch.ops import hamming as H
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.ops.vector_ops import binary_quantize
from tpu_hnsw_torch.parallel import collectives as C
from tpu_hnsw_torch.utils.evalharness import measure_qps
from tpu_hnsw_torch.utils.recall import recall_at_k

N, DIM, NQ, DATA_SEED = 1_000_000, 128, 4096, 42
BLOCK = 256
PROBE_GRID = (4, 8, 16, 32, 64, 128)  # bench.py:160
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
HBM_BPS = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}
FILTER_SEED, FILTER_SHARE = 17, 0.10  # bench.py:185-196
N_ADD = 10_000


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """(least ms, what bounds it) for a call moving ``nbytes`` and doing
    ``ops`` operations of ``dtype``."""
    b, o = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


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
    rec["bound_ms"], rec["bound_by"] = expand_bound(bl, bids, kw,
                                                    4 * Q * p * S)
    print(f"kernel {dtype} {metric.value} p={shape['p']} d={shape['d']}"
          f"{' masked' if rec['masked'] else ''}: {rec['ms']:.4f} ms "
          f"(plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"by {rec['bound_by']}, {rec['kernel_GBps']:.1f} GB/s "
          f"of block rows), max_abs_err {rec['max_abs_err']:.3g}, "
          f"rel {rel:.3g} [{card}]", flush=True)
    assert rel <= RTOL[dtype], rec
    return rec


def expand_bound(bl, bids, kw, out_bytes: int) -> tuple[float, str]:
    """Either entry: each distinct probed block's rows, norms and ids (and
    scale, mask) read once, the queries and bids once, the output written
    once; 2 Q p S d operations of the rows' type."""
    Q, p = bids.shape
    S, dp, es = bl.shape[1], bl.shape[2], bl.element_size()
    per_block = S * dp * es + 8 * S + 4 * ("score_scale" in kw) \
        + S * ("allowed" in kw)
    nbytes = (torch.unique(bids[(bids >= 0) & (bids < bl.shape[0])]).numel()
              * per_block + Q * dp * es + 4 * Q * (1 + ("q_scale" in kw))
              + 8 * Q * p + out_bytes)
    dtype = {torch.int8: "int8", torch.bfloat16: "bfloat16"}.get(
        bl.dtype, "float32")
    return bound(nbytes, 2 * Q * p * S * dp, dtype)


def topr_check(args, kw, dtype: str, r: int, plain, cscale: float) -> dict:
    """expand_topr against expand_topr_reference (the keyed top-r of the
    plain scores ``plain``) on the same card tensors: int8 keys exactly
    equal; f32 and bf16 within RTOL of the cancellation scale at the
    returned positions and at the r-th score, and every plain position
    below the r-th score minus that bound returned."""
    d, pos = X.expand_topr(*args, r, **kw)
    wd, wpos = X.topr_of_scores(plain, r)
    torch.cuda.synchronize()
    Q = plain.shape[0]
    flat = plain.reshape(Q, -1)
    at = flat.gather(1, pos)
    fin = torch.isfinite(at)
    assert torch.equal(fin, torch.isfinite(d)), "inf pattern"
    err = (d - at).abs()[fin]
    rec = {"r": r, "Q": Q,
           "max_abs_err": err.max().item() if err.numel() else 0.0}
    if dtype == "int8":
        rec["exact_keys"] = torch.equal(T.score_keys(d, pos),
                                        T.score_keys(wd, wpos))
        assert rec["exact_keys"], rec
        return rec
    rtol = RTOL[dtype]
    assert (err <= rtol * (cscale + at.abs()[fin])).all(), rec
    tol = rtol * (cscale + wd[:, -1].abs())
    kth = torch.isfinite(wd[:, -1])
    assert ((d[:, -1] - wd[:, -1]).abs()[kth] <= tol[kth]).all(), rec
    must = flat < (wd[:, -1] - tol)[:, None]
    got = torch.zeros_like(must).scatter_(1, pos, True)
    assert (got | ~must).all(), rec
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
    print(f"expand_topr {dtype} {args[-1].value} {what}"
          f"{' masked' if 'allowed' in kw else ''}: r {list(rs)} x Q "
          f"{list(nqs)} {held} to the plain version [{card}]", flush=True)
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
    reuse."""
    bl, bids = args[0], args[5]
    Q, p = bids.shape
    S = bl.shape[1]
    distinct = torch.unique(bids).numel()

    def composite():
        return torch.topk(X.expand_score(*args, **kw).reshape(Q, -1), r,
                          dim=1, largest=False)

    def fused():
        return X.expand_topr(*args, r, **kw)

    def every():
        return X.expand_score(*args, **kw)

    rec = {"of": what, "Q": Q, "p": p, "S": S, "d": bl.shape[2], "r": r,
           "distinct_blocks": distinct, "reuse": Q * p / distinct,
           "all_ms": cuda_ms(every, 20), "fused_ms": cuda_ms(fused, 20),
           "composite_ms": cuda_ms(composite, 20),
           "all_device_ms": device_ms(every),
           "fused_device_ms": device_ms(fused),
           "composite_device_ms": device_ms(composite),
           "plain_all_ms": cuda_ms(
               lambda: X.expand_score_reference(*args, **kw), 3, 1),
           "plain_fused_ms": cuda_ms(
               lambda: X.expand_topr_reference(*args, r, **kw), 3, 1)}
    rec["all_bound_ms"], rec["all_bound_by"] = expand_bound(
        bl, bids, kw, 4 * Q * p * S)
    rec["fused_bound_ms"], rec["fused_bound_by"] = expand_bound(
        bl, bids, kw, 8 * Q * r)
    print(f"stage 1 {what}: Q={Q} p={p} d={rec['d']} r={r}, {distinct} "
          f"distinct blocks (reuse {rec['reuse']:.2f}); CUDA-event ms: all "
          f"scores {rec['all_ms']:.4f} (bound {rec['all_bound_ms']:.4f}), "
          f"fused top-r {rec['fused_ms']:.4f} (bound "
          f"{rec['fused_bound_ms']:.4f}), composite {rec['composite_ms']:.4f};"
          f" device span ms {rec['all_device_ms']:.4f} / "
          f"{rec['fused_device_ms']:.4f} / {rec['composite_device_ms']:.4f}; "
          f"plain {rec['plain_all_ms']:.2f} / {rec['plain_fused_ms']:.2f} ms"
          f" [{card}]", flush=True)
    return rec


def device_breakdown(fn, card: str, what: str, top: int = 8) -> dict:
    """torch.profiler over one call of ``fn``: the top CUDA ops by device
    time, the count of device ops, and device-busy time over the host
    wall time of a call (the median of five unprofiled calls after two
    warm-ups, each ending in a synchronize)."""
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
    ops = []
    for ev in prof.key_averages():
        if ev.device_type.name != "CUDA":
            continue
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        ops.append((us, ev.count, ev.key))
    ops.sort(reverse=True)
    busy = sum(o[0] for o in ops) / 1e3
    rec = {"of": what, "host_wall_ms": wall * 1e3, "device_busy_ms": busy,
           "busy_share": busy / (wall * 1e3),
           "kernels": sum(o[1] for o in ops),
           "top": [{"op": k[:80], "ms": us / 1e3, "count": c}
                   for us, c, k in ops[:top]]}
    print(f"device breakdown, {what}: host wall {rec['host_wall_ms']:.3f} "
          f"ms, device busy {busy:.3f} ms ({rec['busy_share']:.1%}), "
          f"{rec['kernels']} device ops; top {json.dumps(rec['top'])} "
          f"[{card}]", flush=True)
    return rec


def expand_launches() -> dict:
    """Launches of each expand entry since the counters were reset."""
    return {"expand_score": X.LAUNCHES - X.TOPR_LAUNCHES,
            "expand_topr": X.TOPR_LAUNCHES}


def routed_args(idx, q, probes: int):
    """Stage 1's arguments as _serve_exact makes them: the bids the index's
    own routing gives these queries at ``probes``, on its scoring copy."""
    q = idx._queries(q)
    q_sq = (q * q).sum(1)
    metric = idx.cfg.metric
    bids = _route_exact(idx.centroids, idx.centroids_sq, q, q_sq, p=probes,
                        metric=metric)
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


def build_phase() -> dict:
    """Both kernel libraries, compiled by two nvcc processes at once."""
    names = (X.NAME, H.NAME)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        done = {n: pool.submit(timed_build, n) for n in names}
        built = {n: f.result() for n, f in done.items()}
    for name, (path, log, secs) in built.items():
        print(f"kernel library {name}: {path} built in {secs:.2f} s",
              flush=True)
        if log:
            print(log.strip(), flush=True)
    wall = time.perf_counter() - t0
    print(f"both kernel libraries built in {wall:.2f} s", flush=True)
    return {n: b[2] for n, b in built.items()}


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
    fmask = np.random.default_rng(FILTER_SEED).random(N) < FILTER_SHARE
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


# bench.py:258-261, cheapest first: (descent_ef, ef_search, expand,
# max_steps); max_steps 0 runs the beam to convergence
GRAPH_LADDER = ((16, 16, 3, 4), (24, 16, 3, 4), (16, 16, 3, 5),
                (16, 16, 4, 4), (24, 16, 2, 5), (8, 16, 4, 5), (8, 24, 4, 6),
                (8, 24, 4, 7), (8, 40, 4, 9), (8, 64, 4, 0), (8, 128, 1, 0),
                (8, 200, 1, 0))
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
    out["qps"], out["qps_windows"] = qps_windows(
        lambda s: idx.search_device(qdev[s:s + CHUNK], k=10, **kw)[1], NQ)
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
    H.LAUNCHES = H.TOPK_LAUNCHES = X.LAUNCHES = X.TOPR_LAUNCHES = 0
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
    assert min(v for k, v in out["launches"].items()
               if k != "expand_score") > 0, out["launches"]
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
    del oracle
    torch.cuda.empty_cache()
    print(f"config D data {base.shape} in {out['data_s']:.1f} s; exact "
          f"oracle over {D_N} rows, {D_NQ} queries in {CHUNK}-query chunks: "
          f"{out['oracle_s']:.3f} s [{card}]", flush=True)

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
    X.LAUNCHES = X.TOPR_LAUNCHES = 0  # the comparisons are not the path's

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
    """Stage 1's operands as a stacked search makes them (int8 copy): the
    ``[P*b, S, dp]`` stacked table, ``Q*P`` virtual queries (query-major)
    and the block ids the stacked routing gives them at ``probes``."""
    L, b, S = sh.blocks.shape[:3]
    q_sq = (q * q).sum(1)
    bids = sh._route(q, q_sq, None, probes)
    qv = _pad_cols(q.repeat_interleave(L, 0), sh.blocks_score.shape[3])
    q8, q_scl = _quantize_rows(qv)
    args = (sh.blocks_score.view(L * b, S, -1), sh.blocks_sq.view(L * b, S),
            sh.block_gids.view(L * b, S), qv, q_sq.repeat_interleave(L, 0),
            bids, sh.parent.cfg.metric)
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
    X.LAUNCHES = X.TOPR_LAUNCHES = 0
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
    X.LAUNCHES = X.TOPR_LAUNCHES = 0
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

    X.LAUNCHES = X.TOPR_LAUNCHES = 0
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
    _, ids = lock.search(queries, k=10, ef_search=64)
    out["recall"] = recall_at_k(ids, sgt, 10)
    _, sids = lock.sharded().search(queries, k=10, ef_search=64)
    out["sharded_recall"] = recall_at_k(sids, sgt, 10)
    assert np.array_equal(sids, ids), "sharded() ids differ from search"
    t0 = time.perf_counter()
    PartitionedHnswIndex(cfg, MESH_P, router="hash", engine="graph",
                         device=dev).build(sub)
    torch.cuda.synchronize()
    out["sequential_bulk_s"] = time.perf_counter() - t0
    print(f"lockstep partitions: recall@10 {out['recall']:.4f} at "
          f"ef_search 64 (search), {out['sharded_recall']:.4f} (sharded(), "
          f"equal ids); the sequential bulk build of the same partitions "
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
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs a GPU")
    with HostData() as host:
        run(host)


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

    with phase("block path"):
        # count only the block path's launches
        X.LAUNCHES = X.TOPR_LAUNCHES = H.LAUNCHES = 0
        numbers, idx, gt = main_path(base, queries, card, dev)
        launches = expand_launches()
        assert launches["expand_topr"] > 0, \
            "the block path never launched expand_topr"
        timings = [random_timing, routed_timing(
            idx, torch.from_numpy(queries[:KERNEL_Q]).to(dev),
            numbers["probes"], 40, card, "1M x 128 index, routed bids")]
        qchunk = torch.from_numpy(queries[:CHUNK]).to(dev)
        breakdowns = [device_breakdown(
            lambda: idx.search_device(qchunk, k=10,
                                      probes=numbers["probes"]),
            card, f"block path, one {CHUNK}-query search_device chunk")]
    with phase("block lifecycle"):
        X.LAUNCHES = X.TOPR_LAUNCHES = 0
        life = lifecycle_phase(idx, base, queries, numbers["probes"], card,
                               dev)
        life_launches = expand_launches()
        assert life_launches["expand_topr"] > 0, \
            "filter/lifecycle never launched expand_topr"
        assert life_launches["expand_score"] > 0, \
            "search_iterative never widened past the fused limit"
        del idx, qchunk
        torch.cuda.empty_cache()

    # the graph engine on the same data and ground truth
    with phase("graph"):
        graph, gidx, gkw, gbreak = graph_phase(base, queries, gt, card, dev)
        breakdowns.append(gbreak)
    with phase("graph-routed block"):
        X.LAUNCHES = X.TOPR_LAUNCHES = 0
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
        X.LAUNCHES = X.TOPR_LAUNCHES = 0
        modes = partition_modes(base, queries, gt, card, dev)
        modes_launches = expand_launches()
        assert modes_launches["expand_topr"] > 0, \
            "the centroid-partitioned block path never launched expand_topr"
        torch.cuda.empty_cache()
    with phase("mesh build"):
        X.LAUNCHES = X.TOPR_LAUNCHES = 0
        mesh = mesh_build_phase(base, queries, gt, card, dev)
        mesh_launches = expand_launches()  # the graph engine has no kernel
        del base, queries
        torch.cuda.empty_cache()

    # config D at full width: its launch counters are kept by the phase
    with phase("config D"):
        cfg_d = config_d_phase(card, dev, host.take("config_d"))
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
        timings.append(stacked.pop("timing"))
        breakdowns.append(stacked.pop("breakdown"))
        torch.cuda.empty_cache()

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
                      "graph": graph, "ivf": ivf, "partition_modes": modes,
                      "config_d": cfg_d, "mesh_build": mesh,
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
                      "block_graph_routed_1Mx128": routed_launches[name],
                      "partitioned_centroid_1Mx128": modes_launches[name],
                      "config_d_10Mx96": d_launches[name],
                      "config_d_stacked_10Mx96": d_stacked_launches[name],
                      "mesh_build_8x25k_and_1M": mesh_launches[name],
                      "sparse_1Mx30522": sp_launches[name],
                      "binary_1Mx1536": launches_bin[name]}
               for name in ("expand_score", "expand_topr")}
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
    }, {
        "name": "expand_topr", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/expand_score.cu "
                  "(expand_topr_launch)",
        "replaces": "tpu_hnsw/ops/pallas_expand.py:141 with the "
                    "approx_min_k of tpu_hnsw/index/block.py:212",
        "launches": sum(by_path["expand_topr"].values()),
        "launches_by_path": by_path["expand_topr"],
        "max_abs_err": max(v["max_abs_err"] for v in topr),
        "ms": random_timing["fused_ms"],
        "device_ms": random_timing["fused_device_ms"],
        "plain_ms": random_timing["plain_fused_ms"],
        "bound_ms": random_timing["fused_bound_ms"],
        "bound_by": random_timing["fused_bound_by"],
        "library_ms": None,
        "composite_ms": random_timing["composite_ms"],
        "composite_device_ms": random_timing["composite_device_ms"],
        "composite_of": "expand_score_launch, then torch.topk over "
                        "[Q, p*S] (the earlier design's stage 1)",
        "timed_at": "int8 l2 Q=1024 p=8 S=256 d=128 r=40, random bids; "
                    "ms and composite_ms: CUDA events over back-to-back "
                    "calls, *device_ms: the span of one call behind a spin "
                    "kernel",
        "variants": topr,
        "at_sparse_shape": sparse["timings"],
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
