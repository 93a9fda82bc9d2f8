"""Cost-based engine selection — the ``hnswcostestimate`` analogue (port of
``tpu_hnsw/planner.py``).

pgvector registers ``hnswcostestimate`` with the Postgres planner
(``pgvector:src/hnsw.c``) so the database can choose between the HNSW
index scan and a sequential scan. This module makes that decision for the
port's engines on one GPU:

- flat: the exact ``[batch, n]`` f32 GEMM scan plus top-k and rerank
  (``index/flat.py``), priced by MACs at an end-to-end rate;
- block: exact centroid routing (a ``[batch, n_blocks]`` GEMM), stage 1
  by the fused ``expand_topr`` kernel (``csrc/expand_score.cu``: each
  probed block's int8 rows read once per run of queries probing it, the
  top-r kept in the kernel), then an exact f32 rerank of the survivors;
  stage 1 is priced by bytes;
- graph: the lockstep beam search (``index/search.py``), priced by the
  random rows each step gathers plus a per-step overhead, which on the
  card is the ~100 launches a step costs the host.

The estimators are *relative* costs for picking a plan, not wall-clock
promises. :class:`HardwareModel`'s defaults are anchored to one ``bench``
run of the port on an NVIDIA H100 (see the class, and :func:`anchor`);
they are overridable, or re-measurable on the live device with
:func:`calibrate`, which measures raw rates.

The one decision upstream's planner cannot make — "will the ANN engine
reach the requested recall on THIS data?" — is made from the data:
:func:`cluster_structure_score` measures a sample's cluster structure,
and the planner refuses ANN engines on structure-free data, where both
degrade far below any useful recall target and the flat exact scan is
the honest plan.

``cluster_structure_score``, the estimators and :func:`choose_engine` are
the reference's numpy code unchanged: with equal ``HardwareModel`` values
they return the reference's numbers.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

__all__ = [
    "HardwareModel", "EnginePlan", "estimate_flat_qps",
    "estimate_flat_int8_qps", "estimate_block_qps", "estimate_graph_qps",
    "cluster_structure_score", "choose_engine", "anchor", "stage1_case",
    "calibrate",
]


@dataclasses.dataclass(frozen=True)
class HardwareModel:
    """Per-device cost constants. Two sets exist:

    - **Defaults (here)**, from one ``chip_smoke.py`` run of the port on
      an NVIDIA H100 80GB HBM3 at a 700 W power limit (PERF.md §6, the
      planner's findings): ``dispatch_s``, ``gather_rows_per_s`` and
      ``f32_macs_per_s`` are that run's :func:`calibrate` measurements;
      ``expand_bytes_per_s`` and ``step_overhead_s`` are what
      :func:`anchor` solves from them for the QPS that run's
      ``tpu-hnsw-torch bench`` measured at 1M x 128 (block 2,958,911 at
      probes 8, graph 260,524.4), so those two estimates reproduce it and
      carry the serving overheads (host launches, top-k, result fetch).
      The flat estimate (53,263) is 4.0x the flat QPS measured in that run
      (13,202.6): the port's exact flat scan runs at a quarter of its GEMM
      rate (its keyed per-tile top-k), and the one ``f32_macs_per_s``
      also prices the block and graph routing GEMMs, which run at the raw
      rate, so no value of it reproduces all three engines. The order of
      the three, which is what ``choose_engine`` decides by, is the
      measured one.
    - :func:`calibrate` measures **raw rates** with synchronised,
      host-fetched microbenchmarks; use them for *relative* pricing on
      another card, not as absolute QPS predictions.
    """

    gather_rows_per_s: float = 1.2336e9   # random row gather, row-bound
    f32_macs_per_s: float = 1.3638e13    # [batch, n] f32 GEMM + top-10
    # block stage 1 at the reference's byte count (the gathered int8 rows
    # written and read again); expand_topr reads each probed block once,
    # so this is an effective rate, not the rate its kernel moves bytes at
    expand_bytes_per_s: float = 2.0163e12
    dispatch_s: float = 1.3918e-5        # one tiny op, synchronised
    step_overhead_s: float = 1.1268e-3   # per beam step: launches, top-k


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """One engine priced at an operating point (the planner's "path")."""

    engine: str            # "flat" | "block" | "graph"
    est_qps: float
    exact: bool            # recall 1.0 by construction
    params: dict           # per-call knobs for the chosen engine
    reason: str


def estimate_flat_qps(n: int, dim: int, *, batch: int = 4096,
                      hw: HardwareModel = HardwareModel()) -> float:
    """Sequential-scan cost: a [batch, n] distance matmul per batch —
    2·n·d MACs per query at the end-to-end f32 rate."""
    t = batch * 2.0 * n * dim / hw.f32_macs_per_s + hw.dispatch_s
    return batch / t


#: speedup of an int8 flat scan (``FlatIndex(scan_dtype="int8")``) over the
#: default f32 scan: 1.0, the reference's value (it measured parity on its
#: device), so the planner prices flat_int8 as flat, never prefers it, and
#: gives the reference's plans. The H100's measured ratio is in PERF.md
#: (``chip_smoke.py``'s ``int8_scan_timing``), not here.
INT8_SCAN_SPEEDUP = 1.0


def estimate_flat_int8_qps(n: int, dim: int, *, batch: int = 4096,
                           hw: HardwareModel = HardwareModel()) -> float:
    """An int8 flat scan's cost (see INT8_SCAN_SPEEDUP: priced as the f32
    scan)."""
    t = (batch * 2.0 * n * dim / (hw.f32_macs_per_s * INT8_SCAN_SPEEDUP)
         + hw.dispatch_s)
    return batch / t


def estimate_block_qps(n: int, dim: int, *, probes: int = 8,
                       block_size: int = 256, batch: int = 4096,
                       rerank: int = 32, stage1_itemsize: int = 1,
                       hw: HardwareModel = HardwareModel()) -> float:
    """Blocked-engine cost, matching the engine's structure
    (index/block.py): (1) exact centroid routing — a [batch, n_blocks]
    f32 GEMM; (2) stage 1 over ``probes`` blocks per query from the int8
    scoring copy, by ``expand_topr`` — bandwidth-bound, priced as the
    reference prices it (the ``[batch, probes, S, d]`` rows written and
    read again), so ``expand_bytes_per_s`` is an effective rate; (3)
    exact f32 rerank of the ``rerank`` stage-1 survivors (MAC-priced,
    negligible)."""
    n_blocks = max(1, -(-n // block_size))
    probes = max(1, min(probes, n_blocks))
    route = batch * 2.0 * n_blocks * dim / hw.f32_macs_per_s
    expand = batch * probes * block_size * dim * stage1_itemsize * 2 \
        / hw.expand_bytes_per_s
    rr = batch * 2.0 * rerank * dim * 2 / hw.f32_macs_per_s
    t = route + expand + rr + hw.dispatch_s
    return batch / t


def estimate_graph_qps(n: int, dim: int, *, m: int = 16, ef: int = 24,
                       expand: int = 4, steps: int = 7, seeds: int = 8,
                       batch: int = 4096,
                       hw: HardwareModel = HardwareModel()) -> float:
    """Classical beam-search cost: each step gathers ``expand`` frontier
    nodes' level-0 neighborhoods (2m vectors each) as random rows — the
    row-bound path — plus per-step pool maintenance and the dense
    scan-routing pass over the ~n/m upper-level elements."""
    del ef  # pool width rides the per-step overhead, not the gather count
    rows_gathered = batch * (expand * 2 * m * steps + seeds)
    n_upper = max(1, n // m)
    route = batch * 2.0 * n_upper * dim / hw.f32_macs_per_s
    t = (rows_gathered / hw.gather_rows_per_s
         + steps * hw.step_overhead_s
         + route
         + hw.dispatch_s * 2)  # routing + beam programs
    return batch / t


#: cluster_structure_score subsamples anything larger than this before
#: k-means — the score saturates well below 8k rows, and the cap bounds
#: host memory at ~(CAP·k + CAP·d) floats per iteration regardless of
#: what the caller passes.
STRUCTURE_SAMPLE_CAP = 8192


def cluster_structure_score(sample: np.ndarray, *, k: int = 64,
                            iters: int = 8, seed: int = 0) -> float:
    """How much cluster structure the data has, in [0, ~1].

    Fits ``k`` centroids to a host-side sample (a few k-means rounds)
    and returns 1 − mean_dist_to_nearest_centroid / mean_dist_to_mean.
    Clustered data concentrates around centroids (score → 1); uniform /
    structure-free data gains almost nothing from k centroids over one
    (score → 0). Pure numpy so the planner can run before any device
    work. Distances use the ‖x‖²+‖c‖²−2x·cᵀ identity — a [S, k] matmul,
    never an [S, k, d] broadcast temp — and samples larger than
    ``STRUCTURE_SAMPLE_CAP`` rows are subsampled, so cost is bounded no
    matter how large a sample the caller hands over.
    """
    x = np.asarray(sample, dtype=np.float32)
    if x.ndim != 2 or len(x) < 4 * k:
        raise ValueError("need a 2-D sample with at least 4*k rows")
    rng = np.random.default_rng(seed)
    if len(x) > STRUCTURE_SAMPLE_CAP:
        x = x[rng.choice(len(x), size=STRUCTURE_SAMPLE_CAP, replace=False)]
    c = x[rng.choice(len(x), size=k, replace=False)].copy()
    x_sq = (x * x).sum(-1)  # [S], loop-invariant
    a = np.zeros(len(x), np.int64)
    for _ in range(iters):
        # ||x-c||^2 = ||x||^2 + ||c||^2 - 2 x@c.T  (argmin ignores ||x||^2)
        d2 = (c * c).sum(-1)[None, :] - 2.0 * (x @ c.T)  # [S, k]
        a = d2.argmin(1)
        for j in range(k):
            rows = x[a == j]
            if len(rows):
                c[j] = rows.mean(0)
    d_near = np.sqrt(
        np.maximum(x_sq + (c[a] * c[a]).sum(-1) - 2.0 * (x * c[a]).sum(-1),
                   0.0)).mean()
    d_mean = np.sqrt(((x - x.mean(0)) ** 2).sum(-1)).mean()
    if d_mean <= 0:
        return 1.0
    return float(max(0.0, 1.0 - d_near / d_mean))


# Below this score the ANN engines' recall collapses on structure-free
# data (the reference's uniform control, benchmarks/uniform_control.json:
# 0.35 block / 0.16 graph recall@10 at 1M). The 128-d uniform control
# scores ~0.05-0.10; the clustered benchmark data scores ~0.4+.
STRUCTURE_MIN = 0.25


def choose_engine(n: int, dim: int, *, recall_target: float = 0.95,
                  sample: np.ndarray | None = None,
                  batch: int = 4096, m: int = 16, block_size: int = 256,
                  hw: HardwareModel = HardwareModel()) -> EnginePlan:
    """Pick the serving engine for a corpus — ``hnswcostestimate`` plus
    the planner's index-vs-seqscan choice rolled into one call.

    Prices flat / block / graph at their operating points and returns the
    fastest plan that can meet ``recall_target``: the flat scan is exact
    always; the ANN engines are only credible on data with cluster
    structure (gated by :func:`cluster_structure_score` when a ``sample``
    is given — without one, clustered real-world-like data is assumed,
    matching upstream's optimism) and only below recall 0.99 (the ceiling
    of their benchmark operating points).
    """
    flat = estimate_flat_qps(n, dim, batch=batch, hw=hw)
    flat8 = estimate_flat_int8_qps(n, dim, batch=batch, hw=hw)
    block = estimate_block_qps(n, dim, probes=8, block_size=block_size,
                               batch=batch, hw=hw)
    graph = estimate_graph_qps(n, dim, m=m, batch=batch, hw=hw)

    structure = None
    structure_note = ""
    if sample is not None:
        sample = np.asarray(sample, dtype=np.float32)
        # shrink k for small legitimate samples instead of propagating
        # cluster_structure_score's >=4k-rows ValueError; a sample too
        # small for even k=2 skips the gate with a note.
        k_gate = min(64, len(sample) // 4)
        if k_gate >= 2:
            structure = cluster_structure_score(sample, k=k_gate)
        else:
            structure_note = (
                f"; structure gate skipped: sample of {len(sample)} rows "
                "is too small to fit centroids (need >= 8)")
    ann_ok = structure is None or structure >= STRUCTURE_MIN

    del flat8  # priced as flat (INT8_SCAN_SPEEDUP): the int8 scan never
    # wins a plan, so it is not offered as one
    plans = [EnginePlan("flat", flat, True, {"exact": True},
                        "exact scan; recall 1.0 at any target")]
    if ann_ok and recall_target <= 0.99:
        plans.append(EnginePlan(
            "block", block, False,
            {"probes": 8, "block_size": block_size},
            "cluster-blocked level 0; stage-1 int8 scan + exact rerank"))
        plans.append(EnginePlan(
            "graph", graph, False,
            {"ef_search": 24, "expand": 4, "descent_ef": 8,
             "max_steps": 7, "route": "auto"},
            "classical beam search with dense scan routing"))
    best = max(plans, key=lambda p: p.est_qps)
    if structure is not None and not ann_ok and best.engine.startswith("flat"):
        best = dataclasses.replace(
            best, reason=best.reason +
            f"; ANN engines refused: structure score {structure:.2f} < "
            f"{STRUCTURE_MIN} (see benchmarks/uniform_control.json)")
    if structure_note:
        best = dataclasses.replace(best, reason=best.reason + structure_note)
    return best


def anchor(raw: HardwareModel, n: int, dim: int, *, block_qps: float,
           graph_qps: float, batch: int = 4096) -> HardwareModel:
    """``raw`` with ``expand_bytes_per_s`` and ``step_overhead_s`` solved
    so that :func:`estimate_block_qps` and :func:`estimate_graph_qps`, at
    ``batch`` and the operating points :func:`choose_engine` prices,
    return ``block_qps`` and ``graph_qps`` at ``n`` x ``dim``. Each
    estimate's time is linear in 1/expand_bytes_per_s and in
    step_overhead_s, so two calls of each estimator give the line."""
    def block_s(rate: float) -> float:
        hw = dataclasses.replace(raw, expand_bytes_per_s=rate)
        return batch / estimate_block_qps(n, dim, batch=batch, hw=hw)

    def graph_s(step: float) -> float:
        hw = dataclasses.replace(raw, step_overhead_s=step)
        return batch / estimate_graph_qps(n, dim, batch=batch, hw=hw)

    ref = 1e12
    rest, per_ref = block_s(np.inf), block_s(ref) - block_s(np.inf)
    left = batch / block_qps - rest
    if left <= 0:
        raise ValueError("block_qps is above what routing alone allows")
    g0, per_s = graph_s(0.0), graph_s(1.0) - graph_s(0.0)
    step = (batch / graph_qps - g0) / per_s
    if step <= 0:
        raise ValueError("graph_qps is above what its gathers allow")
    return dataclasses.replace(raw, expand_bytes_per_s=ref * per_ref / left,
                               step_overhead_s=step)


def stage1_case(n: int = 200_000, dim: int = 128, *, batch: int = 2048,
                seed: int = 0, device=None):
    """The stage-1 call that :func:`calibrate` times with these arguments:
    ``expand_topr`` over ``n // 256`` blocks of 256 random int8 rows with
    random norms, ``batch`` random queries each probing 8 random blocks,
    top 40 kept. Returns (positional arguments, keyword arguments, r) for
    ``ops/expand.expand_topr``."""
    from tpu_hnsw_torch.config import Metric
    from tpu_hnsw_torch.index.block import _quantize_rows
    from tpu_hnsw_torch.utils.device import entry_device

    S, probes, r = 256, 8, 40
    dev = entry_device(device)
    rng = np.random.default_rng([seed, 1])

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    n_blocks = max(1, n // S)
    blocks = put(rng.integers(-127, 128, size=(n_blocks, S, dim)
                              ).astype(np.int8))
    blocks_sq = put(rng.random((n_blocks, S)).astype(np.float32))
    block_ids = put(np.arange(n_blocks * S, dtype=np.int32).reshape(
        n_blocks, S))
    scale = put(np.full(n_blocks, 1.0 / 127, np.float32))
    bids = put(rng.integers(0, n_blocks, size=(batch, probes)
                            ).astype(np.int32))
    q = put(rng.normal(size=(batch, dim)).astype(np.float32))
    q8, q_scale = _quantize_rows(q)
    q_sq = (q * q).sum(1)
    return ((blocks, blocks_sq, block_ids, q, q_sq, bids, Metric.L2),
            dict(q8=q8, q_scale=q_scale, score_scale=scale), r)


def calibrate(n: int = 200_000, dim: int = 128, *, batch: int = 2048,
              seed: int = 0, device=None) -> HardwareModel:
    """Measure all five HardwareModel constants on ``device`` (default:
    the card).

    Times, at modest shapes (~100 MB, seconds of device time), each call
    repeated and the last result fetched to the host after a
    synchronise:

    - one tiny op → ``dispatch_s``;
    - one random-row gather → ``gather_rows_per_s``;
    - one dense [batch, n] f32 GEMM + top-10 → ``f32_macs_per_s`` (TF32
      off, as the package sets it);
    - the port's ``expand_topr`` on int8 blocks (S = 256, 8 probes, the
      block engine's stage-1 width 40; :func:`stage1_case`) →
      ``expand_bytes_per_s``, priced with :func:`estimate_block_qps`'s
      byte count;
    - two beam searches (``index/search.search_layer``) differing only in
      ``max_steps`` on a synthetic random graph → ``step_overhead_s``: the
      per-step time minus its gather share (priced separately through
      ``gather_rows_per_s``).
    """
    from tpu_hnsw_torch.index import graph as G
    from tpu_hnsw_torch.index import search as SL
    from tpu_hnsw_torch.ops import expand as X
    from tpu_hnsw_torch.utils.device import entry_device

    dev = entry_device(device)
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    tbl = put(rng.normal(size=(n, dim)).astype(np.float32))
    ids = put(rng.integers(0, n, size=(batch, 128)).astype(np.int64))
    q = put(rng.normal(size=(batch, dim)).astype(np.float32))

    def timeit(fn, iters: int = 10) -> float:
        # each timed call ends in a reduction, so the host fetch of the
        # last result is tiny; the device runs the calls in order, so that
        # fetch bounds all of them
        fn().cpu()  # warm-up
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        if cuda:
            torch.cuda.synchronize(dev)
        out.cpu()
        return (time.perf_counter() - t0) / iters

    one = put(np.ones(1, np.float32))
    t_dispatch = timeit(lambda: one + 1.0, iters=30)
    t_gather = max(timeit(lambda: tbl[ids].sum()) - t_dispatch, 1e-9)
    t_scan = max(timeit(lambda: torch.topk(
        q @ tbl.T, 10, largest=False)[0].sum()) - t_dispatch, 1e-9)
    gather_rows_per_s = batch * 128 / t_gather

    # --- expand_bytes_per_s: the block engine's stage 1 -------------------
    args, kw, r = stage1_case(n, dim, batch=batch, seed=seed, device=dev)

    def expand():
        return X.expand_topr(*args, r, **kw)[0].sum()

    t_expand = max(timeit(expand, iters=5) - t_dispatch, 1e-9)
    S, probes = args[0].shape[1], args[5].shape[1]
    expand_bytes = batch * probes * S * dim * 2  # the estimator's count
    expand_bytes_per_s = expand_bytes / t_expand

    # --- step_overhead_s: beam runs differing only in max_steps -----------
    m, ef, expand_w = 16, 24, 4
    gn = min(n, 65536)
    gvec = put(np.concatenate([rng.normal(size=(gn, dim)).astype(np.float32),
                               np.zeros((1, dim), np.float32)]))
    nbr0 = put(np.concatenate(
        [rng.integers(0, gn, size=(gn, 2 * m)),
         np.full((1, 2 * m), gn)]).astype(np.int32))
    cap_u = 1
    g = G.HnswGraph(
        vectors=gvec,
        vectors_sq=(gvec * gvec).sum(-1),
        neighbors0=nbr0,
        upper_nbrs=torch.full((cap_u + 1, 1, m), gn, dtype=torch.int32,
                              device=dev),
        upper_slot=torch.full((gn + 1,), cap_u, dtype=torch.int32,
                              device=dev),
        levels=torch.zeros(gn + 1, dtype=torch.int32, device=dev),
        deleted=torch.zeros(gn + 1, dtype=torch.bool, device=dev),
    )
    seeds = put(rng.integers(0, gn, size=(batch, 8)).astype(np.int32))

    def beam(steps: int):
        return lambda: SL.search_layer(g, q, seeds, ef=ef, expand=expand_w,
                                       max_steps=steps)[0].sum()

    s_lo, s_hi = 4, 12
    t_lo = timeit(beam(s_lo), iters=5)
    t_hi = timeit(beam(s_hi), iters=5)
    per_step = max((t_hi - t_lo) / (s_hi - s_lo), 1e-9)
    gather_per_step = batch * expand_w * 2 * m / gather_rows_per_s
    step_overhead_s = max(per_step - gather_per_step, 1e-6)

    return HardwareModel(
        gather_rows_per_s=gather_rows_per_s,
        f32_macs_per_s=batch * 2.0 * n * dim / t_scan,
        expand_bytes_per_s=expand_bytes_per_s,
        dispatch_s=t_dispatch,
        step_overhead_s=step_overhead_s,
    )
