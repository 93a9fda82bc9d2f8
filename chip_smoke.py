"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. print the card (``nvidia-smi`` name and power limit);
2. require CUDA;
3. build the ``expand_score`` kernel library from ``tpu_hnsw_torch/csrc``;
4. hold the kernel against its plain PyTorch version at main-path shapes
   (Q=1024, p in {8, 32}, S=256, d=128, B=4102) in f32, bf16 and int8,
   L2 and IP, and time both with CUDA events;
5. the main path at full size: ``BlockHnswIndex`` over
   ``synthetic_clustered(1_000_000, 128, n_queries=4096, seed=42)``, built
   from host input and from a CUDA tensor, graded against the port's
   ``FlatIndex.search(exact=True)`` over bench.py's probe grid until
   recall@10 >= 0.95, then QPS over 1024-query chunks;
6. print the kernel table as one JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import time

import numpy as np
import torch

from tpu_hnsw_torch import BlockHnswIndex, FlatIndex, HnswConfig, Metric
from tpu_hnsw_torch.index.block import _make_score_copy, _quantize_rows
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import expand as X
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


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
    for dtype, (bl, scale) in copies.items():
        kw = {} if scale is None else dict(q8=q8, q_scale=q_scl,
                                            score_scale=scale)
        for p in (8, 32):
            bids = torch.from_numpy(
                rng.integers(0, B, size=(KERNEL_Q, p))).to(dev)
            for metric in (Metric.L2, Metric.IP):
                args = (bl, blocks_sq, block_ids, q, q_sq, bids, metric)
                got = X.expand_score(*args, **kw)
                want = X.expand_score_reference(*args, **kw)
                torch.cuda.synchronize()
                fin = torch.isfinite(want)
                assert torch.equal(fin, torch.isfinite(got)), "inf pattern"
                err = (got - want).abs()[fin]
                cscale = (blocks_sq.max() + q_sq.max()).item()
                rel = (err / (cscale + want.abs()[fin])).max().item()
                rec = {
                    "dtype": dtype, "metric": metric.value, "Q": KERNEL_Q,
                    "p": p, "S": BLOCK, "d": DIM, "B": B,
                    "max_abs_err": err.max().item(), "rel_err": rel,
                    "rtol": RTOL[dtype],
                    "ms": cuda_ms(lambda: X.expand_score(*args, **kw), 20),
                    "plain_ms": cuda_ms(
                        lambda: X.expand_score_reference(*args, **kw), 5, 1),
                }
                gb = KERNEL_Q * p * BLOCK * bl.shape[2] * bl.element_size()
                rec["kernel_GBps"] = gb / rec["ms"] / 1e6
                print(f"kernel {dtype} {metric.value} p={p}: "
                      f"{rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f} ms, "
                      f"{rec['kernel_GBps']:.1f} GB/s of block rows), "
                      f"max_abs_err {rec['max_abs_err']:.3g}, rel {rel:.3g} "
                      f"[{card}]", flush=True)
                assert rel <= RTOL[dtype], rec
                results.append(rec)
    del rows, blocks, copies
    torch.cuda.empty_cache()
    return results


def main_path(base: np.ndarray, queries: np.ndarray, card: str,
              dev: torch.device) -> dict:
    """Build twice, grade, pick probes, measure QPS. Returns the numbers."""
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
    t0 = time.perf_counter()
    gt_d, gt = oracle.search(qdev, k=10, exact=True)
    out["flat_exact_s"] = time.perf_counter() - t0
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
    return out


def main() -> None:
    card = card_line()
    print(f"card: {card}", flush=True)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs a GPU")
    t0 = time.perf_counter()
    path, log = X.build_library()
    X.load_library()
    print(f"kernel library {path} built/loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if log:
        print(log.strip(), flush=True)
    t0 = time.perf_counter()
    base, queries = synthetic_clustered(N, DIM, n_queries=NQ, seed=DATA_SEED)
    print(f"data {base.shape} in {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    variants = kernel_phase(base, queries, card, dev)

    X.LAUNCHES = 0  # count only the main path's launches
    numbers = main_path(base, queries, card, dev)
    launches = X.LAUNCHES
    assert launches > 0, "the main path never launched expand_score"

    head = next(v for v in variants if v["dtype"] == "int8"
                and v["metric"] == "l2" and v["p"] == 8)
    print(json.dumps({"main_path": numbers, "card": card}), flush=True)
    print(json.dumps({"kernels": [{
        "name": "expand_score", "route": "cuda",
        "source": "tpu_hnsw_torch/csrc/expand_score.cu",
        "replaces": "tpu_hnsw/ops/pallas_expand.py:141",
        "launches": launches,
        "max_abs_err": max(v["max_abs_err"] for v in variants),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "timed_at": "int8 l2 Q=1024 p=8 S=256 d=128",
        "variants": variants,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
