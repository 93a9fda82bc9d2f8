"""Command-line interface (port of ``tpu_hnsw/cli.py``).

pgvector's interface is psql + SQL DDL (``CREATE INDEX ... USING hnsw``,
``SET hnsw.ef_search``, ORDER BY queries); the equivalents here are
subcommands:

    tpu-hnsw-torch build  --input base.fvecs --out idx/ [--m 16] [--efc 64]
    tpu-hnsw-torch search --index idx/ --queries q.fvecs --k 10 --ef 40
    tpu-hnsw-torch eval   --index idx/ --queries q.fvecs [--gt gt.ivecs]
    tpu-hnsw-torch bench  [--n 100000 --dim 128]

Every subcommand runs on ``--device`` (default ``cuda``: the card; pass
``--device cpu`` to run on the CPU). Nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_vectors(path: str) -> np.ndarray:
    from tpu_hnsw_torch.io import datasets as DS

    if path.endswith(".fvecs"):
        return DS.read_fvecs(path)
    if path.endswith(".bvecs"):
        return DS.read_bvecs(path)
    if path.endswith(".npy"):
        return np.load(path)
    raise SystemExit(f"unsupported vector file: {path} (use .fvecs/.bvecs/.npy)")


def cmd_build(args):
    from tpu_hnsw_torch import (BlockHnswIndex, HnswConfig, HnswIndex, Metric,
                                PartitionedHnswIndex)

    data = _load_vectors(args.input)
    cfg = HnswConfig(
        dim=data.shape[1],
        metric=Metric(args.metric),
        m=args.m,
        ef_construction=args.efc,
        wave_size=args.wave_size,
        dtype=args.dtype,
        seed=args.seed,
        build_expand_per_step=args.build_expand,
    )
    t0 = time.perf_counter()
    if args.partitions > 1:
        idx = PartitionedHnswIndex(
            cfg, n_partitions=args.partitions, router=args.router,
            engine=args.type, block_size=args.block_size, device=args.device,
        )
        # graph engine: every partition advanced in lockstep on the device;
        # the block engine builds its partitions back to back
        idx.build(data, mesh="auto" if args.type == "graph" else None)
    elif args.type == "block":
        idx = BlockHnswIndex(cfg, block_size=args.block_size,
                             device=args.device)
        idx.build(data)
    else:
        idx = HnswIndex(cfg, capacity=len(data), device=args.device)
        idx.build(data)
    dt = time.perf_counter() - t0
    idx.save(args.out)
    print(
        json.dumps(
            {
                "built": len(data),
                "seconds": round(dt, 2),
                "vectors_per_sec": round(len(data) / dt, 1),
                "out": args.out,
            }
        )
    )


def _load_index(path: str, device):
    """The index saved under ``path``, in whichever of the three layouts
    (partitioned, block, graph) it was written."""
    from tpu_hnsw_torch import BlockHnswIndex, HnswIndex, PartitionedHnswIndex

    if os.path.exists(os.path.join(path, "partitioned.json")):
        return PartitionedHnswIndex.load(path, device=device)
    if os.path.exists(os.path.join(path, "blocks.npz")):
        return BlockHnswIndex.load(path, device=device)
    return HnswIndex.load(path, device=device)


def cmd_search(args):
    idx = _load_index(args.index, args.device)
    q = _load_vectors(args.queries)
    if args.limit:
        q = q[: args.limit]
    t0 = time.perf_counter()
    dists, ids = idx.search(q, k=args.k, ef_search=args.ef)
    dt = time.perf_counter() - t0
    for row_d, row_i in zip(dists[: args.print_rows], ids[: args.print_rows]):
        print(" ".join(f"{i}:{d:.4f}" for d, i in zip(row_d, row_i)))
    print(
        json.dumps({"queries": len(q), "seconds": round(dt, 3),
                    "qps": round(len(q) / dt, 1)}),
        file=sys.stderr,
    )


def _ground_truth(idx, q: np.ndarray, k: int, device) -> np.ndarray:
    """Exact top-k ids over the index's live rows, in the ids its search
    returns (a partitioned index's global ids)."""
    from tpu_hnsw_torch.utils import evalharness as E

    metric = idx.cfg.metric
    if hasattr(idx, "_export_live"):  # BlockHnswIndex
        live_ids, base = idx._export_live()
        return live_ids.cpu().numpy()[
            E.ground_truth(base.float(), q, k, metric, device=device)]
    if hasattr(idx, "graph"):  # HnswIndex
        base = idx.graph.vectors[: idx.n].float()
        return E.ground_truth(base, q, k, metric, device=device)
    # partitioned: ground truth over the concatenated partitions' rows
    # gives concat positions; search() returns ORIGINAL global ids, so
    # positions map back through each partition's id table
    bases, globs = [], []
    for part in idx.parts:
        if hasattr(part, "_export_live"):  # block-engine partition
            lids, lvecs = part._export_live()
            bases.append(lvecs.float().cpu().numpy())
            globs.append(part._global_ids[lids.cpu().numpy()])
        else:
            bases.append(part.graph.vectors[: part.n].float().cpu().numpy())
            globs.append(part._global_ids[: part.n])
    base = np.concatenate(bases).astype(np.float32)
    glob = np.concatenate(globs).astype(np.int64)
    return glob[E.ground_truth(base, q, k, metric, device=device)]


def cmd_eval(args):
    from tpu_hnsw_torch.io import datasets as DS
    from tpu_hnsw_torch.utils import evalharness as E

    idx = _load_index(args.index, args.device)
    q = _load_vectors(args.queries)
    if args.limit:
        q = q[: args.limit]
    if args.gt:
        gt = DS.read_ivecs(args.gt)[: len(q), : args.k]
    else:
        gt = _ground_truth(idx, q, args.k, args.device)
    rows = E.sweep(idx, q, gt, k=args.k)
    for r in rows:
        print(json.dumps(r))


def cmd_bench(args):
    if args.n:
        os.environ["TPU_HNSW_BENCH_N"] = str(args.n)
    if args.dim:
        os.environ["TPU_HNSW_BENCH_D"] = str(args.dim)
    if getattr(args, "dataset", None):
        os.environ["TPU_HNSW_BENCH_DATASET"] = args.dataset
    if getattr(args, "data_dir", None):
        os.environ["TPU_HNSW_DATA"] = args.data_dir
    from tpu_hnsw_torch import bench

    bench.main(device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu-hnsw-torch", description=__doc__)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--device", default="cuda",
        help="torch device every index is built or loaded on (default "
        "cuda; cpu runs on the CPU)")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", parents=[common],
                       help="build an index (CREATE INDEX analogue)")
    b.add_argument("--input", required=True)
    b.add_argument("--out", required=True)
    b.add_argument("--metric", default="l2", choices=["l2", "ip", "cosine"])
    b.add_argument("--m", type=int, default=16)
    b.add_argument("--efc", type=int, default=64)
    b.add_argument("--wave-size", type=int, default=2048)
    b.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--build-expand", type=int, default=4)
    b.add_argument("--partitions", type=int, default=1)
    b.add_argument("--router", default="hash", choices=["hash", "centroid"])
    b.add_argument(
        "--type", default="graph", choices=["graph", "block"],
        help="graph = classical HNSW; block = HNSW routing graph over "
        "cluster-blocked level 0 (the serving engine)",
    )
    b.add_argument("--block-size", type=int, default=256)
    b.set_defaults(fn=cmd_build)

    s = sub.add_parser("search", parents=[common],
                       help="query an index (ORDER BY ... LIMIT k)")
    s.add_argument("--index", required=True)
    s.add_argument("--queries", required=True)
    s.add_argument("--k", type=int, default=10)
    s.add_argument("--ef", type=int, default=40)
    s.add_argument("--limit", type=int, default=0)
    s.add_argument("--print-rows", type=int, default=5)
    s.set_defaults(fn=cmd_search)

    e = sub.add_parser("eval", parents=[common],
                       help="recall/QPS sweep over ef_search")
    e.add_argument("--index", required=True)
    e.add_argument("--queries", required=True)
    e.add_argument("--gt", default=None)
    e.add_argument("--k", type=int, default=10)
    e.add_argument("--limit", type=int, default=0)
    e.set_defaults(fn=cmd_eval)

    n = sub.add_parser("bench", parents=[common],
                       help="headline benchmark (one JSON line)")
    n.add_argument("--n", type=int, default=0)
    n.add_argument("--dim", type=int, default=0)
    n.add_argument(
        "--dataset", default=None,
        choices=["clustered", "uniform", "sift10k", "sift1m", "glove100",
                 "deep10m"],
        help="named BASELINE config (reads <name>_base.fvecs / "
        "<name>_query.fvecs / <name>_groundtruth.ivecs under --data-dir "
        "or $TPU_HNSW_DATA; synthesizes an equivalently-shaped stand-in "
        "when the files are absent)")
    n.add_argument("--data-dir", default=None,
                   help="directory holding the real fvecs/ivecs files")
    n.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
