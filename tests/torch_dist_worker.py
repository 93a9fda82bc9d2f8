"""One rank of a gloo process group for the port's multi-rank tests, and the
seeded inputs those tests share with it. It imports torch and the port only.

    python tests/torch_dist_worker.py CASE RANK WORLD STORE_FILE OUT_DIR

``CASE`` is ``collectives`` (4 ranks: the three merges of
``tpu_hnsw_torch/parallel/collectives.py`` on every input of
:func:`collective_cases`), ``sharded`` (2 ranks: the stacked searchers of
:data:`KINDS` with two partitions a rank) or ``mesh_build`` (2 ranks: the
lockstep build of four graph partitions, two a rank, every graph then on
both). Each rank writes its results to ``OUT_DIR/<case>-<rank>.npz``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

RANKS = 4          # the collectives' group
Q, C, K = 12, 5, 6  # queries, candidates a rank, merged width
SHARD_CFG = dict(dim=12, m=8, ef_construction=32, wave_size=64, seed=3)
SHARD_N, SHARD_P = 600, 4


def collective_cases() -> dict:
    """name -> ``([RANKS, Q, C]`` distances, ids): ``ties`` has small
    integer distances and repeated ids, an id's distance the same wherever
    it appears in a row (a replica's), and missing results (+inf, -1);
    ``floats`` has distinct distances and ids."""
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 14, size=(RANKS, Q, C)).astype(np.int64)
    of_id = rng.integers(0, 4, size=(Q, 14)).astype(np.float32)
    d = np.take_along_axis(of_id[None].repeat(RANKS, 0), ids, axis=2)
    d[:, 0, :2] = np.inf  # missing results, as a short list ends
    ids[:, 0, :2] = -1
    floats = rng.random((RANKS, Q, C)).astype(np.float32)
    uniq = rng.permutation(RANKS * C * 100)[:RANKS * Q * C].reshape(
        RANKS, Q, C).astype(np.int64)
    return {"ties": (d, ids), "floats": (floats, uniq)}


def sharded_data():
    """The stacked searchers' rows and queries (tests/test_torch_sharded)."""
    from tpu_hnsw_torch.io.datasets import synthetic_clustered

    base, _ = synthetic_clustered(SHARD_N + 80, 12, n_queries=4, seed=31)
    _, q = synthetic_clustered(SHARD_N + 80, 12, n_queries=40, seed=32)
    return base[:SHARD_N], q


#: the partitioned indexes the stacked-searcher tests serve:
#: name -> (engine, router, keyword arguments)
KINDS = {"hash_block": ("block", "hash", {}),
         "centroid_block": ("block", "centroid",
                            dict(route_k=2, multi_assign_frac=0.05)),
         "graph": ("graph", "hash", {})}


def partition_kw(kind: str) -> dict:
    """The partitioned-index keywords of ``kind`` (either package)."""
    engine, router, kw = KINDS[kind]
    return dict(router=router, engine=engine, block_size=32, **kw)


def partitioned(base, kind: str):
    """The port's ``kind`` partitioned index over ``base``, on the CPU."""
    from tpu_hnsw_torch import HnswConfig, PartitionedHnswIndex

    return PartitionedHnswIndex(HnswConfig(**SHARD_CFG), SHARD_P,
                                device="cpu", **partition_kw(kind)).build(base)


def sharded_searches(sh, q) -> dict:
    """What the 2-rank run and the one-process run both record."""
    out = {}
    for merge in ("all_gather", "ring"):
        d, i = sh.search(q, k=10, ef_search=40, merge=merge)
        out[f"{merge}_d"], out[f"{merge}_i"] = d, i
    return out


def run_collectives(rank: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_hnsw_torch.parallel import collectives as C

    world = dist.group.WORLD
    mesh = init_device_mesh("cpu", (2, RANKS // 2),
                            mesh_dim_names=("slice", "chip"))
    out = {}
    for name, (d, ids) in collective_cases().items():
        dt, it = torch.from_numpy(d[rank]), torch.from_numpy(ids[rank])
        for dedup in (False, True):
            tag = f"{name}_{int(dedup)}"
            for merge, fn in (("gather", C.gather_merge_topk),
                              ("ring", C.ring_merge_topk)):
                v, i = fn(dt, it, K, world, dedup=dedup)
                out[f"{merge}_{tag}_d"], out[f"{merge}_{tag}_i"] = \
                    v.numpy(), i.numpy()
            v, i = C.hierarchical_merge_topk(
                dt, it, K, mesh.get_group("chip"), mesh.get_group("slice"),
                dedup=dedup)
            out[f"hier_{tag}_d"], out[f"hier_{tag}_i"] = v.numpy(), i.numpy()
            # a 1-D DeviceMesh stands for its group
            v, i = C.gather_merge_topk(dt, it, K, mesh["chip"], dedup=dedup)
            out[f"chip_{tag}_d"], out[f"chip_{tag}_i"] = v.numpy(), i.numpy()
    return out


def run_sharded(rank: int) -> dict:
    base, q = sharded_data()
    out = {}
    for name in KINDS:
        sh = partitioned(base, name).sharded(dist.group.WORLD)
        assert sh.local_p == SHARD_P // dist.get_world_size()
        for key, val in sharded_searches(sh, q).items():
            out[f"{name}_{key}"] = val
    return out


MESH_CFG = dict(dim=12, m=8, ef_construction=32, wave_size=64, seed=3)
MESH_N, MESH_P = 1200, 4


def mesh_build_data():
    """Rows and queries of the lockstep-build tests
    (tests/test_torch_mesh_build)."""
    from tpu_hnsw_torch.io.datasets import synthetic_clustered

    return synthetic_clustered(MESH_N, 12, n_queries=20, seed=41)


def graph_arrays(idx) -> dict:
    """Every partition's graph tensors and scalars, by name."""
    out = {}
    for p, sub in enumerate(idx.parts):
        g = sub.graph
        for name in ("vectors", "neighbors0", "upper_nbrs", "upper_slot",
                     "levels"):
            out[f"{name}_{p}"] = getattr(g, name).cpu().numpy()
        out[f"scalars_{p}"] = np.array([sub.n, sub.n_upper, sub.entry,
                                        sub.entry_level, sub.capacity])
    return out


def run_mesh_build(rank: int) -> dict:
    from tpu_hnsw_torch import HnswConfig, PartitionedHnswIndex

    base, q = mesh_build_data()
    idx = PartitionedHnswIndex(HnswConfig(**MESH_CFG), MESH_P,
                               engine="graph", device="cpu").build(
        base, mesh=dist.group.WORLD)
    out = graph_arrays(idx)
    out["ids"] = idx.search(q, k=10, ef_search=40)[1]
    return out


CASES = {"collectives": run_collectives, "sharded": run_sharded,
         "mesh_build": run_mesh_build}


def spawn(case: str, world: int, tmp_dir: str, timeout: float = 240):
    """Run ``case`` on ``world`` ranks (this file in as many processes,
    rendezvous through a FileStore under ``tmp_dir``); returns each rank's
    results. The first rank to fail stops the rest (they would wait in a
    collective), and its log is raised; so is a run past ``timeout``."""
    import subprocess
    import time

    store = os.path.join(tmp_dir, f"{case}.store")
    logs = [os.path.join(tmp_dir, f"{case}-{r}.log") for r in range(world)]
    files = [open(log, "w") for log in logs]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         store, tmp_dir], stdout=f, stderr=subprocess.STDOUT)
        for r, f in enumerate(files)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in files:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(logs[r]) as f:
                raise RuntimeError(f"rank {r} of {case} ended with "
                                   f"{p.returncode}:\n{f.read()[-4000:]}")
    return [dict(np.load(os.path.join(tmp_dir, f"{case}-{r}.npz")))
            for r in range(world)]


def main(case: str, rank: int, world: int, store: str, out_dir: str):
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    try:
        out = CASES[case](rank)
        np.savez(os.path.join(out_dir, f"{case}-{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
