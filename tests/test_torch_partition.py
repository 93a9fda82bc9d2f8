"""tpu_hnsw_torch.parallel.partition (host-loop mode) against
tpu_hnsw.parallel.partition on the same data: routers, the id and replica
maps, host-loop search, the device merge, DML, iterative scans and
save/load across both packages; and the merge ops of ops/topk.py.

Shapes as tests/test_partition_dml.py:23-27 (d = 12, n = 600, P = 4), one
JAX build per module fixture; the JAX mesh builds are not run.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw.config import HnswConfig as JCfg
from tpu_hnsw.ops import topk as JT
from tpu_hnsw.parallel.partition import PartitionedHnswIndex as JPart
from tpu_hnsw_torch import FlatIndex, HnswConfig, Metric, PartitionedHnswIndex
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import partition as PT
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

CFG = dict(dim=12, m=8, ef_construction=32, wave_size=64, seed=3)
N, P = 600, 4


def _data():
    base, _ = synthetic_clustered(N + 80, 12, n_queries=4, seed=31)
    _, q = synthetic_clustered(N + 80, 12, n_queries=40, seed=32)
    return base[:N], base[N:], q


def _pair(engine, router, base, **kw):
    kw = dict(router=router, engine=engine, block_size=32, **kw)
    return (PartitionedHnswIndex(HnswConfig(**CFG), P, device="cpu",
                                 **kw).build(base),
            JPart(JCfg(**CFG), P, **kw).build(base))


@pytest.fixture(scope="module")
def hash_block():
    base, extra, q = _data()
    return (base, extra, q) + _pair("block", "hash", base)


@pytest.fixture(scope="module")
def centroid_block():
    base, extra, q = _data()
    return (base, extra, q) + _pair("block", "centroid", base, route_k=2,
                                    multi_assign_frac=0.05)


@pytest.fixture(scope="module")
def graph_hash():
    base, extra, q = _data()
    return (base, extra, q) + _pair("graph", "hash", base)


def _gt(base, q, k=10):
    return FlatIndex(base, Metric.L2, device="cpu").search(
        q, k=k, exact=True)[1]


# ------------------------------------------------------------- merge ops


@pytest.mark.parametrize("shape,k", [((6, 4, 5), 5), ((3, 8, 10), 10),
                                     ((5, 2, 3), 6)])
def test_kway_merge_topk_matches_reference_at_ties(shape, k):
    """Small-integer distances tie everywhere: the merged values and ids
    equal lax.top_k's (ties to the lower flat position)."""
    rng = np.random.default_rng(sum(shape))
    d = rng.integers(0, 4, size=shape).astype(np.float32)
    d[rng.random(shape) < 0.1] = np.inf
    ids = rng.integers(0, 50, size=shape).astype(np.int64)
    jv, ji = JT.kway_merge_topk(d, ids, k)
    v, i = T.kway_merge_topk(torch.from_numpy(d), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("w", [1, 7, 40])
def test_mask_duplicate_ids_matches_reference(w):
    """Repeated ids (and -1 padding, never a duplicate) masked to +inf at
    every later column, as the reference and the host twin do."""
    rng = np.random.default_rng(w)
    ids = rng.integers(-1, 6, size=(9, w)).astype(np.int32)
    d = rng.integers(0, 3, size=(9, w)).astype(np.float32)
    want = np.asarray(JT.mask_duplicate_ids(d, ids))
    got = T.mask_duplicate_ids(torch.from_numpy(d), torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.isinf(want) & ~np.isinf(d),
                                  PT._dup_mask_np(ids))


# ------------------------------------------------------ routers and maps


@pytest.mark.parametrize("fixture", ["hash_block", "centroid_block"])
def test_router_and_maps_match_reference(fixture, request):
    """Assignments, ``_part_of``, ``_local_of``, the replica maps, each
    shard's local -> global map, the centroids (equal to f32 rounding:
    the k-means sums run in different orders, atol 1e-5) and the routes
    of fresh queries."""
    base, extra, q, idx, jidx = request.getfixturevalue(fixture)
    for name in ("_part_of", "_local_of", "_replica_part", "_replica_local"):
        np.testing.assert_array_equal(getattr(idx, name),
                                      getattr(jidx, name), err_msg=name)
    assert idx.has_replicas == jidx.has_replicas
    for sub, jsub in zip(idx.parts, jidx.parts):
        np.testing.assert_array_equal(sub._global_ids, jsub._global_ids)
    if fixture == "centroid_block":
        assert idx.has_replicas
        np.testing.assert_allclose(idx.router.centroids,
                                   jidx.router.centroids, atol=1e-5)
    gids = np.arange(N, N + len(extra))
    np.testing.assert_array_equal(idx.router.assign(extra, gids),
                                  jidx.router.assign(extra, gids))
    for rk in (1, 2, P):
        np.testing.assert_array_equal(idx.router.route(q, rk),
                                      jidx.router.route(q, rk))


@pytest.mark.parametrize("fixture", ["hash_block", "centroid_block"])
def test_search_ids_match_reference_host_loop(fixture, request):
    """The host-loop fan-out and numpy merge return the reference's ids,
    at the index's route_k and at all partitions; distances agree to f32
    rounding (rtol 1e-5: both rerank exactly in f32)."""
    base, extra, q, idx, jidx = request.getfixturevalue(fixture)
    for kw in ({}, {"route_k": P}):
        jd, jids = jidx.search(q, k=10, ef_search=40, **kw)
        d, ids = idx.search(q, k=10, ef_search=40, **kw)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
    if fixture == "centroid_block":  # no replica reaches a result twice
        _, ids = idx.search(q, k=10, ef_search=40, route_k=P)
        for row in ids:
            live = row[row >= 0]
            assert len(np.unique(live)) == len(live)


@pytest.mark.parametrize("fixture", ["hash_block", "centroid_block",
                                     "graph_hash"])
def test_search_device_equals_search(fixture, request):
    """The device fan-out and merge give the ids and distances of the
    host loop over all partitions, and the reference's search_device ids;
    the device id map is cached per shard."""
    base, extra, q, idx, jidx = request.getfixturevalue(fixture)
    kw = {} if idx.engine == "block" else {"descent_ef": 4}
    d, ids = idx.search(q, k=10, ef_search=40, route_k=P, **kw)
    dd, di = idx.search_device(torch.from_numpy(q), k=10, ef_search=40,
                               **kw)
    np.testing.assert_array_equal(di.numpy(), ids)
    np.testing.assert_array_equal(dd.numpy(), d)
    _, jdi = jidx.search_device(q, k=10, ef_search=40, **kw)
    np.testing.assert_array_equal(di.numpy(), np.asarray(jdi))
    gid = idx.parts[0]._global_ids_dev
    idx.search_device(q, k=10, ef_search=40, **kw)
    assert idx.parts[0]._global_ids_dev is gid


def test_graph_engine_recall_matches_reference(graph_hash):
    """Wave-built (wave_size=64) graph partitions: recall@10 within 0.01
    of the reference's host loop against the exact oracle."""
    base, extra, q, idx, jidx = graph_hash
    gt = _gt(base, q)
    _, ids = idx.search(q, k=10, ef_search=40, descent_ef=4)
    _, jids = jidx.search(q, k=10, ef_search=40, descent_ef=4)
    r, jr = recall_at_k(ids, gt, 10), recall_at_k(jids, gt, 10)
    assert abs(r - jr) <= 0.01 and r >= 0.9, (r, jr)


def test_graph_engine_wave1_ids_match_reference():
    """wave_size=1 builds the reference's graphs, so the partitioned
    search returns its ids exactly."""
    kw = dict(CFG, wave_size=1)
    base, q = synthetic_clustered(96, 12, n_queries=16, seed=31)
    idx = PartitionedHnswIndex(HnswConfig(**kw), 2, engine="graph",
                               device="cpu").build(base)
    jidx = JPart(JCfg(**kw), 2, engine="graph").build(base)
    np.testing.assert_array_equal(idx.search(q, k=10, ef_search=40)[1],
                                  jidx.search(q, k=10, ef_search=40)[1])


def test_save_load_across_packages(hash_block, centroid_block, tmp_path):
    """A directory saved by either package loads in the other, with the
    same maps and the same search ids."""
    from tpu_hnsw_torch.index.block import BlockHnswIndex

    for name, fx in (("hash", hash_block), ("centroid", centroid_block)):
        base, extra, q, idx, jidx = fx
        want = jidx.search(q, k=10, ef_search=40)[1]
        idx.save(str(tmp_path / f"t_{name}"))
        jidx.save(str(tmp_path / f"j_{name}"))
        back = PartitionedHnswIndex.load(str(tmp_path / f"j_{name}"),
                                         device="cpu")
        jback = JPart.load(str(tmp_path / f"t_{name}"))
        assert isinstance(back.parts[0], BlockHnswIndex)
        assert back.router.kind == name and back.has_replicas == \
            jidx.has_replicas
        np.testing.assert_array_equal(back._replica_local,
                                      jidx._replica_local)
        np.testing.assert_array_equal(back.search(q, k=10, ef_search=40)[1],
                                      want)
        np.testing.assert_array_equal(
            jback.search(q, k=10, ef_search=40)[1], want)


def test_graph_engine_save_load(graph_hash, tmp_path):
    """The graph engine's partitions round-trip through the reference's
    layout in both packages."""
    base, extra, q, idx, jidx = graph_hash
    want = idx.search(q, k=10, ef_search=40, descent_ef=4)[1]
    idx.save(str(tmp_path / "g"))
    back = PartitionedHnswIndex.load(str(tmp_path / "g"), device="cpu")
    np.testing.assert_array_equal(
        back.search(q, k=10, ef_search=40, descent_ef=4)[1], want)
    jback = JPart.load(str(tmp_path / "g"))
    np.testing.assert_array_equal(
        jback.search(q, k=10, ef_search=40, descent_ef=4)[1], want)


def test_mesh_modes_refuse(hash_block, graph_hash):
    """sharded() returns the stacked searcher of the engine, serving the
    host loop's ids over every partition; ``build(mesh="auto")`` builds the
    graph partitions in lockstep (tests/test_torch_mesh_build.py), the
    same graphs as the sequential build, so the host loop returns the same
    ids; a mesh string that names no device is refused."""
    for fx, cls in ((hash_block, PT.ShardedBlockSearcher),
                    (graph_hash, PT.ShardedHnswSearcher)):
        base, extra, q, idx, _ = fx
        sh = idx.sharded()
        assert isinstance(sh, cls)
        kw = {} if idx.engine == "block" else {"descent_ef": 4}
        want = idx.search(q, k=10, ef_search=40, **kw)[1]
        got = sh.search(q, k=10, ef_search=40, **kw)[1]
        np.testing.assert_array_equal(got, want)
    base, extra, q, idx, _ = graph_hash
    lock = PartitionedHnswIndex(HnswConfig(**CFG), P, engine="graph",
                                device="cpu").build(base, mesh="auto")
    np.testing.assert_array_equal(
        lock.search(q, k=10, ef_search=40, descent_ef=4)[1],
        idx.search(q, k=10, ef_search=40, descent_ef=4)[1])
    with pytest.raises(RuntimeError):
        PartitionedHnswIndex(HnswConfig(**CFG), P, device="cpu").build(
            np.zeros((8, 12), np.float32), mesh="no-such-device")
    with pytest.raises(ValueError, match="engine"):
        PartitionedHnswIndex(HnswConfig(**CFG), P, engine="ivf",
                             device="cpu")


# ------------------------------------------------------------ DML, scans


@pytest.mark.parametrize("fixture", ["hash_block", "centroid_block"])
def test_dml_compact_and_iterative_match_reference(fixture, request):
    """add, delete (replicas included), compact and a filtered
    search_iterative: the same global ids, maps and results in both
    packages (the iterative scan's against the reference's on the hash
    index); added rows are found, deleted ones are gone, and the device
    id maps are dropped on every change. It changes the module's shared
    indexes, so it comes last in this file."""
    base, extra, q, idx, jidx = request.getfixturevalue(fixture)
    idx.search_device(q, k=5, ef_search=40)
    assert all(hasattr(s, "_global_ids_dev") for s in idx.parts)
    gids = idx.add(extra)
    np.testing.assert_array_equal(gids, jidx.add(extra))
    assert not any(hasattr(s, "_global_ids_dev") for s in idx.parts)
    for name in ("_part_of", "_local_of"):
        np.testing.assert_array_equal(getattr(idx, name),
                                      getattr(jidx, name))
    _, found = idx.search(extra, k=1, ef_search=128, route_k=P)
    assert (found[:, 0] == gids).all()
    victims = np.concatenate([np.arange(0, N, 9), gids[::5]])
    if fixture == "centroid_block":
        victims = np.union1d(victims, np.where(idx._replica_part >= 0)[0])
    for ix in (idx, jidx):
        ix.delete(victims)
    for ix in (idx, jidx):
        ix.compact()
    d, ids = idx.search(q, k=10, ef_search=40, route_k=P)
    jd, jids = jidx.search(q, k=10, ef_search=40, route_k=P)
    np.testing.assert_array_equal(ids, jids)
    assert not np.isin(ids, victims).any()
    _, di = idx.search_device(q, k=10, ef_search=40)
    np.testing.assert_array_equal(di.numpy(), ids)
    pred = lambda a: a % 3 == 0  # noqa: E731
    it = idx.search_iterative(q, k=5, ef_search=10, predicate=pred)
    assert (it[1] % 3 == 0).all() and not np.isin(it[1], victims).any()
    if fixture == "hash_block":  # the JAX side's widening rounds compile
        jit = jidx.search_iterative(q, k=5, ef_search=10, predicate=pred)
        np.testing.assert_array_equal(it[1], jit[1])
        np.testing.assert_allclose(it[0], jit[0], rtol=1e-5, atol=1e-6)
