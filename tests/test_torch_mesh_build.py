"""The lockstep build of graph partitions (tpu_hnsw_torch.parallel.
mesh_build, ``PartitionedHnswIndex.build(mesh=...)``):

- four equal hash shards (300 rows each, wave_size 64): every partition's
  adjacency, levels, entry and upper-slot count equal the port's
  sequential wave build of its rows element for element, and, on the same
  rows rounded to integers (where every f32 sum is exact in both
  packages), the JAX package's sequential partition build's lists;
- with ``HnswIndex.ROUTE_SCAN_MIN_UPPER`` patched low in both runs, so
  level 0 is seeded by the dense scan of the upper elements: still equal
  to the sequential wave build;
- unequal centroid shards: graph invariants, recall@10 >= 0.9, and the
  stacked searcher serving the host loop's ids;
- two gloo ranks, two partitions each (tests/torch_dist_worker.py): both
  ranks hold the one-process build's graphs;
- the modes of ``mesh``.

The JAX mesh builds are never run; the JAX side is its sequential build.
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import FlatIndex, HnswConfig, HnswIndex, Metric
from tpu_hnsw_torch import PartitionedHnswIndex
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.parallel import mesh_build as MB

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402
from test_torch_graph_build import check_invariants  # noqa: E402

torch.set_num_threads(1)

CFG = W.MESH_CFG
P = W.MESH_P


@pytest.fixture(scope="module")
def data():
    return W.mesh_build_data()


@pytest.fixture(scope="module")
def lockstep(data):
    base, _ = data
    return PartitionedHnswIndex(HnswConfig(**CFG), P, engine="graph",
                                device="cpu").build(base, mesh="auto")


def _lists(g, n, n_upper):
    return G.to_ref_lists(g, n, n_upper)


def _sequential(cfg, rows):
    return HnswIndex(cfg, capacity=len(rows), device="cpu").build(
        rows, mode="wave")


def _assert_equal_parts(idx, base, cfg, full=True):
    """Each part equals the sequential wave build of its rows: lists,
    levels and scalars; with ``full`` (equal capacities) every tensor."""
    for p, sub in enumerate(idx.parts):
        seq = _sequential(cfg, base[sub._global_ids])
        assert (sub.n, sub.n_upper, sub.entry, sub.entry_level) == (
            seq.n, seq.n_upper, seq.entry, seq.entry_level), p
        assert _lists(sub.graph, sub.n, sub.n_upper) == _lists(
            seq.graph, seq.n, seq.n_upper), p
        if full:
            for name in ("vectors", "vectors_sq", "neighbors0", "upper_nbrs",
                         "upper_slot", "levels", "deleted"):
                assert torch.equal(getattr(sub.graph, name),
                                   getattr(seq.graph, name)), (p, name)


def test_equal_shards_equal_sequential_and_reference(data, lockstep):
    from tpu_hnsw.config import HnswConfig as JCfg
    from tpu_hnsw.parallel.partition import PartitionedHnswIndex as JPart

    base, _ = data
    assert [s.n for s in lockstep.parts] == [W.MESH_N // P] * P
    _assert_equal_parts(lockstep, base, HnswConfig(**CFG))
    ints = np.round(2 * base).astype(np.float32)
    idx = PartitionedHnswIndex(HnswConfig(**CFG), P, engine="graph",
                               device="cpu").build(ints, mesh="auto")
    jidx = JPart(JCfg(**CFG), P, engine="graph").build(ints)
    for sub, jsub in zip(idx.parts, jidx.parts):
        jg = G.HnswGraph(**{
            f: torch.from_numpy(np.array(getattr(jsub.graph, f)))
            for f in ("vectors", "vectors_sq", "neighbors0", "upper_nbrs",
                      "upper_slot", "levels", "deleted")})
        assert _lists(sub.graph, sub.n, sub.n_upper) == _lists(
            jg, jsub.n, jsub.n_upper)
        assert (sub.entry, sub.entry_level, sub.n_upper) == (
            jsub.entry, jsub.entry_level, jsub.n_upper)
        np.testing.assert_array_equal(sub._global_ids, jsub._global_ids)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_dense_scan_seeding_equals_sequential(data, metric, monkeypatch):
    """Past ROUTE_SCAN_MIN_UPPER (patched to 4) upper elements a partition
    seeds level 0 from its nearest live upper elements, as the sequential
    wave build does."""
    monkeypatch.setattr(HnswIndex, "ROUTE_SCAN_MIN_UPPER", 4)
    base, _ = data
    cfg = HnswConfig(**dict(CFG, metric=metric))
    idx = PartitionedHnswIndex(cfg, P, engine="graph", device="cpu").build(
        base, mesh="auto")
    assert all(s.n_upper >= 4 for s in idx.parts)
    _assert_equal_parts(idx, base, cfg)


def test_unequal_centroid_shards(data):
    base, q = data
    idx = PartitionedHnswIndex(HnswConfig(**CFG), P, router="centroid",
                               route_k=P, engine="graph",
                               device="cpu").build(base, mesh="auto")
    sizes = [s.n for s in idx.parts]
    assert len(set(sizes)) > 1 and sum(sizes) == W.MESH_N
    for sub in idx.parts:
        assert sub.capacity == max(sizes)
        check_invariants(sub)
    _assert_equal_parts(idx, base, HnswConfig(**CFG), full=False)
    gt = FlatIndex(base, Metric.L2, device="cpu").search(q, k=10,
                                                         exact=True)[1]
    d, ids = idx.search(q, k=10, ef_search=64)
    hits = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids, gt)])
    assert hits >= 0.9, hits
    sd, sids = idx.sharded().search(q, k=10, ef_search=64)
    np.testing.assert_array_equal(sids, ids)
    np.testing.assert_allclose(sd, d, rtol=1e-6)


def test_two_ranks_equal_one_process(data, lockstep, tmp_path):
    base, q = data
    want = W.graph_arrays(lockstep)
    want["ids"] = lockstep.search(q, k=10, ef_search=40)[1]
    for out in W.spawn("mesh_build", 2, str(tmp_path)):
        assert set(out) == set(want)
        for key, val in want.items():
            np.testing.assert_array_equal(out[key], val, err_msg=key)


def test_mesh_modes(data, lockstep):
    """One partition builds in sequence; the block engine ignores mesh; a
    string that names no device raises; adds after a lockstep build
    continue the sequential build's level draws."""
    base, q = data
    one = PartitionedHnswIndex(HnswConfig(**CFG), 1, engine="graph",
                               device="cpu").build(base[:200], mesh="auto")
    assert one.parts[0].capacity == int(1.2 * 200) + 64
    kw = dict(engine="block", block_size=32, device="cpu")
    blk = PartitionedHnswIndex(HnswConfig(**CFG), P, **kw)
    a = blk.build(base, mesh="auto").search(q, k=10)[1]
    b = PartitionedHnswIndex(HnswConfig(**CFG), P, **kw).build(base).search(
        q, k=10)[1]
    np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError):
        PartitionedHnswIndex(HnswConfig(**CFG), P, device="cpu").build(
            base, mesh="not-a-device")
    sub = lockstep.parts[0]
    seq = _sequential(HnswConfig(**CFG), base[sub._global_ids])
    np.testing.assert_array_equal(sub._draw_levels(50), seq._draw_levels(50))
    with pytest.raises(ValueError, match="multiple"):
        MB.build_partitions_mesh(HnswConfig(**CFG), [base[:10]] * 3,
                                 mesh=_FakeGroup(), device="cpu")


class _FakeGroup:
    """A 1-D DeviceMesh stand-in of two ranks (the check comes before any
    collective)."""

    def get_group(self):
        return self


@pytest.fixture(autouse=True)
def _fake_world(monkeypatch):
    import torch.distributed as dist

    real = dist.get_world_size
    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: 2 if isinstance(group, _FakeGroup)
                        else real(group))
