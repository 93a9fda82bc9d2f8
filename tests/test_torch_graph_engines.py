"""The graph engine under the other indexes: BlockHnswIndex graph routing
(a centroid HnswIndex) and BinaryHnswIndex(engine="graph"), against
tpu_hnsw's.

- graph routing: the port builds the centroid graph in smaller waves than
  the reference (a reference defect: waves of 1024 over a few thousand
  centroids leave islands), so its recall is held to the reference's or
  better; a saved centroid_graph/ crosses between the packages and routes
  alike (>= 99% of ids, the int8 stage 1 of tests/test_torch_block.py).
- binary graph, hamming: 0/1 lanes make every distance an exact integer,
  so both packages build the same graph and return the same ids and
  distances, ties included.
- binary graph, jaccard: cosine candidates then the exact popcount rerank:
  distances exact, recall within 0.05 of JAX's.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import (BinaryFlatIndex, BinaryHnswIndex, BlockHnswIndex,
                            FlatIndex, HnswConfig, HnswIndex, Metric)
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import bitops
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

NBITS = 64


def _jcfg(cfg):
    import dataclasses

    from tpu_hnsw.config import HnswConfig as JCfg

    c = dataclasses.asdict(cfg)
    c["metric"] = cfg.metric.value
    return JCfg(**c)


@pytest.fixture(scope="module")
def routed():
    """Graph-routed block indexes over 3000 x 16 rows (S=64: 50 blocks) in
    both packages, and the exact ground truth."""
    from tpu_hnsw.index.block import BlockHnswIndex as JBlock

    base, queries = synthetic_clustered(3000, 16, n_queries=64, seed=5)
    cfg = HnswConfig(dim=16, m=8, ef_construction=32, seed=1)
    idx = BlockHnswIndex(cfg, block_size=64, routing="graph",
                         device="cpu").build(base)
    jidx = JBlock(_jcfg(cfg), block_size=64, routing="graph").build(base)
    gt = FlatIndex(base, Metric.L2, device="cpu").search(queries, k=10,
                                                        exact=True)[1]
    return base, queries, idx, jidx, gt


def test_graph_routing_against_jax(routed):
    """The centroid graph is built in waves of at most B/32 (here 50 blocks:
    one centroid a wave, pgvector's sequential build): it equals the
    sequential oracle's graph, where the reference's waves of 1024 build
    another; recall is the reference's or better, and >= 0.95 at 16
    probes."""
    from tpu_hnsw_torch.index.ref_impl import RefHnsw

    base, queries, idx, jidx, gt = routed
    assert idx.stats()["routing"] == "graph" and idx.n_blocks == 50
    ci = idx.centroid_index
    assert isinstance(ci, HnswIndex) and ci.n == 50
    assert ci.cfg.wave_size == 1 and "centroid_graph_s" in idx.build_stats
    ref = RefHnsw(ci.cfg)
    ref.build(idx.centroids.float().numpy())
    assert (ci.entry, ci.entry_level) == (ref.entry, ref.entry_level)
    for got, want in zip(G.to_ref_lists(ci.graph, ci.n, ci.n_upper),
                         ref.neighbors):
        assert [sorted(x) for x in got] == [sorted(x) for x in want]
    jci = jidx.centroid_index.graph
    assert (np.asarray(jci.neighbors0) != ci.graph.neighbors0.numpy()).any()
    for p in (4, 8, 16):
        _, ids = idx.search(queries, k=10, probes=p)
        _, jids = jidx.search(queries, k=10, probes=p)
        r, jr = recall_at_k(ids, gt, 10), recall_at_k(jids, gt, 10)
        assert r >= jr - 0.005, (p, r, jr)
    assert r >= 0.95


def test_graph_routing_filter_and_compact(routed):
    """A filter rides the graph-routed expansion; compact packs again and
    builds a new centroid graph over the new centroids."""
    import copy

    base, queries, idx0, _, gt = routed
    idx = copy.deepcopy(idx0)
    mask = np.random.default_rng(2).random(3000) < 0.5
    _, ids = idx.search(queries, k=10, probes=16, filter_mask=mask)
    assert (ids >= 0).all() and mask[ids].all()
    old = idx.centroid_index
    idx.delete(np.arange(0, 3000, 7))
    idx.compact()
    assert idx.centroid_index is not old
    assert idx.centroid_index.n == idx.n_blocks
    _, ids = idx.search(queries, k=10, probes=16)
    assert not np.isin(ids, np.arange(0, 3000, 7)).any()


def test_centroid_graph_saves_and_loads_across_packages(routed, tmp_path):
    """centroid_graph/ round-trips: the port loads JAX's directory, its
    centroid graph included, and routes as JAX does (>= 99% of ids, the
    int8 stage 1 of tests/test_torch_block.py); JAX loads the port's
    directory and serves the port's ids."""
    from tpu_hnsw.index.block import BlockHnswIndex as JBlock

    base, queries, idx, jidx, _ = routed
    jidx.save(str(tmp_path / "j"))
    port = BlockHnswIndex.load(str(tmp_path / "j"), device="cpu")
    assert port.routing == "graph" and port.centroid_index.n == 50
    np.testing.assert_array_equal(
        port.centroid_index.graph.neighbors0.numpy(),
        np.asarray(jidx.centroid_index.graph.neighbors0))
    got = port.search(queries, k=10, probes=8)[1]
    assert (got == jidx.search(queries, k=10, probes=8)[1]).mean() >= 0.99
    idx.save(str(tmp_path / "p"))
    assert (tmp_path / "p" / "centroid_graph" / "graph.npz").exists()
    back = JBlock.load(str(tmp_path / "p"))
    np.testing.assert_array_equal(
        np.asarray(back.centroid_index.graph.neighbors0),
        idx.centroid_index.graph.neighbors0.numpy())
    want = idx.search(queries, k=10, probes=8)[1]
    assert (back.search(queries, k=10, probes=8)[1] == want).mean() >= 0.99


def _bits(n=1000, nbits=NBITS, nq=48, seed=0):
    """tests/test_binary_index.py's recipe: planted centres, 10% flips."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2, size=(24, nbits), dtype=np.uint8)
    base = centers[rng.integers(0, 24, size=n)] ^ (
        rng.random((n, nbits)) < 0.1).astype(np.uint8)
    queries = base[rng.integers(0, n, size=nq)] ^ (
        rng.random((nq, nbits)) < 0.05).astype(np.uint8)
    return base, queries


@pytest.fixture(scope="module")
def binary():
    from tpu_hnsw.index.binary import BinaryHnswIndex as JBinary

    base, queries = _bits()
    idx = {m: BinaryHnswIndex(NBITS, metric=m, device="cpu").build(base)
           for m in ("hamming", "jaccard")}
    jidx = {m: JBinary(NBITS, metric=m).build(base)
            for m in ("hamming", "jaccard")}
    return base, queries, idx, jidx


def _exact(ids, base, queries, metric):
    pb = torch.from_numpy(bitops.pack_bits(base).view(np.int32))
    pq = torch.from_numpy(bitops.pack_bits(queries).view(np.int32))
    rows = pb[torch.from_numpy(ids.astype(np.int64))]
    q = pq[:, None, :].expand_as(rows)
    if metric == "hamming":
        return bitops.hamming_distance(q, rows).numpy().astype(np.float32)
    return bitops.jaccard_distance(q, rows).numpy()


def test_binary_graph_hamming_equals_jax(binary):
    """The default engine is the graph; hamming over 0/1 lanes is exact
    integer arithmetic, so the graph, the ids (ties included) and the
    distances equal JAX's, and each distance is its id's popcount."""
    base, queries, idx, jidx = binary
    ix, jx = idx["hamming"], jidx["hamming"]
    assert ix.engine == "graph" and isinstance(ix.inner, HnswIndex)
    np.testing.assert_array_equal(ix.inner.graph.neighbors0.numpy(),
                                  np.asarray(jx.inner.graph.neighbors0))
    for kw in (dict(), dict(ef_search=24, expand=4, descent_ef=4)):
        d, ids = ix.search(queries, k=10, **kw)
        jd, jids = jx.search(queries, k=10, **kw)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_array_equal(d, jd)
        np.testing.assert_array_equal(d, _exact(ids, base, queries,
                                                "hamming"))
    assert (d[:, :, None] == d[:, None, :]).sum(-1).max() > 1  # ties
    oracle = BinaryFlatIndex.from_bits(base, device="cpu")
    gd, _ = oracle.search(bitops.pack_bits(queries), k=10)
    assert (d <= gd[:, 9:10]).mean() >= 0.95  # tie-aware recall


def test_binary_graph_jaccard_exact_and_near_jax(binary):
    base, queries, idx, jidx = binary
    d, ids = idx["jaccard"].search(queries, k=10, rerank_k=100)
    jd, jids = jidx["jaccard"].search(queries, k=10, rerank_k=100)
    np.testing.assert_array_equal(d, _exact(ids, base, queries, "jaccard"))
    gt = BinaryFlatIndex.from_bits(base, metric="jaccard",
                                   device="cpu").search(
        bitops.pack_bits(queries), k=10)[1]
    r, jr = recall_at_k(ids, gt, 10), recall_at_k(jids, gt, 10)
    assert r >= 0.85 and abs(r - jr) <= 0.05, (r, jr)


def test_binary_graph_add_delete_and_save_load_across_packages(binary,
                                                               tmp_path):
    """add and delete on the graph engine, then a bf16 graph saved by the
    port loads in tpu_hnsw and back, with the same ids and distances."""
    import copy

    from tpu_hnsw.index.binary import BinaryHnswIndex as JBinary

    base, queries, idx, _ = binary
    ix = copy.deepcopy(idx["jaccard"])
    extra = base[:50] ^ 1
    ids = ix.add(extra)
    n = len(base)
    assert (ids == np.arange(n, n + 50)).all() and ix.n == n + 50
    victims = ix.search(queries, k=2, rerank_k=60)[1][:, 0]
    ix.delete(victims)
    d0, i0 = ix.search(queries, k=10, rerank_k=60)
    assert not np.isin(i0, victims).any()
    ix.save(str(tmp_path / "p"))
    back = JBinary.load(str(tmp_path / "p"))
    d1, i1 = back.search(queries, k=10, rerank_k=60)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    back.save(str(tmp_path / "j"))
    again = BinaryHnswIndex.load(str(tmp_path / "j"), device="cpu")
    assert again.engine == "graph" and again.inner.graph.vectors.dtype \
        == torch.bfloat16
    d2, i2 = again.search(queries, k=10, rerank_k=60)
    np.testing.assert_array_equal(i2, i0)
    np.testing.assert_array_equal(d2, d0)
