"""The stacked partition searchers of tpu_hnsw_torch.parallel.partition
against tpu_hnsw.parallel.partition's on the same data (shapes as
tests/test_torch_partition.py: d = 12, n = 600, P = 4; the reference on a
one-device mesh, never its 8-device mesh builds):

- ``ShardedBlockSearcher`` on a hash and a centroid-with-replicas index:
  ids equal to the reference's, distances to f32 rounding; equal to the
  port's own host loop at exhaustive probes; ring equal to gather; empty
  partitions; the refusal of a spill tail; the released guard; ``stats``;
  ``from_saved`` on directories both packages saved; a 2-rank gloo run
  equal to the one-process run;
- ``ShardedHnswSearcher`` over the reference's graphs carried across with
  ``from_state``.

JAX is imported inside the fixtures and tests that compare with it, so the
card's machine (no JAX) can collect this file and run its card test:
``python -m pytest --noconftest tests/test_torch_sharded.py -m cuda``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import (FlatIndex, HnswConfig, HnswIndex, Metric,
                            PartitionedHnswIndex, ShardedBlockSearcher,
                            ShardedHnswSearcher)
from tpu_hnsw_torch.io.datasets import synthetic_clustered

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(1)

P = W.SHARD_P
BLOCK_KINDS = ["hash_block", "centroid_block"]


def _jax_part(kind, base):
    from tpu_hnsw.config import HnswConfig as JCfg
    from tpu_hnsw.parallel.partition import PartitionedHnswIndex as JPart

    return JPart(JCfg(**W.SHARD_CFG), P, **W.partition_kw(kind)).build(base)


def _one_device():
    import jax

    return jax.make_mesh((1,), ("shard",))


@pytest.fixture(scope="module")
def data():
    return W.sharded_data()


@pytest.fixture(scope="module")
def hash_block(data):
    base, q = data
    return base, q, W.partitioned(base, "hash_block"), \
        _jax_part("hash_block", base)


@pytest.fixture(scope="module")
def centroid_block(data):
    base, q = data
    return base, q, W.partitioned(base, "centroid_block"), \
        _jax_part("centroid_block", base)


@pytest.fixture(scope="module")
def graph(data):
    """The reference's graph partitions, and the port's index over the same
    graphs (``HnswIndex.from_state``) with the same id maps."""
    base, q = data
    jidx = _jax_part("graph", base)
    idx = PartitionedHnswIndex(HnswConfig(**W.SHARD_CFG), P, device="cpu",
                               **W.partition_kw("graph"))
    for js in jidx.parts:
        state = {f: np.asarray(getattr(js.graph, f))
                 for f in ("vectors", "vectors_sq", "neighbors0",
                           "upper_nbrs", "upper_slot", "levels", "deleted")}
        state.update(n=js.n, n_upper=js.n_upper, entry=js.entry,
                     entry_level=js.entry_level)
        sub = HnswIndex.from_state(HnswConfig(**W.SHARD_CFG), state,
                                   device="cpu")
        sub._global_ids = np.asarray(js._global_ids)
        idx.parts.append(sub)
    idx.n = jidx.n
    return base, q, idx, jidx


# ------------------------------------------------------ block searcher


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_block_searcher_matches_reference(kind, request):
    """sharded() serves the reference's one-device ShardedBlockSearcher's
    ids at the index's route_k and at every partition; distances agree to
    f32 rounding (rtol 1e-5: both rerank in f32). search_device returns
    raw scores and int64 ids on the index's device."""
    base, q, idx, jidx = request.getfixturevalue(kind)
    sh, jsh = idx.sharded(), jidx.sharded(_one_device())
    assert isinstance(sh, ShardedBlockSearcher)
    for kw in ({}, {"route_k": P}):
        jd, ji = jsh.search(q, k=10, ef_search=40, **kw)
        d, ids = sh.search(q, k=10, ef_search=40, **kw)
        np.testing.assert_array_equal(ids, ji)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)
    sc, ids = sh.search_device(torch.from_numpy(q), k=10, ef_search=40)
    assert sc.device.type == "cpu" and ids.dtype == torch.int64
    js, _ = jsh.search_device(q, k=10, ef_search=40)
    np.testing.assert_allclose(sc.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_block_searcher_equals_host_loop_at_every_block(kind, request):
    """With every block of every partition probed, the stacked fan-out
    gives the host loop's search_device ids and distances exactly."""
    base, q, idx, _ = request.getfixturevalue(kind)
    hd, hi = idx.search_device(q, k=10, probes=1 << 30)
    d, ids = idx.sharded().search(q, k=10, probes=1 << 30, route_k=P)
    np.testing.assert_array_equal(ids, hi.numpy())
    np.testing.assert_array_equal(d, hd.numpy())


@pytest.mark.parametrize("kind", BLOCK_KINDS + ["graph"])
def test_ring_equals_gather(kind, request):
    """merge="ring" returns the all_gather merge's ids and distances (one
    process: both are the local merge, dedup included)."""
    base, q, idx, _ = request.getfixturevalue(kind)
    sh = idx.sharded()
    d, ids = sh.search(q, k=10, ef_search=40)
    dr, ir = sh.search(q, k=10, ef_search=40, merge="ring")
    np.testing.assert_array_equal(ir, ids)
    np.testing.assert_array_equal(dr, d)
    with pytest.raises(ValueError, match="merge"):
        sh.search(q, k=10, merge="tree")


@pytest.mark.parametrize("engine", ["block", "graph"])
def test_empty_partitions(engine):
    """Fewer rows than partitions leaves partitions empty
    (tests/test_advice_regressions.py:89): they stack as all-dead blocks or
    an empty graph, and the top-1 is the exact nearest row."""
    base, queries = synthetic_clustered(6, 8, n_queries=5, seed=2)
    cfg = HnswConfig(dim=8, m=4, ef_construction=8, wave_size=4, seed=1)
    idx = PartitionedHnswIndex(cfg, 8, router="hash", engine=engine,
                               block_size=4, device="cpu").build(base)
    assert sum(s.n == 0 for s in idx.parts) == 2
    d, ids = idx.sharded().search(queries, k=3, ef_search=8)
    assert d.shape == (5, 3)
    gt = FlatIndex(base, Metric.L2, device="cpu").search(queries, k=3)[1]
    np.testing.assert_array_equal(ids[:, 0], gt[:, 0])


def _small_block(n=300, p=2):
    base, q = synthetic_clustered(n, 12, n_queries=8, seed=5)
    idx = PartitionedHnswIndex(HnswConfig(**W.SHARD_CFG), p, engine="block",
                               block_size=32, device="cpu").build(base)
    return base, q, idx


def test_uncompacted_tail_is_refused():
    """A partition with spill-tail rows cannot be stacked until compact()
    folds them into blocks; then its added rows are found."""
    base, q, idx = _small_block()
    gids = idx.add(base[:4] + 0.01)
    with pytest.raises(ValueError, match="uncompacted tail"):
        idx.sharded()
    idx.compact()
    _, ids = idx.sharded().search(base[:4] + 0.01, k=1, probes=1 << 30)
    np.testing.assert_array_equal(ids[:, 0], gids)


def test_release_guards_the_parent():
    """release_parts_device_state drops the partitions' tensors; the
    searcher still serves the same ids, and per-partition search, DML,
    save and sharded() raise a clear error."""
    base, q, idx = _small_block()
    sh = idx.sharded()
    want = sh.search(q, k=5, ef_search=40)
    sh.release_parts_device_state()
    assert all(s.blocks is None and s.block_ids is None for s in idx.parts)
    got = sh.search(q, k=5, ef_search=40)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    for call in (lambda: idx.search(q, k=5), lambda: idx.search_device(q),
                 lambda: idx.search_iterative(q, k=5),
                 lambda: idx.add(base[:2]), lambda: idx.delete([0]),
                 idx.compact, lambda: idx.save("unused"), idx.sharded):
        with pytest.raises(RuntimeError, match="released"):
            call()


def test_stats(hash_block):
    """stats() has the reference's keys; its bytes are the stacked
    tensors'."""
    base, q, idx, jidx = hash_block
    st, jst = idx.sharded().stats(), jidx.sharded(_one_device()).stats()
    assert set(st) == set(jst)
    assert set(st["memory_bytes"]) == set(jst["memory_bytes"])
    assert st["n"] == len(base) and st["partitions"] == P
    assert st["mesh_devices"] == 1
    b = max(s.n_blocks for s in idx.parts)
    assert st["memory_bytes"]["blocks"] == P * b * 32 * 12 * 4
    assert st["memory_total_bytes"] == sum(st["memory_bytes"].values())


# ------------------------------------------------------------ from_saved


def _from_saved_case(centroid_block, tmp_path, writer: str):
    base, q, idx, jidx = centroid_block
    path = str(tmp_path / writer)
    (jidx if writer == "jax" else idx).save(path)
    return q, idx, path


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_saved_matches_in_memory(centroid_block, tmp_path, writer):
    """from_saved streams each part's blocks.bin in slabs (chunk_bytes of 2
    blocks: many slabs, a short last one) and serves the in-memory
    searcher's ids and distances, from a directory either package saved;
    the B axis is padded to whole slabs and the parent is released."""
    q, idx, path = _from_saved_case(centroid_block, tmp_path, writer)
    want = idx.sharded().search(q, k=10, ef_search=40)
    ld = ShardedBlockSearcher.from_saved(path, chunk_bytes=2 * 32 * 12 * 4,
                                         device="cpu")
    assert ld.blocks.shape[1] % 2 == 0
    assert ld.blocks.shape[1] >= max(s.n_blocks for s in idx.parts)
    d, ids = ld.search(q, k=10, ef_search=40)
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_allclose(d, want[0], rtol=1e-6, atol=1e-6)
    assert ld.stats()["n"] == idx.n
    with pytest.raises(RuntimeError, match="released"):
        ld.parent.search(q, k=5)


def test_from_saved_reads_the_npz_layout(centroid_block, tmp_path):
    """The reference's pre-blob layout (blocks inside blocks.npz, no
    blocks_bin in meta.json) streams to the same results."""
    q, idx, path = _from_saved_case(centroid_block, tmp_path, "port")
    for p in range(P):
        part = os.path.join(path, f"part{p}")
        with open(os.path.join(part, "meta.json")) as f:
            meta = json.load(f)
        bb = meta.pop("blocks_bin")
        blocks = np.fromfile(os.path.join(part, "blocks.bin"),
                             np.dtype(bb["dtype"])).reshape(bb["shape"])
        z = dict(np.load(os.path.join(part, "blocks.npz")))
        np.savez(os.path.join(part, "blocks.npz"), blocks=blocks, **z)
        os.remove(os.path.join(part, "blocks.bin"))
        with open(os.path.join(part, "meta.json"), "w") as f:
            json.dump(meta, f)
    want = idx.sharded().search(q, k=10, ef_search=40)
    d, ids = ShardedBlockSearcher.from_saved(
        path, chunk_bytes=3 * 32 * 12 * 4, device="cpu").search(
            q, k=10, ef_search=40)
    np.testing.assert_array_equal(ids, want[1])
    np.testing.assert_allclose(d, want[0], rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- more ranks


def test_two_ranks_equal_one_process(data, tmp_path):
    """Two gloo ranks, two partitions each (tests/torch_dist_worker.py):
    every index kind gives, on both ranks and with either merge, the ids
    and distances of one process holding all four partitions."""
    base, q = data
    ranks = W.spawn("sharded", 2, str(tmp_path))
    for kind in W.KINDS:
        want = W.sharded_searches(W.partitioned(base, kind).sharded(), q)
        for out in ranks:
            for key, val in want.items():
                np.testing.assert_array_equal(out[f"{kind}_{key}"], val,
                                              err_msg=f"{kind} {key}")


def test_partitions_must_divide_among_ranks(hash_block, monkeypatch):
    """P must be a multiple of the ranks (partition.py:814-818); a group of
    3 ranks over 4 partitions is refused before any collective."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    base, q, idx, _ = hash_block
    with pytest.raises(ValueError, match="multiple"):
        idx.sharded(object())


# -------------------------------------------------------- graph searcher


def test_graph_searcher_matches_reference(graph):
    """Over the reference's own graphs, ShardedHnswSearcher returns the
    reference's ids (descent_ef 1 and 4); distances to f32 rounding."""
    base, q, idx, jidx = graph
    sh, jsh = idx.sharded(), jidx.sharded(_one_device())
    assert isinstance(sh, ShardedHnswSearcher)
    for descent_ef in (1, 4):
        jd, ji = jsh.search(q, k=10, ef_search=40, descent_ef=descent_ef)
        d, ids = sh.search(q, k=10, ef_search=40, descent_ef=descent_ef)
        np.testing.assert_array_equal(ids, ji)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)


def test_graph_searcher_pads_to_the_largest_capacity(graph):
    """Partitions of unequal capacity stack at the largest: sentinels point
    at the common trash row, which reads as nothing, and the id table is
    -1 past each partition's rows."""
    base, q, idx, _ = graph
    sh = idx.sharded()
    cap = sh.cap
    assert cap == max(s.graph.cap for s in idx.parts)
    for lp, sub in enumerate(idx.parts):
        c = sub.graph.cap
        nbr = sh.nbr0[lp, :c + 1]
        assert not (nbr == c).any() or c == cap
        assert (sh.gids[lp, len(sub._global_ids):] == -1).all()
    assert (sh.vectors[:, cap] == 0).all() and not sh.deleted[:, cap].any()


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_stacked_stage1_equals_plain_on_the_card():
    """The one stage-1 launch of a stacked search, at its virtual-query
    shape (int8, IP and L2), returns the plain version's keys exactly; a
    centroid route leaves unrouted partitions at block id -1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_hnsw_torch.index.block import _pad_cols, _quantize_rows
    from tpu_hnsw_torch.ops import distance as D
    from tpu_hnsw_torch.ops import expand as X
    from tpu_hnsw_torch.ops import topk as T

    base, q = W.sharded_data()
    for metric, router in ((Metric.IP, "hash"), (Metric.L2, "centroid")):
        cfg = HnswConfig(**dict(W.SHARD_CFG, metric=metric))
        idx = PartitionedHnswIndex(cfg, P, router=router, route_k=2,
                                   engine="block", block_size=32,
                                   device="cuda").build(base)
        sh = idx.sharded()
        qt = torch.from_numpy(q).cuda()
        sel = sh._selected(qt, 2)
        qt = D.l2_normalize(qt) if metric.needs_normalized else qt
        q_sq = D.squared_norms(qt)
        bids = sh._route(qt, q_sq, sel, 3)
        if router == "centroid":
            assert (bids < 0).any()
        L, b, S = sh.blocks.shape[:3]
        qv = _pad_cols(qt.repeat_interleave(L, 0), sh.blocks_score.shape[3])
        q8, q_scl = _quantize_rows(qv)
        args = (sh.blocks_score.view(L * b, S, -1),
                sh.blocks_sq.view(L * b, S), sh.block_gids.view(L * b, S),
                qv, q_sq.repeat_interleave(L, 0), bids, metric)
        kw = dict(q8=q8, q_scale=q_scl, score_scale=sh.score_scales.view(-1))
        d, pos = X.expand_topr(*args, 40, **kw)
        wd, wpos = X.expand_topr_reference(*args, 40, **kw)
        assert torch.equal(T.score_keys(d, pos), T.score_keys(wd, wpos))
