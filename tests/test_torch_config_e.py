"""Config E's serving path (``scripts/config_e_12m5.py``) in both packages:
bf16 cosine parts built one at a time, saved in the script's layout and
served by ``ShardedBlockSearcher.from_saved`` with the bf16 scoring copy
aliasing the blocks, and the ``score_dtype=`` keyword of the port's three
loaders that asks for it.

The reference picks its scoring copy from ``TPU_HNSW_SCORE_DTYPE`` when it
builds and loads (``tpu_hnsw/index/block.py:546-547``,
``tpu_hnsw/parallel/partition.py:962``) and writes no score dtype into
``meta.json``; the port reads the directory's, else int8, unless the caller
names one.

Shapes are the script's cut to four parts of 4,096 rows at d = 128, where
both packages alias a bf16 copy of bf16 rows (the reference pads the copy to
128 lanes, the port to 16 bytes); S = 32, rerank width 128, probes 4 and 8,
so that ``p * S >= 128``.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import (BlockHnswIndex, HnswConfig, Metric,
                            PartitionedHnswIndex, ShardedBlockSearcher)

torch.set_num_threads(1)

P, N_SHARD, DIM, S, SLACK, NQ = 4, 4096, 128, 32, 1.10, 64
RERANK = 128
PROBES = (4, 8)
CFG = dict(dim=DIM, m=16, ef_construction=64, dtype="bfloat16", seed=0)
EPS = float(np.finfo(np.float32).eps)
# returned distances: both packages rerank the same bf16 rows in f32 against
# the same f32 unit query, so they differ by f32 summation order only:
# d * eps on the cosine distance (|q . x| <= 1)
DIST_TOL = DIM * EPS


def _rows(rng, centres, n):
    """The script's recipe (scripts/config_e_12m5.py:62-72): ``4 *
    centre[a] + N(0, 1)`` with ``a`` uniform, unit-normalised."""
    a = rng.integers(0, len(centres), n)
    x = 4.0 * centres[a] + rng.standard_normal((n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(13)
    centres = rng.standard_normal((64, DIM)).astype(np.float32)
    parts = [_rows(np.random.default_rng(1 + p * 1000), centres, N_SHARD)
             for p in range(P)]
    q = _rows(np.random.default_rng(1000), centres, NQ)
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
    return parts, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(
        np.float32)


def _write_layout(path, parts):
    """Each part saved as ``part{p}`` with its ``global_ids.npy``, then
    ``partitioned.json`` and ``router.npz``, as the script writes them
    (scripts/config_e_12m5.py:164-196)."""
    for p, idx in enumerate(parts):
        idx.save(os.path.join(path, f"part{p}"))
        np.save(os.path.join(path, f"part{p}", "global_ids.npy"),
                np.arange(idx.n_total, dtype=np.int32) + p * N_SHARD)
    with open(os.path.join(path, "partitioned.json"), "w") as f:
        json.dump({"p": P, "router": "hash", "route_k": 0,
                   "n": P * N_SHARD, "engine": "block", "block_size": S}, f)
    np.savez(os.path.join(path, "router.npz"), centroids=np.zeros(0),
             part_of=np.zeros(0, np.int32), local_of=np.zeros(0, np.int32))


@pytest.fixture(scope="module")
def reference_dir(data, tmp_path_factory):
    """The reference's parts, built and saved under TPU_HNSW_SCORE_DTYPE=bf16
    in the script's layout."""
    from tpu_hnsw.config import HnswConfig as JCfg
    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.index.block import BlockHnswIndex as JBlock

    path = str(tmp_path_factory.mktemp("config_e_reference"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_HNSW_SCORE_DTYPE", "bf16")
        parts = []
        for rows in data[0]:
            idx = JBlock(JCfg(metric=JMetric.COSINE, **CFG), block_size=S,
                         block_slack=SLACK)
            idx.build(rows)
            assert idx.blocks_score is idx.blocks
            parts.append(idx)
        _write_layout(path, parts)
    return path


def _reference_searcher(path, monkeypatch):
    import jax

    from tpu_hnsw.parallel.partition import ShardedBlockSearcher as JSharded

    monkeypatch.setenv("TPU_HNSW_SCORE_DTYPE", "bf16")
    sh = JSharded.from_saved(path, jax.make_mesh((1,), ("shard",)))
    assert sh.blocks_score is sh.blocks
    sh.rerank_width = RERANK
    return sh


def _exact_distances(ids, q, rows):
    """Cosine distances of the returned ids from the stored bf16 rows in
    f64 (``rows``: the global id -> row table)."""
    x = rows[np.maximum(ids, 0)].astype(np.float64)
    return 1.0 - np.einsum("qkd,qd->qk", x, q.astype(np.float64))


def _stored_rows(path):
    """Global id -> the bf16 row a saved part stores, as f32."""
    rows = np.zeros((P * N_SHARD, DIM), np.float32)
    for sub in PartitionedHnswIndex.load(path, device="cpu").parts:
        bi = sub.block_ids.reshape(-1).numpy()
        x = sub.blocks.float().reshape(-1, DIM).numpy()
        rows[sub._global_ids[bi[bi >= 0]]] = x[bi >= 0]
    return rows


def _assert_equal_up_to_ties(ids, want, d, want_d, q, rows):
    """Ids equal but where the two ids' exact distances tie within
    DIST_TOL (ordered or cut at k differently); returned distances within
    DIST_TOL of each other and of the stored rows' exact distances."""
    assert (ids >= 0).all() and (want >= 0).all()
    np.testing.assert_allclose(d, want_d, rtol=0, atol=DIST_TOL)
    np.testing.assert_allclose(d, _exact_distances(ids, q, rows), rtol=0,
                               atol=DIST_TOL)
    diff = ids != want
    assert diff.mean() <= 0.01
    gap = np.abs(_exact_distances(ids, q, rows)
                 - _exact_distances(want, q, rows))
    assert (gap[diff] <= 2 * DIST_TOL).all()


@pytest.mark.parametrize("probes", PROBES)
def test_bf16_directory_served_as_the_reference(data, reference_dir,
                                                probes, monkeypatch):
    """from_saved(score_dtype="bf16") of the reference's directory aliases
    the bf16 blocks, as the reference does under TPU_HNSW_SCORE_DTYPE=bf16,
    and returns its ids up to tied distances and its distances to f32
    rounding."""
    parts, q = data
    jsh = _reference_searcher(reference_dir, monkeypatch)
    jd, jids = jsh.search(q, k=10, probes=probes)
    sh = ShardedBlockSearcher.from_saved(reference_dir, device="cpu",
                                         score_dtype="bf16")
    assert sh.blocks_score is sh.blocks and sh.score_scales is None
    assert sh.blocks.dtype == torch.bfloat16
    sh.rerank_width = RERANK
    d, ids = sh.search(q, k=10, probes=probes)
    _assert_equal_up_to_ties(ids, jids, d, jd, q,
                             _stored_rows(reference_dir))
    st, jst = sh.stats(), jsh.stats()
    assert st["memory_bytes"]["blocks_score"] == 0
    assert jst["memory_bytes"]["blocks_score"] == 0
    assert st["memory_bytes"]["blocks"] == jst["memory_bytes"]["blocks"]


def test_without_the_keyword_the_directory_decides(reference_dir):
    """The divergence the keyword repairs: the reference's meta.json names
    no score dtype, so the port's loaders, left to the directory, make the
    int8 copy with per-block scales where the reference (under
    TPU_HNSW_SCORE_DTYPE=bf16) aliases the bf16 blocks."""
    sh = ShardedBlockSearcher.from_saved(reference_dir, device="cpu")
    assert sh.blocks_score is not sh.blocks
    assert sh.blocks_score.dtype == torch.int8
    assert sh.score_scales is not None
    assert sh.stats()["memory_bytes"]["blocks_score"] > 0
    part = BlockHnswIndex.load(os.path.join(reference_dir, "part0"),
                               device="cpu")
    assert part.score_dtype == "int8" and part.score_scale is not None
    pidx = PartitionedHnswIndex.load(reference_dir, device="cpu")
    assert all(s.blocks_score.dtype == torch.int8 for s in pidx.parts)
    pidx = PartitionedHnswIndex.load(reference_dir, device="cpu",
                                     score_dtype="bf16")
    assert all(s.blocks_score is s.blocks for s in pidx.parts)


def test_port_built_parts_from_saved_equal_in_memory(data, tmp_path):
    """Parts the port builds with score_dtype = "bf16" and saves in the
    script's layout: from_saved (no keyword: the directory says bf16)
    aliases the blocks and serves the ids and distances of the in-memory
    stacked searcher over the same parts."""
    parts, q = data
    built = []
    for rows in parts:
        idx = BlockHnswIndex(HnswConfig(metric=Metric.COSINE, **CFG),
                             block_size=S, block_slack=SLACK, device="cpu")
        idx.score_dtype = "bf16"
        idx.build(rows)
        assert idx.blocks_score is idx.blocks
        built.append(idx)
    path = str(tmp_path / "port")
    _write_layout(path, built)
    ld = ShardedBlockSearcher.from_saved(path, device="cpu")
    assert ld.blocks_score is ld.blocks
    mem = PartitionedHnswIndex.load(path, device="cpu").sharded()
    assert mem.blocks_score is mem.blocks
    rows = _stored_rows(path)
    for sh in (ld, mem):
        sh.rerank_width = RERANK
    for probes in PROBES:
        want = mem.search(q, k=10, probes=probes)
        d, ids = ld.search(q, k=10, probes=probes)
        np.testing.assert_array_equal(ids, want[1])
        np.testing.assert_allclose(d, want[0], rtol=0, atol=DIST_TOL)
        np.testing.assert_allclose(d, _exact_distances(ids, q, rows),
                                   rtol=0, atol=DIST_TOL)
        assert all(len(set(row)) == len(row) for row in ids)  # distinct


def test_block_load_takes_the_reference_score_dtype(data, reference_dir,
                                                    monkeypatch):
    """BlockHnswIndex.load(score_dtype="bf16") of one reference-saved part
    equals the reference's load under TPU_HNSW_SCORE_DTYPE=bf16: the copy
    aliases the blocks, ids up to ties, distances to f32 rounding."""
    from tpu_hnsw.index.block import BlockHnswIndex as JBlock

    path = os.path.join(reference_dir, "part0")
    monkeypatch.setenv("TPU_HNSW_SCORE_DTYPE", "bf16")
    jidx = JBlock.load(path)
    assert jidx.blocks_score is jidx.blocks
    idx = BlockHnswIndex.load(path, device="cpu", score_dtype="bf16")
    assert idx.score_dtype == "bf16" and idx.blocks_score is idx.blocks
    assert idx.score_scale is None
    rows = _stored_rows(reference_dir)
    for probes in PROBES:
        jd, jids = jidx.search(data[1], k=10, probes=probes)
        d, ids = idx.search(data[1], k=10, probes=probes)
        _assert_equal_up_to_ties(ids, np.asarray(jids), d, np.asarray(jd),
                                 data[1], rows)


def test_loaders_refuse_an_unknown_score_dtype(reference_dir):
    """Each loader takes None, "int8" or "bf16"."""
    part = os.path.join(reference_dir, "part0")
    for load in (lambda: BlockHnswIndex.load(part, device="cpu",
                                             score_dtype="fp8"),
                 lambda: PartitionedHnswIndex.load(
                     reference_dir, device="cpu", score_dtype="f32"),
                 lambda: ShardedBlockSearcher.from_saved(
                     reference_dir, device="cpu", score_dtype="int4")):
        with pytest.raises(ValueError, match="score_dtype"):
            load()


def test_graph_partitions_refuse_a_score_dtype(tmp_path):
    """A graph-engine partitioned index has no scoring copy to name: its
    load refuses the keyword, and loads as before without it."""
    rng = np.random.default_rng(4)
    cfg = HnswConfig(dim=8, m=8, ef_construction=16, seed=0)
    PartitionedHnswIndex(cfg, 2, router="hash", engine="graph",
                         device="cpu").build(
        rng.standard_normal((200, 8)).astype(np.float32)).save(str(tmp_path))
    with pytest.raises(ValueError, match="block-engine"):
        PartitionedHnswIndex.load(str(tmp_path), device="cpu",
                                  score_dtype="bf16")
    assert PartitionedHnswIndex.load(str(tmp_path), device="cpu").n == 200
