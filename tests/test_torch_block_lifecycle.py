"""BlockHnswIndex filter, spill tail, mutation, iterative scan and
persistence: tpu_hnsw_torch against tpu_hnsw on the same data.

Mirrors the block cases of tests/test_block.py, tests/test_filtered_search.py,
tests/test_vacuum.py and tests/test_advice_regressions.py, each run through
both packages, plus tests that record where the port fixes a defect of
the reference (ROADMAP queue 3) and so diverges from it on purpose.
"""

import json
import os

import numpy as np
import pytest
import torch

from tpu_hnsw import BlockHnswIndex as JBlock
from tpu_hnsw import HnswConfig as JCfg
from tpu_hnsw_torch import BlockHnswIndex, FlatIndex, HnswConfig, Metric
from tpu_hnsw_torch.index import block as BK
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)


def _data(n=2048, d=32, nq=64, seed=0):
    return synthetic_clustered(n, d, n_queries=nq, seed=seed)


def _pair(base, block_size=64, **cfg):
    """The same index built by both packages (same data and seed)."""
    kw = dict(dim=base.shape[1], m=8, ef_construction=32, **cfg)
    return (BlockHnswIndex(HnswConfig(**kw), block_size=block_size,
                           device="cpu").build(base),
            JBlock(JCfg(**kw), block_size=block_size).build(base))


def _gt(base, queries, k, rows=None):
    """Exact top-k ids over ``rows`` of ``base`` (all rows by default)."""
    rows = np.arange(len(base)) if rows is None else np.asarray(rows)
    _, ids = FlatIndex(base[rows], Metric.L2,
                       device="cpu").search(queries, k=k, exact=True)
    return np.where(ids >= 0, rows[np.clip(ids, 0, None)], -1)


def _sq_tol(base, q):
    """d * eps_f32 * (max|x|^2 + max|q|^2): f32 summation of the L2 form in
    two orders (tests/test_torch_block.py states the bound)."""
    return base.shape[1] * np.finfo(np.float32).eps * float(
        (base ** 2).sum(1).max() + (q ** 2).sum(1).max())


# ------------------------------------------------ tests/test_block.py:92-160


def test_delete_tombstones():
    """Deleted ids never come back. Divergence: the reference counts a
    repeated id twice in ``n`` (block.py:1538); the port deduplicates."""
    base, queries = _data()
    idx, jidx = _pair(base)
    _, ids0 = idx.search(queries, k=5, probes=idx.n_blocks)
    victims = np.unique(ids0[ids0 >= 0])[:50]
    twice = np.concatenate([victims, victims])
    for ix in (idx, jidx):
        ix.delete(twice)
        _, ids1 = ix.search(queries, k=5, probes=ix.n_blocks)
        assert not np.isin(ids1[ids1 >= 0], victims).any()
    assert idx.size == 2048 - len(victims)
    assert jidx.size == 2048 - 2 * len(victims)  # the reference's count
    idx.delete(np.concatenate([victims, [-3, 99999]]))  # no-op
    assert idx.size == 2048 - len(victims)


def test_add_tail_and_compact():
    base, queries = _data()
    idx, jidx = _pair(base[:1536], seed=3)
    gt = _gt(base, queries, 10)
    for ix in (idx, jidx):
        new_ids = ix.add(base[1536:])
        assert ix.size == 2048 and (new_ids == np.arange(1536, 2048)).all()
        _, ids = ix.search(queries, k=10, probes=ix.n_blocks)
        assert recall_at_k(ids, gt, 10) == 1.0  # tail scanned exactly
        ix.compact()
        assert ix.tail_n == 0 and ix.size == 2048
        _, ids2 = ix.search(queries, k=10, probes=ix.n_blocks)
        assert recall_at_k(ids2, gt, 10) == 1.0
    assert idx.n_blocks == jidx.n_blocks


def test_delete_then_compact_reclaims():
    base, _ = _data()
    idx, jidx = _pair(base)
    for ix in (idx, jidx):
        ix.delete(np.arange(0, 1024))
        ix.compact()
        assert ix.size == 1024
        assert ix.n_blocks <= (1024 + 63) // 64 + 1
        _, ids = ix.search(base[1500:1504], k=1, probes=ix.n_blocks)
        assert (ids[:, 0] == np.arange(1500, 1504)).all()


def test_save_load_roundtrip(tmp_path):
    """bf16 store with a spill tail: identical ids, distances within f32
    rounding, in each package and across them."""
    base, queries = _data()
    idx, jidx = _pair(base, dtype="bfloat16")
    extra = np.random.default_rng(0).normal(size=(10, 32)).astype(np.float32)
    for ix in (idx, jidx):
        ix.add(extra)
    d0, i0 = idx.search(queries, k=10, probes=8)
    idx.save(str(tmp_path / "p"))
    idx2 = BlockHnswIndex.load(str(tmp_path / "p"), device="cpu")
    d1, i1 = idx2.search(queries, k=10, probes=8)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(d0, d1)
    assert idx2.size == idx.size == 2058
    # the port's directory in tpu_hnsw, and tpu_hnsw's in the port
    j_of_p = JBlock.load(str(tmp_path / "p"))
    jd, ji = j_of_p.search(queries, k=10, probes=8)
    assert (ji == i0).mean() >= 0.99
    jidx.save(str(tmp_path / "j"))
    p_of_j = BlockHnswIndex.load(str(tmp_path / "j"), device="cpu")
    jd0, ji0 = jidx.search(queries, k=10, probes=8)
    pd, pi = p_of_j.search(queries, k=10, probes=8)
    same = pi == ji0
    assert same.mean() >= 0.99 and p_of_j.size == jidx.size
    tol = _sq_tol(base, queries)
    assert np.abs(pd[same].astype(np.float64) ** 2
                  - jd0[same].astype(np.float64) ** 2).max() <= tol
    np.testing.assert_array_equal(
        p_of_j.block_ids.numpy(), np.asarray(jidx.block_ids))


def test_lazy_slot_map_delete_add_save(tmp_path):
    """tests/test_block.py:248: the id -> slot map is made lazily, and
    delete, add and save make it when they need it."""
    base, queries = _data()
    idx = BlockHnswIndex(HnswConfig(dim=32, m=8, ef_construction=32, seed=2),
                         block_size=64, device="cpu").build(base)
    assert idx._slot_of is None
    victim = int(_gt(base, queries[:1], 5)[0, 0])
    idx.delete([victim])
    _, ids = idx.search(queries[:1], k=5, probes=idx.n_blocks)
    assert victim not in ids[0] and idx.n == 2047
    new_ids = idx.add(base[:3])
    assert len(new_ids) == 3 and idx.tail_live == 3
    idx.save(str(tmp_path / "blk"))
    idx2 = BlockHnswIndex.load(str(tmp_path / "blk"), device="cpu")
    np.testing.assert_array_equal(idx.search(queries, k=5, probes=8)[1],
                                  idx2.search(queries, k=5, probes=8)[1])


# ---------------------------------------- tests/test_filtered_search.py:54-93


@pytest.fixture(scope="module")
def fdata():
    base, queries = synthetic_clustered(6000, 32, n_queries=48, seed=11)
    mask = np.random.default_rng(0).random(len(base)) < 0.2
    return base, queries, mask


def test_block_filtered_search(fdata):
    base, queries, mask = fdata
    kw = dict(dim=32, m=16, ef_construction=64, seed=0)
    idx = BlockHnswIndex(HnswConfig(**kw), block_size=64,
                         device="cpu").build(base)
    jidx = JBlock(JCfg(**kw), block_size=64).build(base)
    gt = _gt(base, queries, 10, np.where(mask)[0])
    recs = []
    for ix in (idx, jidx):
        _, ids = ix.search(queries, k=10, ef_search=128, filter_mask=mask)
        assert (ids >= 0).all() and mask[ids].all()
        recs.append(recall_at_k(ids, gt, 10))
    assert recs[0] >= 0.8 and abs(recs[0] - recs[1]) <= 0.02
    # an id list and a bool tensor filter the same way
    _, a = idx.search(queries, k=10, ef_search=128, filter_mask=mask)
    _, b = idx.search(queries, k=10, ef_search=128,
                      filter_mask=np.where(mask)[0])
    _, c = idx.search(queries, k=10, ef_search=128,
                      filter_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    # no passing row: nothing comes back
    d, ids = idx.search(queries, k=5, filter_mask=np.zeros(6000, bool))
    assert (ids == -1).all() and np.isinf(d).all()


@pytest.mark.parametrize("two_stage", [True, False])
def test_block_filtered_tail_and_exhaustive(fdata, two_stage):
    """Filtered rows never come back from the blocks, the spill tail or
    the exhaustive scan (with its threshold lowered so probes >= n_blocks
    takes it); when few rows pass, the stage-2 re-mask keeps top-r's
    disallowed positions out."""
    base, queries, mask = fdata
    kw = dict(dim=32, m=16, ef_construction=64, seed=0)
    idx = BlockHnswIndex(HnswConfig(**kw), block_size=64,
                         device="cpu").build(base[:5000])
    idx.two_stage = two_stage
    idx.add(base[5000:])
    gt = _gt(base, queries, 10, np.where(mask)[0])
    _, ids = idx.search(queries, k=10, ef_search=128, filter_mask=mask)
    assert mask[ids[ids >= 0]].all()
    idx.EXHAUSTIVE_SCAN_MIN_BLOCKS = 0
    _, ids2 = idx.search(queries, k=10, probes=idx.n_blocks, filter_mask=mask)
    assert (ids2 >= 0).all() and mask[ids2].all()
    assert recall_at_k(ids2, gt, 10) == 1.0
    few = np.zeros(6000, bool)
    few[[3, 5000, 5001]] = True  # one block row, two tail rows
    _, ids3 = idx.search(queries, k=10, probes=4, filter_mask=few)
    assert set(ids3[ids3 >= 0].tolist()) <= {3, 5000, 5001}
    assert {5000, 5001} <= set(ids3[0].tolist())


def test_tail_only_index_serves(fdata):
    """An index built empty serves its spill tail alone (n_blocks == 0)."""
    base, queries, mask = fdata
    idx = BlockHnswIndex(HnswConfig(dim=32, m=8, ef_construction=32),
                         device="cpu")
    idx.build(np.zeros((0, 32), np.float32))
    idx.add(base[:300])
    _, ids = idx.search(queries, k=5, filter_mask=mask)
    np.testing.assert_array_equal(
        ids, _gt(base[:300], queries, 5, np.where(mask[:300])[0]))


# ---------------------------------------------- tests/test_vacuum.py:185-237


def test_block_iterative_scan_filtered():
    base, queries = synthetic_clustered(4000, 16, n_queries=24, seed=41)
    idx, jidx = _pair(base, seed=1)
    pred = lambda ids: ids % 10 == 0  # noqa: E731
    passing = np.arange(0, 4000, 10)
    gt = _gt(base, queries, 5, passing)
    recs = []
    for ix in (idx, jidx):
        d, ids = ix.search_iterative(queries, k=5, ef_search=10,
                                     predicate=pred)
        valid = ids >= 0
        assert valid.sum() >= 0.8 * ids.size and (ids[valid] % 10 == 0).all()
        recs.append(recall_at_k(np.where(valid, ids, -1), gt, 5))
        assert (np.diff(np.where(valid, d, np.inf), axis=1) >= -1e-5).all()
    assert recs[0] >= 0.7 and abs(recs[0] - recs[1]) <= 0.05
    # unfiltered iterative == plain search top-k set at the same point
    d0, i0 = idx.search_iterative(queries, k=5, ef_search=40)
    _, i1 = idx.search(queries, k=5, ef_search=40)
    same = sum(set(a.tolist()) == set(b.tolist()) for a, b in zip(i0, i1))
    assert same >= int(0.9 * len(i0))


def test_block_iterative_scan_max_probes_bounds():
    base, queries = synthetic_clustered(2000, 16, n_queries=4, seed=43)
    idx, _ = _pair(base, seed=1)
    d, ids = idx.search_iterative(queries, k=5, ef_search=10,
                                  predicate=lambda ids: ids < 0,
                                  max_probes=4)
    assert (ids == -1).all() and np.isinf(d).all()


def test_block_iterative_scan_covers_tail():
    base, _ = synthetic_clustered(1200, 16, n_queries=1, seed=44)
    idx, jidx = _pair(base[:1000], seed=1)
    for ix in (idx, jidx):
        new_ids = ix.add(base[1000:])
        _, ids = ix.search_iterative(base[1000:1004], k=1)
        np.testing.assert_array_equal(ids[:, 0], new_ids[:4])


# ----------------------------------------- tests/test_advice_regressions.py:177


def test_block_index_empty_state_is_safe():
    cfg = dict(dim=8, m=4, ef_construction=8)
    for ix in (BlockHnswIndex(HnswConfig(**cfg), device="cpu"),
               JBlock(JCfg(**cfg))):
        assert ix.size == 0 and ix.stats()["n"] == 0
        ix.delete([3, 5])  # no-op
        with pytest.raises(ValueError, match="empty"):
            ix.search(np.zeros((1, 8), np.float32), k=1)


# ----------------------------- divergences: reference defects fixed in the port


def test_save_raises_on_short_blob_write(tmp_path, monkeypatch):
    """The reference's save ignores blob_write's result (block.py:1629), so
    a short write leaves a truncated blocks.bin behind a successful save.
    The port checks the file holds every byte and raises otherwise."""
    base, _ = _data(n=512)
    idx = BlockHnswIndex(HnswConfig(dim=32, m=8, ef_construction=32),
                         block_size=64, device="cpu").build(base)
    real = os.path.getsize
    monkeypatch.setattr(BK.os.path, "getsize",
                        lambda p: real(p) - 1 if p.endswith(".bin")
                        else real(p))
    with pytest.raises(OSError, match="short write"):
        idx.save(str(tmp_path / "x"))


def test_block_slack_persists(tmp_path):
    """The reference drops block_slack at save (block.py:1646), so a loaded
    index maps ef_search onto another probe count. The port writes it into
    meta.json; a directory without it (tpu_hnsw's) loads with 1.05."""
    base, queries = _data(n=1024)
    cfg = dict(dim=32, m=8, ef_construction=32)
    idx = BlockHnswIndex(HnswConfig(**cfg), block_size=64,
                         block_slack=1.5, device="cpu").build(base)
    idx.save(str(tmp_path / "p"))
    assert BlockHnswIndex.load(str(tmp_path / "p"),
                               device="cpu").block_slack == 1.5
    assert JBlock.load(str(tmp_path / "p")).block_slack == 1.05  # reference
    j = JBlock(JCfg(**cfg), block_size=64, block_slack=1.5).build(base)
    j.save(str(tmp_path / "j"))
    with open(tmp_path / "j" / "meta.json") as f:
        assert "block_slack" not in json.load(f)
    assert BlockHnswIndex.load(str(tmp_path / "j"),
                               device="cpu").block_slack == 1.05


def test_filtered_iterative_scan_widens_the_tail():
    """The reference reads the spill tail once, at the first width W
    (block.py:1384), so passing tail rows ranked past W among the tail are
    never seen. The port rescans the tail at each widened W and finds
    them. Here the 200 tail rows nearest the query fail the predicate and
    the passing rows are tail rows further out; ef_search=1 starts at 5 of
    the 34 blocks, so W doubles 40 -> 320 before the probes run out."""
    base, queries = _data(n=2048, nq=1)
    idx, jidx = _pair(base, seed=1)
    q = queries[:1]
    rng = np.random.default_rng(5)
    near = q + 0.01 * rng.normal(size=(200, 32)).astype(np.float32)
    far = q + 0.5 * rng.normal(size=(8, 32)).astype(np.float32)
    tail = np.concatenate([near, far]).astype(np.float32)
    passing = np.arange(2048 + 200, 2048 + 208)
    pred = lambda ids: np.isin(ids, passing)  # noqa: E731
    for ix in (idx, jidx):
        ix.add(tail)
    _, ids = idx.search_iterative(q, k=5, ef_search=1, predicate=pred)
    want = _gt(np.concatenate([base, tail]), q, 5, passing)
    np.testing.assert_array_equal(ids, want)
    _, jids = jidx.search_iterative(q, k=5, ef_search=1, predicate=pred)
    assert (jids == -1).all()  # the reference's divergence, recorded


def test_compact_never_reissues_deleted_ids():
    """The reference restarts the id space after the largest live id at
    compact (block.py:1563), so deleting the newest rows and compacting
    hands their ids out again. The port keeps the id space."""
    base, _ = _data(n=1024)
    idx, jidx = _pair(base[:1000])
    got = []
    for ix in (idx, jidx):
        ix.add(base[1000:1010])
        ix.delete(np.arange(1005, 1010))
        ix.compact()
        got.append(ix.add(base[1010:1012]))
    np.testing.assert_array_equal(got[0], [1010, 1011])
    np.testing.assert_array_equal(got[1], [1005, 1006])  # reissued


def test_filter_cache_follows_compact():
    """The reference caches the device filter by (id(mask), n_total,
    tail_n) (block.py:1157); a compact that keeps both counts reuses the
    old layout's slot mask and returns filtered-out ids. The port drops
    the cache whenever the index changes (and holds the mask object, so a
    new mask cannot inherit a dead one's id)."""
    base, queries = _data()
    mask = np.random.default_rng(0).random(2048) < 0.3
    idx, jidx = _pair(base)
    bad = []
    for ix in (idx, jidx):
        ix.search(queries, k=10, probes=8, filter_mask=mask)
        ix.delete(np.arange(100, 600))
        ix.compact()
        _, ids = ix.search(queries, k=10, probes=8, filter_mask=mask)
        bad.append(int((~mask[ids[ids >= 0]]).sum()))
    assert bad[0] == 0
    assert bad[1] > 0  # the reference's divergence, recorded


# -------------------------------------------------- install in bounded steps


def test_chunked_install_equals_unchunked(monkeypatch):
    """The gather, norms, centroid sums, normalisation and finite check run
    in steps of _CHUNK_ELEMS; with a step of a few rows their results equal
    the one-step forms exactly."""
    base, _ = _data(n=1024)
    x = torch.from_numpy(base).to(torch.bfloat16)
    bids = torch.from_numpy(
        np.random.default_rng(1).permutation(np.r_[np.arange(1024),
                                                   -np.ones(256, int)])
        .reshape(20, 64).astype(np.int32))
    whole = (BK._gather_blocks(x, bids, torch.bfloat16),
             BK._block_stats(BK._gather_blocks(x, bids, torch.bfloat16)),
             BK._normalize_rows(x))
    monkeypatch.setattr(BK, "_CHUNK_ELEMS", 3 * 32 * 64 + 5)
    blocks = BK._gather_blocks(x, bids, torch.bfloat16)
    assert torch.equal(blocks, whole[0])
    want = torch.where((bids >= 0)[..., None],
                       x[torch.clamp_min(bids, 0).long()], 0)
    assert torch.equal(blocks, want)
    sq, rowsum = BK._block_stats(blocks)
    bf = blocks.float()
    assert torch.equal(sq, whole[1][0]) and torch.equal(sq, (bf * bf).sum(-1))
    assert torch.equal(rowsum, bf.sum(1))
    assert torch.equal(BK._normalize_rows(x), whole[2])
    assert BK._all_finite(x)
    bad = x.clone()
    bad[700, 3] = torch.inf
    assert not BK._all_finite(bad)


def test_compact_exports_storage_dtype(monkeypatch):
    """compact hands the live rows to the re-pack in the storage dtype (no
    corpus-sized f32 copy of a bf16 store) and lays out exactly what it
    laid out from an f32 copy of the same rows."""
    base, queries = _data()
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, dtype="bfloat16")

    def mutated():
        ix = BlockHnswIndex(cfg, block_size=64,
                            device="cpu").build(base[:1800])
        ix.add(base[1800:])
        ix.delete(np.arange(0, 2048, 7))
        return ix

    ids, vecs = mutated()._export_live()
    assert vecs.dtype == torch.bfloat16
    assert torch.equal(vecs, torch.from_numpy(base).to(torch.bfloat16)[ids])
    got = mutated()
    got.compact()
    export = BlockHnswIndex._export_live
    monkeypatch.setattr(BlockHnswIndex, "_export_live",
                        lambda self: (lambda i, v: (i, v.float()))(
                            *export(self)))
    wide = mutated()
    wide.compact()
    assert got.blocks.dtype == torch.bfloat16
    assert torch.equal(got.block_ids, wide.block_ids)
    assert torch.equal(got.blocks, wide.blocks)
    d1, i1 = got.search(queries, k=10, probes=4)
    d2, i2 = wide.search(queries, k=10, probes=4)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
