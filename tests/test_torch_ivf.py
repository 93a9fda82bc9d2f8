"""tpu_hnsw_torch IvfFlatIndex against tpu_hnsw IvfFlatIndex on the same
seeded data: centroids, list layout, probe-search ids (ties included), the
add-after-delete cursor, iterative probes, bf16 storage, and save/load
across both packages in both directions."""

import numpy as np
import pytest
import torch

from tpu_hnsw.config import Metric as JMetric
from tpu_hnsw.index.ivf import IvfFlatIndex as JIvf
from tpu_hnsw_torch import IvfFlatIndex, Metric
from tpu_hnsw_torch.io.datasets import synthetic_clustered

torch.set_num_threads(1)

LISTS = 16


def _tie_data(n=1200, d=16, nq=24, seed=5):
    """Rows from 40 small-integer patterns with duplicates: distances are
    exact in f32 and tie in groups, inside lists and across them."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(-4, 5, size=(40, d)).astype(np.float32)
    base = pats[rng.integers(0, 40, size=n)]
    q = pats[rng.integers(0, 40, size=nq)] + rng.integers(
        -1, 2, size=(nq, d)).astype(np.float32)
    return base, q


def _pair(base, metric="l2", dtype="float32", lists=LISTS):
    return (IvfFlatIndex(base.shape[1], Metric(metric), lists=lists, seed=1,
                         dtype=dtype, device="cpu").build(base),
            JIvf(base.shape[1], JMetric(metric), lists=lists, seed=1,
                 dtype=dtype).build(base))


def _assert_same_lists(idx, jidx):
    np.testing.assert_array_equal(idx.centroids, jidx.centroids)
    np.testing.assert_array_equal(idx.ids_by_list.numpy(),
                                  np.asarray(jidx.ids_by_list))
    np.testing.assert_array_equal(idx.vecs_by_list.float().numpy(),
                                  np.asarray(jidx.vecs_by_list, np.float32))
    np.testing.assert_array_equal(idx._cursor, jidx._cursor)


@pytest.fixture(scope="module")
def ties():
    base, q = _tie_data()
    return (base, q) + _pair(base)


def test_build_layout_matches_reference(ties):
    """Integer rows keep every k-means sum exact: the centroids, the padded
    [lists, maxlen, d] storage, the id table and the cursor are equal."""
    base, q, idx, jidx = ties
    _assert_same_lists(idx, jidx)
    assert idx.ids_by_list.shape[1] % 128 == 0


@pytest.mark.parametrize("probes", [1, 4, LISTS])
def test_probe_search_ids_match_reference_at_ties(ties, probes):
    """Ids and distances equal the reference's exactly at probes 1, 4 and
    every list, ties included (lax.top_k's order at every top-k)."""
    base, q, idx, jidx = ties
    jd, jids = jidx.search(q, k=10, probes=probes)
    d, ids = idx.search(q, k=10, probes=probes)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)
    dd, di = idx.search_device(torch.from_numpy(q), k=10, probes=probes)
    np.testing.assert_array_equal(di.numpy(), ids)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_clustered_data_matches_reference(metric):
    """Float data: the same centroids and lists; ids equal the reference's
    at probes 1, 4 and every list, distances within rtol 1e-5, atol 1e-6
    (the f32 sums of d terms run in different orders)."""
    base, q = synthetic_clustered(1500, 16, n_queries=32, seed=3)
    idx, jidx = _pair(base, metric)
    np.testing.assert_allclose(idx.centroids, jidx.centroids, atol=1e-5)
    np.testing.assert_array_equal(idx.ids_by_list.numpy(),
                                  np.asarray(jidx.ids_by_list))
    for probes in (1, 4, LISTS):
        jd, jids = jidx.search(q, k=10, probes=probes)
        d, ids = idx.search(q, k=10, probes=probes)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-6)


def test_add_after_delete_keeps_live_rows():
    """Mirrors tests/test_advice_regressions.py:134-170 in both packages:
    tombstones mid-list, then adds; the cursor never reuses a slot below a
    live row, the tables equal the reference's, every live row is found."""
    base, _ = synthetic_clustered(440, 8, n_queries=1, seed=17)
    idx = IvfFlatIndex(8, lists=8, seed=3, device="cpu").build(base[:400])
    jidx = JIvf(dim=8, lists=8, seed=3).build(base[:400])
    victims = np.arange(0, 400, 10)
    for ix in (idx, jidx):
        ix.delete(victims)
    assert idx.n == jidx.n == 360
    new_ids = idx.add(base[400:440])
    np.testing.assert_array_equal(new_ids, jidx.add(base[400:440]))
    assert idx.n == 400
    _assert_same_lists(idx, jidx)
    keep = np.setdiff1d(np.arange(400), victims)
    _, got = idx.search(base[keep], k=1, probes=8)
    assert (got[:, 0] == keep).all()
    _, got_new = idx.search(base[400:440], k=1, probes=8)
    assert (got_new[:, 0] == new_ids).all()


def test_add_grows_lists_like_reference():
    """Adds past a list's padded length grow every list by 128 slots."""
    base, _ = synthetic_clustered(700, 8, n_queries=1, seed=19)
    idx = IvfFlatIndex(8, lists=2, seed=3, device="cpu").build(base[:200])
    jidx = JIvf(dim=8, lists=2, seed=3).build(base[:200])
    for ix in (idx, jidx):
        ix.add(base[200:])
    _assert_same_lists(idx, jidx)


def test_search_iterative_matches_reference(ties):
    """Filtered iterative probes: the same ids and distances, every id
    passing the predicate."""
    base, q, idx, jidx = ties
    pred = lambda ids: ids % 7 == 0  # noqa: E731
    d, ids = idx.search_iterative(q, k=5, probes=1, predicate=pred)
    jd, jids = jidx.search_iterative(q, k=5, probes=1, predicate=pred)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)
    assert (ids[ids >= 0] % 7 == 0).all()


def test_bfloat16_storage_matches_reference(ties):
    """bf16 lists: the same bits as the reference's (round to nearest
    even), and the same ids (the tie data is exact in bf16)."""
    base, q, _, _ = ties
    idx, jidx = _pair(base, dtype="bfloat16")
    assert idx.vecs_by_list.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        idx.vecs_by_list.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jidx.vecs_by_list).view(np.uint16))
    for probes in (1, LISTS):
        np.testing.assert_array_equal(idx.search(q, k=10, probes=probes)[1],
                                      jidx.search(q, k=10, probes=probes)[1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_load_across_packages(dtype, tmp_path):
    """A directory saved by either package loads in the other: the same
    lists, ids and search results; the cursor is recovered from the highest
    live slot, so add-after-load clobbers nothing."""
    base, q = _tie_data(n=300)
    idx, jidx = _pair(base[:256], dtype=dtype, lists=4)
    for ix in (idx, jidx):
        ix.delete(np.arange(0, 256, 7))
    idx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    back = IvfFlatIndex.load(str(tmp_path / "j"), device="cpu")
    jback = JIvf.load(str(tmp_path / "t"))
    assert back.dtype == dtype and back.n == jidx.n
    for a, b in ((back, jidx), (idx, jback)):
        np.testing.assert_array_equal(a.ids_by_list.numpy(),
                                      np.asarray(b.ids_by_list))
        np.testing.assert_array_equal(a.search(q, k=10, probes=4)[1],
                                      b.search(q, k=10, probes=4)[1])
    back.add(base[256:])
    jback.add(base[256:])
    np.testing.assert_array_equal(back.ids_by_list.numpy(),
                                  np.asarray(jback.ids_by_list))
    live = back.ids_by_list.numpy()
    live = np.sort(live[live >= 0])
    np.testing.assert_array_equal(
        live, np.setdiff1d(np.arange(300), np.arange(0, 256, 7)))


def test_constructor_checks():
    with pytest.raises(ValueError, match="lists"):
        IvfFlatIndex(8, lists=0, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        IvfFlatIndex(8, dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        IvfFlatIndex(8, device="cpu").search(np.zeros((1, 8), np.float32))
