"""tpu_hnsw_torch FlatIndex against tpu_hnsw FlatIndex: the exact oracle
returns the same ids, and the default (scan + exact rerank) path has
recall 1.0 against it."""

import os

import numpy as np
import pytest
import torch

from tpu_hnsw.config import Metric as JMetric
from tpu_hnsw.index.flat import FlatIndex as JFlat
from tpu_hnsw_torch import FlatIndex, Metric
from tpu_hnsw_torch.io.datasets import read_fvecs, read_ivecs, synthetic_clustered
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_ids_match_reference_on_sift_fixture(metric):
    base = read_fvecs(os.path.join(FIX, "sift10k_base.fvecs"))
    q = read_fvecs(os.path.join(FIX, "sift10k_query.fvecs"))
    _, want = JFlat(base, JMetric(metric)).search(q, k=10, exact=True)
    d, got = FlatIndex(base, Metric(metric),
                       device="cpu").search(q, k=10, exact=True)
    np.testing.assert_array_equal(got, want)
    if metric == "l2":  # the fixture's own ground truth
        gt = read_ivecs(os.path.join(FIX, "sift10k_groundtruth.ivecs"))
        assert recall_at_k(got, gt, 10) == 1.0
        assert (np.diff(d, axis=1) >= 0).all()


def _score(d, metric):
    """Operator units -> the f32 score each side computed."""
    d = d.astype(np.float64)
    return d ** 2 if metric == "l2" else d


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_exact_and_default_paths(metric):
    """Synthetic 4096 x 32: exact ids equal the reference's except where
    rows tie within f32 rounding; the default path's recall against the
    exact ids is 1.0. Scores agree within d * eps_f32 * (max|q|^2 +
    max|x|^2), the worst-case rounding of the GEMM form's f32 sums of d
    terms, which the two sides take in different orders."""
    base, q = synthetic_clustered(4096, 32, n_queries=32, seed=2)
    jd, jids = JFlat(base, JMetric(metric)).search(q, k=10, exact=True)
    flat = FlatIndex(base, Metric(metric), device="cpu")
    d, ids = flat.search(q, k=10, exact=True)
    assert (ids != jids).mean() <= 0.01
    if metric == "cosine":
        scale = 2.0  # unit vectors
    else:
        scale = float((base ** 2).sum(1).max() + (q ** 2).sum(1).max())
    err = np.abs(_score(d, metric) - _score(jd, metric))
    assert err.max() <= base.shape[1] * np.finfo(np.float32).eps * scale
    _, fast = flat.search(q, k=10)
    assert recall_at_k(fast, ids, 10) == 1.0


def test_k_above_table_size_pads():
    base, q = synthetic_clustered(20, 8, n_queries=3, seed=4)
    d, ids = FlatIndex(base, device="cpu").search(q, k=30)
    assert ids.shape == (3, 30) and (ids[:, 20:] == -1).all()
    assert np.isinf(d[:, 20:]).all()
    assert sorted(ids[0, :20]) == list(range(20))


def test_flat_index_defaults_to_the_card():
    """With no device a numpy table goes to CUDA; without a card that
    raises instead of running on the CPU (a CPU tensor as well)."""
    base = np.zeros((8, 4), np.float32)
    if torch.cuda.is_available():
        assert FlatIndex(base).device.type == "cuda"
        return
    for table in (base, torch.from_numpy(base)):
        with pytest.raises(RuntimeError, match="CUDA"):
            FlatIndex(table)


def _tie_data(n=500, d=16, nq=24, seed=9):
    """Rows drawn from 10 small-integer patterns: every distance is exact
    in f32 on both sides and ties in groups of ~n/10 rows."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(-3, 4, size=(10, d)).astype(np.float32)
    base = pats[rng.integers(0, 10, size=n)]
    q = pats[rng.integers(0, 10, size=nq)] + rng.integers(
        -1, 2, size=(nq, d)).astype(np.float32)
    return base, q


@pytest.mark.parametrize("metric", ["l2", "ip", "l1"])
def test_exact_ids_match_reference_at_ties(metric, monkeypatch):
    """Integer-valued rows with duplicates: the oracle's ids equal the
    reference's exactly, ties included (lax.top_k keeps the lower row), and
    so do its distances. Tiles of 64 rows and query slices of 5 rows make
    the ties cross tiles and slices."""
    base, q = _tie_data()
    monkeypatch.setattr(JFlat, "BLOCK", 64)
    monkeypatch.setattr(FlatIndex, "BLOCK", 64)
    monkeypatch.setattr(FlatIndex, "QUERY_ELEMS", 5 * 64, raising=False)
    jd, jids = JFlat(base, JMetric(metric)).search(q, k=10, exact=True)
    d, ids = FlatIndex(base, Metric(metric), device="cpu").search(
        q, k=10, exact=True)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)


def test_l1_matches_reference():
    """L1 (``<+>``) flat scan, mirroring tests/test_l1.py:28: random normal
    data, the oracle and the rerank path; ids equal the reference's and
    distances agree within rtol 1e-5, atol 1e-4 (f32 sums of 24 absolute
    differences taken in different orders)."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((500, 24), np.float32)
    q = rng.standard_normal((16, 24), np.float32)
    jf = JFlat(base, JMetric.L1)
    f = FlatIndex(base, Metric.L1, device="cpu")
    for exact in (True, None):
        jd, jids = jf.search(q, k=5, exact=exact)
        d, ids = f.search(q, k=5, exact=exact)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-4)


def test_reference_keywords_accepted():
    """The reference's ``scan_dtype`` and ``block`` keywords: "default"
    scans as before, "int8" is not ported and says so (L1 ignores it, as
    the reference does), anything else is a ValueError; ``block`` is
    ignored."""
    base, q = synthetic_clustered(300, 8, n_queries=4, seed=5)
    want = FlatIndex(base, device="cpu").search(q, k=5)
    flat = FlatIndex(base, scan_dtype="default", device="cpu")
    for got in (flat.search(q, k=5, block=4096), flat.search(q, 5, 0)):
        np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(NotImplementedError, match="Do not port"):
        FlatIndex(base, scan_dtype="int8", device="cpu")
    assert FlatIndex(base, Metric.L1, scan_dtype="int8",
                     device="cpu").scan_dtype == "default"
    with pytest.raises(ValueError, match="scan_dtype"):
        FlatIndex(base, scan_dtype="fp8", device="cpu")
    with pytest.raises(ValueError):
        JFlat(base, scan_dtype="fp8")


def test_tail_holding_block_index_ties_match_reference():
    """A BlockHnswIndex with a spill tail over tie-heavy integer rows (the
    tail rows duplicate block rows): the reference's blocks carried into
    the port, the same rows added to both, then single-stage search of
    every block (p*S = 256, where the reference's top-k is exact
    lax.top_k). Ids and distances equal the reference's, ties included:
    routing, the tail scan and the block/tail merge keep the lower
    position."""
    from tpu_hnsw import BlockHnswIndex as JBlock
    from tpu_hnsw import HnswConfig as JCfg
    from tpu_hnsw_torch import BlockHnswIndex, HnswConfig

    base, q = _tie_data(n=264)
    base, extra = base[:224], base[224:]
    kw = dict(dim=16, m=8, ef_construction=32, seed=1)
    jidx = JBlock(JCfg(**kw), block_size=32).build(base)
    state = {k: np.asarray(getattr(jidx, k)) for k in (
        "blocks", "blocks_sq", "block_ids", "blocks_score", "score_scale",
        "centroids", "centroids_sq")}
    state.update(n=jidx.n, n_blocks=jidx.n_blocks, n_total=jidx.n_total)
    idx = BlockHnswIndex.from_state(HnswConfig(**kw), state, block_size=32,
                                    device="cpu")
    assert idx.n_blocks * 32 == 256
    for ix in (idx, jidx):
        ix.two_stage = False
        ix.add(extra)
    assert idx.tail_n == jidx.tail_n == len(extra)
    jd, jids = jidx.search(q, k=10, probes=jidx.n_blocks)
    d, ids = idx.search(q, k=10, probes=idx.n_blocks)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(d, jd)


def test_block_build_takes_device_data():
    """``BlockHnswIndex.build(data, device_data=tensor)``, the reference's
    keyword: the tensor takes the device build, as build(tensor) does."""
    from tpu_hnsw_torch import BlockHnswIndex, HnswConfig

    base, q = synthetic_clustered(1024, 16, n_queries=8, seed=12)
    cfg = HnswConfig(dim=16, m=8, ef_construction=32)
    x = torch.from_numpy(base)
    got = BlockHnswIndex(cfg, block_size=64, device="cpu").build(
        None, kmeans_iters=5, device_data=x)
    want = BlockHnswIndex(cfg, block_size=64, device="cpu").build(
        x, kmeans_iters=5)
    assert got.build_stats["device_resident_input"]
    torch.testing.assert_close(got.block_ids, want.block_ids, rtol=0, atol=0)
    np.testing.assert_array_equal(got.search(q, k=5, probes=4)[1],
                                  want.search(q, k=5, probes=4)[1])
