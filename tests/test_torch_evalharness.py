"""tpu_hnsw_torch.utils.evalharness and io.datasets.load_or_synthesize
against the reference's: ground truth, the steady-state QPS harness (ids,
stats, the sentinel mapping), sweeps, and the named datasets byte for
byte."""

import numpy as np
import pytest
import torch

from tpu_hnsw.config import Metric as JMetric
from tpu_hnsw.io import datasets as JDS
from tpu_hnsw.utils import evalharness as JEH
from tpu_hnsw_torch import (BlockHnswIndex, FlatIndex, HnswConfig, HnswIndex,
                            IvfFlatIndex, Metric)
from tpu_hnsw_torch.io import datasets as DS
from tpu_hnsw_torch.utils import evalharness as EH

torch.set_num_threads(1)

STATS = {"qps_cv", "qps_min", "qps_max", "window_passes", "windows"}


def test_load_or_synthesize_matches_reference():
    """Without data files both packages synthesize the same sift10k
    stand-in, byte for byte; an unknown name raises in both."""
    base, q, gt = DS.load_or_synthesize("sift10k")
    jbase, jq, jgt = JDS.load_or_synthesize("sift10k")
    assert base.shape == (10_000, 128) and q.shape == (100, 128)
    assert gt is None and jgt is None
    assert base.tobytes() == jbase.tobytes() and q.tobytes() == jq.tobytes()
    for mod in (DS, JDS):
        with pytest.raises(ValueError, match="unknown"):
            mod.load_or_synthesize("sift2b")


def test_load_or_synthesize_reads_a_data_dir(tmp_path):
    """Files written with write_fvecs / write_ivecs are read back, ground
    truth included, as the reference reads them; without the ground-truth
    file the third value is None."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((50, 96), np.float32)
    q = rng.standard_normal((5, 96), np.float32)
    gt = rng.integers(0, 50, size=(5, 10)).astype(np.int32)
    DS.write_fvecs(str(tmp_path / "deep10m_base.fvecs"), base)
    DS.write_fvecs(str(tmp_path / "deep10m_query.fvecs"), q)
    DS.write_ivecs(str(tmp_path / "deep10m_groundtruth.ivecs"), gt)
    got = DS.load_or_synthesize("deep10m", str(tmp_path))
    want = JDS.load_or_synthesize("deep10m", str(tmp_path))
    for a, b, c in zip(got, want, (base, q, gt)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    (tmp_path / "deep10m_groundtruth.ivecs").unlink()
    assert DS.load_or_synthesize("deep10m", str(tmp_path))[2] is None


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ground_truth_matches_reference(metric):
    base, q = DS.synthetic_clustered(2000, 16, n_queries=20, seed=4)
    got = EH.ground_truth(base, q, 10, Metric(metric), device="cpu")
    np.testing.assert_array_equal(
        got, JEH.ground_truth(base, q, 10, JMetric(metric)))


def test_measure_qps_returns_the_ids_of_search():
    """On a CPU FlatIndex: the ids of search() over every chunk (70 queries
    at pipeline 2: chunks of 64 and 6), a positive median and every
    stats_out key."""
    base, q = DS.synthetic_clustered(1000, 8, n_queries=70, seed=6)
    flat = FlatIndex(base, device="cpu")
    stats = {}
    qps, ids = EH.measure_qps(flat, q, 10, 0, repeats=3, pipeline=2,
                              min_window_s=0.0, stats_out=stats)
    np.testing.assert_array_equal(ids, flat.search(q, k=10)[1])
    assert qps > 0 and set(stats) == STATS
    assert stats["windows"] == 3 and stats["qps_min"] <= stats["qps_max"]


def test_measure_qps_maps_the_sentinel_and_passes_search_kw():
    """A graph index returns its sentinel for a missing result: the harness
    reports -1, as search() does. IVF's probes reach search_device."""
    base, q = DS.synthetic_clustered(200, 8, n_queries=8, seed=7)
    g = HnswIndex(HnswConfig(dim=8, m=4, ef_construction=16),
                  device="cpu").build(base[:6])
    _, ids = EH.measure_qps(g, q, 8, 16, repeats=1, min_window_s=0.0)
    assert (ids[:, 6:] == -1).all() and (ids[:, :6] >= 0).all()
    np.testing.assert_array_equal(ids, g.search(q, k=8, ef_search=16)[1])
    ivf = IvfFlatIndex(8, lists=4, device="cpu").build(base)
    _, ids = EH.measure_qps(ivf, q, 5, 0, repeats=1, min_window_s=0.0,
                            probes=4)
    np.testing.assert_array_equal(ids, ivf.search(q, k=5, probes=4)[1])


def test_measure_qps_without_search_device():
    """An index with only search() is timed call by call."""
    base, q = DS.synthetic_clustered(300, 8, n_queries=10, seed=8)
    flat = FlatIndex(base, device="cpu")

    class HostOnly:
        def search(self, queries, k, ef_search):
            return flat.search(queries, k=k)

    qps, ids = EH.measure_qps(HostOnly(), q, 5, 0, repeats=2)
    assert qps > 0
    np.testing.assert_array_equal(ids, flat.search(q, k=5)[1])


def test_sweep_and_qps_at_recall():
    """The sweep's rows (ef below k skipped), qps_at_recall's first ef that
    meets the target (every block probed at ef 80: recall 1.0), and its
    best point when the target is out of reach."""
    base, q = DS.synthetic_clustered(2000, 16, n_queries=64, seed=9)
    idx = BlockHnswIndex(HnswConfig(dim=16, m=8, ef_construction=32),
                         block_size=64, device="cpu").build(base)
    gt = EH.ground_truth(base, q, 10, Metric.L2, device="cpu")
    rows = EH.sweep(idx, q, gt, efs=(5, 10, 80))
    assert [r["ef_search"] for r in rows] == [10, 80]
    assert rows[-1]["recall"] == 1.0 and all(r["qps"] > 0 for r in rows)
    first = next(r["ef_search"] for r in rows if r["recall"] >= 1.0)
    qps, r, ef = EH.qps_at_recall(idx, q, gt, target=1.0, efs=(10, 80))
    assert (r, ef) == (1.0, first) and qps > 0
    qps, r, ef = EH.qps_at_recall(idx, q, gt, target=1.01, efs=(80,))
    assert ef == 80 and r == 1.0
