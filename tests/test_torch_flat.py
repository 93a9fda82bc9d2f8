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
