"""tpu_hnsw_torch.ops.distance / topk against tpu_hnsw.ops on the same
seeded inputs.

Tolerance for scores: rtol 1e-5, atol 1e-4 — both sides compute in f32 but
sum in different orders (XLA's dot vs torch's GEMM), and the L2 form
|q|^2+|x|^2-2q.x of norms ~O(30) amplifies the last-bit differences.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_hnsw.config import Metric as JMetric
from tpu_hnsw.ops import distance as JD
from tpu_hnsw.ops import topk as JT
from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-4
METRICS = ["l2", "ip", "cosine"]


def _inputs(seed=0, nq=16, n=200, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    return q, x


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_scores_match_reference(metric):
    q, x = _inputs()
    if metric == "cosine":  # the engines store normalized vectors
        q = np.asarray(JD.l2_normalize(jnp.asarray(q)))
        x = np.asarray(JD.l2_normalize(jnp.asarray(x)))
    want = np.asarray(JD.pairwise_scores(jnp.asarray(q), jnp.asarray(x),
                                         JMetric(metric)))
    got = D.pairwise_scores(torch.from_numpy(q), torch.from_numpy(x),
                            Metric(metric)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS + ["l1"])
def test_batched_scores_match_reference(metric):
    rng = np.random.default_rng(1)
    q = rng.normal(size=(8, 32)).astype(np.float32)
    v = rng.normal(size=(8, 20, 32)).astype(np.float32)
    want = np.asarray(JD.batched_scores(jnp.asarray(q), jnp.asarray(v),
                                        JMetric(metric)))
    got = D.batched_scores(torch.from_numpy(q), torch.from_numpy(v),
                           Metric(metric)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", METRICS)
def test_score_to_distance_and_normalize(metric):
    rng = np.random.default_rng(2)
    s = rng.uniform(-2, 5, size=(6, 10)).astype(np.float32)
    want = np.asarray(JD.score_to_distance(jnp.asarray(s), JMetric(metric)))
    got = D.score_to_distance(torch.from_numpy(s), Metric(metric)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    x = rng.normal(size=(6, 32)).astype(np.float32)
    np.testing.assert_allclose(
        D.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(JD.l2_normalize(jnp.asarray(x))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        D.squared_norms(torch.from_numpy(x)).numpy(),
        np.asarray(JD.squared_norms(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("width,k", [(100, 10), (1000, 40)])
def test_topk_matches_reference(width, k):
    """Both widths: <= 256 is lax.top_k in the reference, wider is
    approx_min_k, which returns the exact top-k on CPU. Distinct random
    values, so ids must match exactly."""
    rng = np.random.default_rng(width)
    s = rng.normal(size=(32, width)).astype(np.float32)
    for jfn, fn in ((JT.topk_smallest, T.topk_smallest),
                    (JT.topk_smallest_fast, T.topk_smallest_fast)):
        jv, ji = jfn(jnp.asarray(s), k)
        v, i = fn(torch.from_numpy(s), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("k", [1, 7, 30])
def test_topk_by_index_matches_lax_top_k_on_signed_ties(k):
    """The keyed top-k on signed, tie-heavy scores (no zeros: lax.top_k
    may order -0.0 and +0.0 apart) gives lax.top_k(-d)'s values and its
    order, ties to the lower index."""
    from jax import lax

    rng = np.random.default_rng(k)
    d = (rng.choice([-3, -2, -1, 1, 2, 3], size=(16, 50)) * 0.5
         ).astype(np.float32)
    jv, ji = lax.top_k(-jnp.asarray(d), k)
    v, i = T.topk_smallest_by_index(torch.from_numpy(d), k)
    np.testing.assert_array_equal(v.numpy(), -np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("width", [50, 1500])
def test_topk_by_index_sort_and_keyed_paths_agree(width, monkeypatch):
    """Narrow rows take one stable sort, wide rows the keyed top-k: on
    tie-heavy rows with -0.0, +0.0 and +inf both give the same indices and
    values (equal values to the lower index, -0.0 equal to +0.0)."""
    rng = np.random.default_rng(width)
    d = rng.choice([-1.0, -0.0, 0.0, 0.5, np.inf], size=(8, width)).astype(
        np.float32)
    k = 40
    v, i = T.topk_smallest_by_index(torch.from_numpy(d), k)
    monkeypatch.setattr(T, "STABLE_SORT_MAX",
                        0 if width <= T.STABLE_SORT_MAX else 1 << 20)
    v2, i2 = T.topk_smallest_by_index(torch.from_numpy(d), k)
    assert torch.equal(i, i2) and torch.equal(v, v2)
    # numpy's stable argsort: the (value, index) order
    want = np.argsort(np.where(d == 0, 0.0, d), axis=1, kind="stable")
    np.testing.assert_array_equal(i.numpy(), want[:, :k])
