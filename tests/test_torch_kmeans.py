"""tpu_hnsw_torch.parallel.kmeans against tpu_hnsw.parallel.kmeans.

Both draw the sample, the initial centroids and the empty-cluster refills
with the same numpy RNG calls in the same order, so the centroids
themselves are compared: atol 1e-3, because f32 GEMMs in different
summation orders can flip an argmin near-tie and move a few rows between
clusters.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw.io.datasets import synthetic_clustered
from tpu_hnsw.parallel import kmeans as JKM
from tpu_hnsw_torch.parallel import kmeans as KM

torch.set_num_threads(1)


@pytest.mark.parametrize("k,sample", [(32, None), (48, 2048)])
def test_centroids_match_reference(k, sample):
    base, _ = synthetic_clustered(4096, 32, n_queries=1, seed=7)
    jc, ja = JKM.kmeans(base, k, iters=10, seed=3, sample=sample)
    c, a = KM.kmeans(torch.from_numpy(base), k, iters=10, seed=3,
                     sample=sample)
    np.testing.assert_allclose(c.numpy(), jc, atol=1e-3)
    assert (a.numpy() == ja).mean() >= 0.99


def test_empty_cluster_refill_matches_reference():
    """More clusters (40) than distinct points (24): at least 16 initial
    centroids duplicate another, the argmin's first-index rule leaves them
    empty, and both packages refill them from the same pool draws. Small
    integer coordinates keep every distance exact, so ties break the same
    way on both sides."""
    rng = np.random.default_rng(0)
    pts = rng.integers(-8, 8, size=(24, 16)).astype(np.float32)
    base = pts[rng.integers(0, 24, size=600)]
    jc, _ = JKM.kmeans(base, 40, iters=6, seed=1, sample=None,
                       assign_full=False)
    c, a = KM.kmeans(base, 40, iters=6, seed=1, sample=None,
                     assign_full=False)
    assert a.numel() == 0
    np.testing.assert_allclose(c.numpy(), jc, atol=1e-3)
