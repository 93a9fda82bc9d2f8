"""Sparse vectors: tpu_hnsw_torch.ops.sparse, io/datasets.synthetic_splade
and utils/threefry against the JAX package on the same seeded inputs.

- SparseVecs: canonical arrays, text round trips, casts and error texts
  equal the reference's;
- sparse_distance: both lanes (dense, and merge with the dense bound
  patched down in both packages), all four metrics, rtol 1e-5;
- SparseFlatIndex: ids equal on integer-valued data with duplicate rows
  (ties) and out-of-vocabulary query coordinates, distances within 1e-5;
- synthetic_splade: bit-equal;
- the generator: ``jax.random.bits`` bit-equal, projection rows within
  1e-6 of the reference's ``_proj_rows``.

The JAX package is imported inside the tests, as in test_torch_expand.py.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.io.datasets import synthetic_splade
from tpu_hnsw_torch.ops import sparse as S
from tpu_hnsw_torch.utils import threefry as TF

torch.set_num_threads(1)

METRICS = ["l2", "ip", "cosine", "l1"]


def _messy(seed, n=40, K=12, dim=300):
    """COO rows with -1 padding, unsorted indices, duplicates and zeros."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim, size=(n, K)).astype(np.int64)
    idx[rng.random((n, K)) < 0.2] = -1
    idx[:, 1] = idx[:, 0]  # a duplicate in every row
    val = rng.normal(size=(n, K)).astype(np.float32)
    val[rng.random((n, K)) < 0.1] = 0.0
    return idx, val, dim


def _int_corpus(seed, n=120, K=6, dim=60):
    """Integer-valued rows, each later row a copy of an earlier one (ties
    at every distance), and queries with coordinates no row has."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, dim - 10, size=(n, K)).astype(np.int64)
    val = rng.integers(1, 4, size=(n, K)).astype(np.float32)
    idx[n // 2:], val[n // 2:] = idx[: n - n // 2], val[: n - n // 2]
    qi = rng.integers(0, dim, size=(10, K)).astype(np.int64)
    qi[:, 0] = dim - 1 - np.arange(10) % 10  # out of the corpus vocabulary
    qv = rng.integers(1, 4, size=(10, K)).astype(np.float32)
    return (idx, val), (qi, qv), dim


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparsevecs_canonical_equals_reference(seed):
    from tpu_hnsw.ops import sparse as JS

    idx, val, dim = _messy(seed)
    got, want = S.SparseVecs(idx, val, dim), JS.SparseVecs(idx, val, dim)
    for name in ("indices", "values", "vocab"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)
    assert (got.n, got.nnz_max, got.dim) == (want.n, want.nnz_max, want.dim)
    np.testing.assert_array_equal(got.norms(), want.norms())
    np.testing.assert_array_equal(got.l1_norms(), want.l1_norms())
    assert got.memory_bytes() == want.memory_bytes()
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(got.to_dense_vocab(), want.to_dense_vocab())
    probe = np.array([[-1, 0, 5, 299, 17, 250], [3, 3, -1, 100, 1, 2]])
    np.testing.assert_array_equal(got.rank_indices(probe),
                                  want.rank_indices(probe))
    assert got.to_text() == want.to_text()
    back = S.SparseVecs.from_text(got.to_text())
    jback = JS.SparseVecs.from_text(want.to_text())
    np.testing.assert_array_equal(back.indices, jback.indices)
    np.testing.assert_array_equal(back.values, jback.values)
    dense = want.to_dense()
    for nnz in (None, 4):
        a = S.SparseVecs.from_dense(dense, nnz_max=nnz)
        b = JS.SparseVecs.from_dense(dense, nnz_max=nnz)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)


def test_sparsevecs_errors_equal_reference():
    from tpu_hnsw.ops import sparse as JS

    ok_i, ok_v = np.array([[0, 1]]), np.array([[1.0, 2.0]])
    cases = [
        lambda m: m.SparseVecs(ok_i, ok_v, 0),
        lambda m: m.SparseVecs(ok_i, ok_v, 2_000_000_000),
        lambda m: m.SparseVecs(ok_i, ok_v[:, :1], 5),
        lambda m: m.SparseVecs(np.zeros((1, 16001), np.int64),
                               np.ones((1, 16001), np.float32), 20000),
        lambda m: m.SparseVecs(np.array([[0, 5]]), ok_v, 5),
        lambda m: m.SparseVecs(ok_i, np.array([[1.0, np.nan]]), 5),
        lambda m: m.SparseVecs.from_text("1:2}/5"),
        lambda m: m.SparseVecs.from_text(["{1:2}/5", "{1:2}/6"]),
        lambda m: m.SparseVecs(ok_i, ok_v, 1_000_000).to_dense(),
        lambda m: m.sparse_distance(m.SparseVecs(ok_i, ok_v, 5),
                                    m.SparseVecs(ok_i, ok_v, 6)),
    ]
    for case in cases:
        with pytest.raises(ValueError) as want:
            case(JS)
        with pytest.raises(ValueError) as got:
            case(S)
        assert str(got.value) == str(want.value)
    text = ["{1:1.5,3:-2,10:0.25}/10", "{}/10", "{ 2:3 }/10"]
    a, b = S.SparseVecs.from_text(text), JS.SparseVecs.from_text(text)
    assert a.to_text() == b.to_text() == [
        "{1:1.5,3:-2,10:0.25}/10", "{}/10", "{2:3}/10"]


@pytest.mark.parametrize("lane", ["dense", "merge"])
@pytest.mark.parametrize("metric", METRICS)
def test_sparse_distance_matches_reference(lane, metric, monkeypatch):
    """rtol 1e-5 (f32 sums in other orders), atol 1e-5 for values near 0;
    the merge lane is forced by patching the dense bound to 8 in both
    packages."""
    from tpu_hnsw.config import Metric as JM
    from tpu_hnsw.ops import sparse as JS

    if lane == "merge":
        monkeypatch.setattr(S, "_DENSE_VOCAB_MAX", 8)
        monkeypatch.setattr(JS, "_DENSE_VOCAB_MAX", 8)
    ci, cv, dim = _messy(5, n=50)
    qi, qv, _ = _messy(6, n=9)
    got = S.sparse_distance(S.SparseVecs(qi, qv, dim),
                            S.SparseVecs(ci, cv, dim), Metric(metric),
                            block=16, device="cpu")
    want = JS.sparse_distance(JS.SparseVecs(qi, qv, dim),
                              JS.SparseVecs(ci, cv, dim), JM(metric),
                              block=16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    q, c = S.SparseVecs(qi, qv, dim), S.SparseVecs(ci, cv, dim)
    surface = {"l2": S.sparsevec_l2_distance, "ip": S.sparsevec_inner_product,
               "cosine": S.sparsevec_cosine_distance,
               "l1": S.sparsevec_l1_distance}[metric]
    jq, jc = JS.SparseVecs(qi, qv, dim), JS.SparseVecs(ci, cv, dim)
    jsurface = getattr(JS, surface.__name__)
    np.testing.assert_allclose(surface(q, c, device="cpu"),
                               jsurface(jq, jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lane", ["dense", "merge"])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_index_matches_reference(lane, metric, monkeypatch):
    """Integer data with duplicate rows: ids equal (ties to the lower id),
    distances within 1e-5; row chunks of 7 rows exercise the running
    top-k."""
    from tpu_hnsw.config import Metric as JM
    from tpu_hnsw.ops import sparse as JS

    if lane == "merge":
        monkeypatch.setattr(S, "_DENSE_VOCAB_MAX", 8)
        monkeypatch.setattr(JS, "_DENSE_VOCAB_MAX", 8)
    monkeypatch.setattr(S, "ROW_CHUNK_ELEMS", 7 * 50)
    (ci, cv), (qi, qv), dim = _int_corpus(7)
    flat = S.SparseFlatIndex(S.SparseVecs(ci, cv, dim), Metric(metric),
                             device="cpu")
    d, ids = flat.search(S.SparseVecs(qi, qv, dim), k=12)
    jd, jids = JS.SparseFlatIndex(JS.SparseVecs(ci, cv, dim),
                                  JM(metric)).search(
        JS.SparseVecs(qi, qv, dim), k=12)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dimensions"):
        flat.search(S.SparseVecs(qi, qv, dim + 1))


def test_synthetic_splade_bit_equal():
    from tpu_hnsw.io.datasets import synthetic_splade as ref

    for kw in (dict(n=3000, vocab=700, nnz=16, n_queries=30, seed=5),
               dict(n=500, vocab=30522, nnz=32, n_queries=7, seed=13)):
        got, want = synthetic_splade(**kw), ref(**kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1])
def test_generator_bits_equal_jax(seed):
    import jax
    import jax.numpy as jnp

    key = jax.random.key(seed)
    rows = np.array([0, 1, 2, 77, 30517, 2 ** 20 - 1])
    want = np.stack([np.asarray(jax.random.bits(jax.random.fold_in(key, r),
                                                (300,), jnp.uint32))
                     for r in rows]).astype(np.int64)
    k0, k1 = TF.fold_in(TF.seed_key(seed), torch.from_numpy(rows))
    np.testing.assert_array_equal(TF.random_bits(k0, k1, 300).numpy(), want)


def test_projection_rows_match_reference():
    """Rows within 1e-6 of the reference's table (the normals' erfinv
    matches XLA's polynomial to a few 1e-7; most values are bit-equal)."""
    import jax
    import jax.numpy as jnp

    from tpu_hnsw.index.sparse_ann import _proj_rows
    from tpu_hnsw_torch.index.sparse_ann import proj_rows

    ranks = np.arange(0, 4000, 3)
    for seed, d in ((0, 256), (11, 48)):
        want = np.asarray(_proj_rows(jax.random.key(seed), jnp.asarray(ranks),
                                     d))
        got = proj_rows(seed, torch.from_numpy(ranks), d).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert (got == want).mean() > 0.9
    x = np.linspace(-0.99999, 0.99999, 20001).astype(np.float32)
    np.testing.assert_allclose(
        TF.erfinv_f32(torch.from_numpy(x)).numpy(),
        np.asarray(jax.scipy.special.erfinv(jnp.asarray(x))), atol=1e-6)
