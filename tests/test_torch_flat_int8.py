"""FlatIndex(scan_dtype="int8"): tpu_hnsw_torch's int8 flat scan against
tpu_hnsw's (tpu_hnsw/index/flat.py:94-141, 168-227, 258-270).

- recall@10 above 0.99 against the exact oracle, the reference test's
  floor (tests/test_flat.py:44-57), on its rows (synthetic_clustered(6000,
  24)) for L2, IP and cosine, on the sift10k fixture (L2, 64 x 8) and on
  4,096 x 128 rows (L2);
- the int8 table and its per-row scales equal the reference's (cosine:
  within one quantisation step, its rows are normalised by f32 sums taken
  in another order);
- the scan's candidates equal the reference's, IP scores bit for bit and
  L2 scores within the f32 bound that tests/test_torch_flat.py states;
- final ids equal the reference's int8 path up to tied distances, and
  distances agree within that bound;
- L1 ignores the option; ``exact=True`` returns the oracle's ids;
- odd shapes (Q 1 and 5, d 100, N not a multiple of 8, several tiles)
  equal the default scan's results on the CPU, and on the card equal the
  CPU's (the card tests skip here).

The JAX package is imported inside the tests that compare against it, so
the card's machine, which has no JAX, can run the card tests alone:
``python -m pytest --noconftest tests/test_torch_flat_int8.py -m cuda``.
"""

import os

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import FlatIndex, Metric
from tpu_hnsw_torch.index import flat as FL
from tpu_hnsw_torch.io.datasets import read_fvecs, synthetic_clustered
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
EPS = float(np.finfo(np.float32).eps)


def _rows(case):
    if case == "sift10k":
        return (read_fvecs(os.path.join(FIX, "sift10k_base.fvecs")),
                read_fvecs(os.path.join(FIX, "sift10k_query.fvecs")))
    n, d = case
    return synthetic_clustered(n, d, n_queries=32, seed=9)


def _score(d, metric):
    """Operator units -> the f32 score each side computed."""
    d = d.astype(np.float64)
    return d ** 2 if metric == "l2" else d


def _score_bound(base, q, metric):
    """d * eps_f32 * (max|q|^2 + max|x|^2): the worst-case rounding of the
    GEMM form's f32 sums of d terms, taken in different orders."""
    if metric == "cosine":
        return base.shape[1] * EPS * 2.0  # unit vectors
    return base.shape[1] * EPS * float((base ** 2).sum(1).max()
                                       + (q ** 2).sum(1).max())


def _assert_equal_up_to_ties(ids, want, d, want_d, tol):
    """Equal ids but at positions where the two ids' scores ``d`` and
    ``want_d`` (each the exact rerank of its own id) are within ``tol``:
    two rows tied at f32 rounding, ordered or cut at k differently; such
    positions are at most 1%."""
    diff = ids != want
    assert diff.mean() <= 0.01
    assert (np.abs(d - want_d)[diff] <= tol).all()


CASES = [((6000, 24), "l2"), ((6000, 24), "ip"), ((6000, 24), "cosine"),
         ("sift10k", "l2"), ((4096, 128), "l2")]


@pytest.mark.parametrize("case,metric", CASES)
def test_int8_scan_matches_reference(case, metric):
    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.index.flat import FlatIndex as JFlat

    base, q = _rows(case)
    n, dim = base.shape
    i8 = FlatIndex(base, Metric(metric), scan_dtype="int8", device="cpu")
    j8 = JFlat(base, JMetric(metric), scan_dtype="int8")
    assert i8.scan_dtype == j8.scan_dtype == "int8"
    # the table and its scales
    jx = np.asarray(j8._xs8).reshape(-1, j8._xs8.shape[2])
    js = np.asarray(j8._scales).reshape(-1)[:n]
    x8 = i8._xs8.numpy()
    assert x8.shape[0] % FL.INT_MM_ALIGN == 0 == x8.shape[1] % FL.INT_MM_ALIGN
    assert not x8[n:].any() and not x8[:, dim:].any() and not jx[:, dim:].any()
    if metric == "cosine":
        np.testing.assert_allclose(i8._scales[:n].numpy(), js, rtol=1e-6)
        step = np.abs(x8[:n, :dim].astype(int) - jx[:n, :dim])
        assert step.max() <= 1 and (step > 0).mean() <= 1e-3
    else:
        np.testing.assert_array_equal(x8[:n, :dim], jx[:n, :dim])
        np.testing.assert_array_equal(i8._scales[:n].numpy(), js)
    # recall against the exact oracle, which the int8 copy does not change
    oracle = FlatIndex(base, Metric(metric), device="cpu")
    od, want = oracle.search(q, k=10, exact=True)
    ed, got_exact = i8.search(q, k=10, exact=True)
    np.testing.assert_array_equal(got_exact, want)
    np.testing.assert_array_equal(ed, od)
    d, ids = i8.search(q, k=10)
    assert recall_at_k(ids, want, 10) > 0.99
    assert (np.diff(d, axis=1) >= 0).all()
    # the reference's int8 path: ids up to ties, distances within the bound
    jd, jids = j8.search(q, k=10)
    tol = _score_bound(base, q, metric)
    err = np.abs(_score(d, metric) - _score(jd, metric))
    assert err.max() <= tol
    _assert_equal_up_to_ties(ids, jids, _score(d, metric),
                             _score(jd, metric), tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_int8_candidates_match_reference(metric):
    """The scan alone (40 candidates of 6000 x 24 rows): candidate ids equal
    the reference's; IP scores bit for bit (same integer products, the same
    dequantisation order), L2 scores within the f32 bound (the squared
    norms are sums taken in other orders)."""
    import jax.numpy as jnp

    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.index.flat import FlatIndex as JFlat
    from tpu_hnsw.index.flat import _stream_search_int8 as j_scan

    base, q = _rows((6000, 24))
    i8 = FlatIndex(base, Metric(metric), scan_dtype="int8", device="cpu")
    j8 = JFlat(base, JMetric(metric), scan_dtype="int8")
    sc, ids = FL._stream_search_int8(
        torch.from_numpy(q), i8._xs8, i8.vectors_sq, i8._scales, 40,
        Metric(metric), i8._tile, i8.n)
    jsc, jids = j_scan(jnp.asarray(q), j8._xs8, j8._xs_sq, j8._scales,
                       j8._valid, 40, JMetric(metric))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    if metric == "ip":
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    else:
        assert np.abs(sc.numpy() - np.asarray(jsc)).max() <= \
            _score_bound(base, q, metric)


def test_l1_ignores_int8():
    """L1 has no product form: the option is ignored, as in the reference
    (tests/test_flat.py:60-65), and results equal the default scan's."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 8)).astype(np.float32)
    idx = FlatIndex(x, Metric.L1, scan_dtype="int8", device="cpu")
    assert idx.scan_dtype == "default" and idx._xs8 is None
    _, ids = idx.search(x[:4], k=1)
    assert (ids[:, 0] == np.arange(4)).all()
    want = FlatIndex(x, Metric.L1, device="cpu").search(x[:16], k=5)
    got = idx.search(x[:16], k=5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def _odd_case(n, dim, nq, seed=4):
    rng = np.random.default_rng(seed)
    base, _ = synthetic_clustered(n, dim, n_queries=1, seed=seed)
    q = base[rng.integers(0, n, nq)] + rng.normal(
        0, 0.05, (nq, dim)).astype(np.float32)
    return base, q.astype(np.float32)


@pytest.mark.parametrize("nq", [1, 5, 40])
@pytest.mark.parametrize("n,dim", [(1003, 100), (3, 24), (20, 96)])
def test_int8_odd_shapes_equal_default(n, dim, nq, monkeypatch):
    """Rows not a multiple of 8 (the int8 copy pads them; padded rows never
    reach the select), d 24 / 96 / 100, query slices under 17 rows,
    several tiles with a ragged last one (tiles of 256 rows and slices of
    3 queries), k above the table: ids and distances equal the default
    scan's, which reranks the same way."""
    monkeypatch.setattr(FlatIndex, "BLOCK", 256)
    monkeypatch.setattr(FlatIndex, "QUERY_ELEMS", 3 * 256)
    base, q = _odd_case(n, dim, nq)
    for metric in ("l2", "ip", "cosine"):
        want = FlatIndex(base, Metric(metric), device="cpu").search(q, k=10)
        got = FlatIndex(base, Metric(metric), scan_dtype="int8",
                        device="cpu").search(q, k=10)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [1, 5, 1024])
@pytest.mark.parametrize("dim", [24, 96, 100])
def test_int8_scan_on_card_equals_cpu(dim, nq, monkeypatch):
    """The card's int8 scan (``torch._int_mm``) against its CPU run on
    20,003 rows in tiles of 4,096 (a ragged 3,619-row last tile, not a
    multiple of 8): ids equal up to tied distances, distances within the
    f32 bound (norms and normalisation are sums taken in other orders),
    recall@10 against the card's oracle above 0.99."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    monkeypatch.setattr(FlatIndex, "BLOCK", 4096)
    base, q = _odd_case(20_003, dim, nq)
    for metric in ("l2", "ip", "cosine"):
        cpu = FlatIndex(base, Metric(metric), scan_dtype="int8",
                        device="cpu").search(q, k=10)
        card = FlatIndex(base, Metric(metric), scan_dtype="int8",
                         device="cuda")
        d, ids = card.search(q, k=10)
        tol = _score_bound(base, q, metric)
        assert np.abs(_score(d, metric) - _score(cpu[0], metric)).max() <= tol
        _assert_equal_up_to_ties(ids, cpu[1], _score(d, metric),
                                 _score(cpu[0], metric), tol)
        want = FlatIndex(base, Metric(metric), device="cuda").search(
            q, k=10, exact=True)[1]
        assert recall_at_k(ids, want, 10) > 0.99
