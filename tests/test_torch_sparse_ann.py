"""SparseHnswIndex (tpu_hnsw_torch.index.sparse_ann) against the JAX
package's on the same SPLADE-shaped rows (synthetic_splade at 600 rows,
vocabulary 400, 16 coordinates a row, 32-wide sketches). The JAX graph
builds take most of the time, so the graph engine in L2 and cosine and its
save/load are in tests/test_torch_sparse_graph.py, which runs beside this
file:

- the block engine in L2, IP and cosine and the graph engine in IP:
  recall@10 against the exact oracle within 0.02 of the reference's, and
  every returned distance equal to the exact sparse distance of its id
  (rtol 1e-5);
- ``add`` of rows with unseen coordinates extends the vocabulary and the
  projection table by the new ranks only (the old rows stay bit-equal);
- delete, compact and out-of-vocabulary queries;
- a directory saved by either package loads in the other with the same
  ids;
- on the card (``-m cuda``, skipped here): the projection table against
  its CPU rows, and the fused stage-1 kernel at the sparse path's shape
  (d = 256, an int8 copy of bf16 storage) against its plain version.

One build per (engine, metric) in each package, shared by the tests, with
the engines' ``wave_size`` set to 64 in both packages (the JAX graph
builds compile fewer shapes). The JAX package is imported inside fixtures
and tests, so the card's machine can collect this file:
``python -m pytest --noconftest tests/test_torch_sparse_ann.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.index.sparse_ann import SparseHnswIndex, proj_rows
from tpu_hnsw_torch.io.datasets import synthetic_splade
from tpu_hnsw_torch.ops import sparse as S
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

N, VOCAB, NNZ, NQ = 600, 400, 16, 30
KW = dict(m=8, ef_construction=32, block_size=32, proj_dim=32, seed=0)
_BUILT = {}


def _data():
    bi, bv, qi, qv = synthetic_splade(N + 40, vocab=VOCAB, nnz=NNZ,
                                      n_queries=NQ, seed=3)
    return (bi[:N], bv[:N]), (bi[N:], bv[N:]), (qi, qv)


@pytest.fixture(autouse=True)
def waves_of_64(monkeypatch):
    """Both packages' sparse indexes configure their engines with
    wave_size 64."""
    import functools

    import tpu_hnsw.index.sparse_ann as JSA
    import tpu_hnsw_torch.index.sparse_ann as SA

    monkeypatch.setattr(SA, "HnswConfig",
                        functools.partial(SA.HnswConfig, wave_size=64))
    monkeypatch.setattr(JSA, "HnswConfig",
                        functools.partial(JSA.HnswConfig, wave_size=64))


def _pair(engine, metric):
    """(port index, JAX index, base, queries), built once per module."""
    key = (engine, metric)
    if key not in _BUILT:
        from tpu_hnsw.index.sparse_ann import SparseHnswIndex as JSH
        from tpu_hnsw.ops import sparse as JS

        (bi, bv), _, (qi, qv) = _data()
        idx = SparseHnswIndex(metric=metric, engine=engine, device="cpu",
                              **KW).build(S.SparseVecs(bi, bv, VOCAB))
        jidx = JSH(metric=metric, engine=engine, **KW).build(
            JS.SparseVecs(bi, bv, VOCAB))
        _BUILT[key] = (idx, jidx, S.SparseVecs(bi, bv, VOCAB),
                       S.SparseVecs(qi, qv, VOCAB))
    return _BUILT[key]


def _exact(q, base, ids, metric):
    """Exact operator-unit distances of ``ids`` (the merge lane)."""
    full = S.sparse_distance(q, base, Metric(metric), device="cpu")
    d = np.take_along_axis(full, np.clip(ids, 0, None), axis=1)
    return np.sqrt(np.maximum(d, 0)) if metric == "l2" else d


@pytest.mark.parametrize("engine,metric", [
    ("block", "l2"), ("block", "ip"), ("block", "cosine"), ("graph", "ip")])
def test_recall_and_exact_distances_match_reference(engine, metric):
    check_recall_and_distances(engine, metric)


def check_recall_and_distances(engine, metric):
    from tpu_hnsw.config import Metric as JM
    from tpu_hnsw.ops import sparse as JS

    idx, jidx, base, q = _pair(engine, metric)
    (bi, bv), _, (qi, qv) = _data()
    gt = JS.SparseFlatIndex(JS.SparseVecs(bi, bv, VOCAB), JM(metric)).search(
        JS.SparseVecs(qi, qv, VOCAB), k=10)[1]
    d, ids = idx.search(q, k=10, rerank_k=40)
    jd, jids = jidx.search(JS.SparseVecs(qi, qv, VOCAB), k=10, rerank_k=40)
    r, jr = recall_at_k(ids, gt, 10), recall_at_k(jids, gt, 10)
    assert abs(r - jr) <= 0.02 and r >= 0.5, (r, jr)
    assert (ids >= 0).all()
    np.testing.assert_allclose(d, _exact(q, base, ids, metric), rtol=1e-5,
                               atol=1e-5)
    assert (np.diff(d, axis=1) >= 0).all()
    st = idx.stats()
    assert st["sparse_vocab"] == len(base.vocab)
    assert st["sparse_store_bytes"] == 1024 * (2 * NNZ * 4 + 4)


def test_add_extends_vocabulary_prefix_stable():
    """Rows whose coordinates lie past the corpus vocabulary: the rank map
    and R grow by the new ranks only, the old rows of R stay bit-equal,
    the new ones are the generator's rows for their ranks, and each added
    row is found again; the JAX package assigns the same vocabulary."""
    from tpu_hnsw.index.sparse_ann import SparseHnswIndex as JSH
    from tpu_hnsw.ops import sparse as JS

    (bi, bv), _, _ = _data()
    idx = SparseHnswIndex(metric="l2", engine="block", device="cpu",
                          **KW).build(S.SparseVecs(bi, bv, VOCAB + 100))
    jidx = JSH(metric="l2", engine="block", **KW).build(
        JS.SparseVecs(bi, bv, VOCAB + 100))
    vocab0, R0 = idx._vocab.copy(), idx._R.clone()
    rng = np.random.default_rng(9)
    ai = np.sort(rng.choice(np.arange(VOCAB, VOCAB + 100), size=(8, 6)),
                 axis=1)
    ai[:, :2] = bi[:8, :2]  # and some known coordinates
    av = rng.random((8, 6)).astype(np.float32) + 0.5
    new = idx.add(S.SparseVecs(ai, av, VOCAB + 100))
    jnew = jidx.add(JS.SparseVecs(ai, av, VOCAB + 100))
    np.testing.assert_array_equal(new, jnew)
    np.testing.assert_array_equal(idx._vocab, jidx._vocab)
    np.testing.assert_array_equal(idx._vocab[:len(vocab0)], vocab0)
    assert len(idx._vocab) > len(vocab0)
    assert torch.equal(idx._R[:len(vocab0)], R0)
    fresh = torch.arange(len(vocab0), len(idx._vocab))
    assert torch.equal(idx._R[len(vocab0):],
                       proj_rows(KW["seed"], fresh, KW["proj_dim"]))
    d, ids = idx.search(S.SparseVecs(ai, av, VOCAB + 100), k=1,
                        probes=idx.inner.n_blocks)
    np.testing.assert_array_equal(ids[:, 0], new)
    np.testing.assert_allclose(d[:, 0], 0.0, atol=1e-3)


@pytest.mark.parametrize("engine", ["block", "graph"])
def test_delete_compact_and_oov_queries(engine):
    """Deleted ids never return, before or after compact; queries with
    coordinates no row has get exact distances that count that mass (L2),
    the oracle's."""
    from tpu_hnsw.config import Metric as JM
    from tpu_hnsw.ops import sparse as JS

    (bi, bv), _, (qi, qv) = _data()
    idx = SparseHnswIndex(metric="l2", engine=engine, device="cpu",
                          **KW).build(S.SparseVecs(bi, bv, VOCAB + 50))
    qi = qi.copy()
    qi[:, -1] = VOCAB + 7 + np.arange(NQ) % 40  # out of the vocabulary
    qv = np.where(qi >= 0, np.maximum(qv, 0.5), 0.0).astype(np.float32)
    q = S.SparseVecs(qi, qv, VOCAB + 50)
    base = S.SparseVecs(bi, bv, VOCAB + 50)
    d, ids = idx.search(q, k=10, rerank_k=60)
    np.testing.assert_allclose(d, _exact(q, base, ids, "l2"), rtol=1e-5)
    gd = JS.SparseFlatIndex(JS.SparseVecs(bi, bv, VOCAB + 50),
                            JM.L2).search(JS.SparseVecs(qi, qv, VOCAB + 50),
                                          k=1)[0]
    assert (d[:, 0] >= gd[:, 0] - 1e-5).all()
    gone = np.unique(ids[:, :3])
    idx.delete(gone)
    _, after = idx.search(q, k=10, rerank_k=60)
    assert not np.isin(after, gone).any()
    idx.compact()
    d2, after = idx.search(q, k=10, rerank_k=60)
    assert not np.isin(after, gone).any() and (after >= 0).all()
    np.testing.assert_allclose(d2, _exact(q, base, after, "l2"), rtol=1e-5)


def test_save_load_across_packages(tmp_path):
    check_save_load("block", "ip", tmp_path)


def check_save_load(engine, metric, tmp_path):
    from tpu_hnsw.index.sparse_ann import SparseHnswIndex as JSH
    from tpu_hnsw.ops import sparse as JS

    idx, jidx, base, q = _pair(engine, metric)
    jq = JS.SparseVecs(q.indices, q.values, VOCAB)
    want_d, want = idx.search(q, k=10, rerank_k=40)
    idx.save(str(tmp_path / "t"))
    jidx.save(str(tmp_path / "j"))
    back = SparseHnswIndex.load(str(tmp_path / "t"), device="cpu")
    d, ids = back.search(q, k=10, rerank_k=40)
    np.testing.assert_array_equal(ids, want)
    np.testing.assert_allclose(d, want_d, rtol=1e-6)
    jd, jids = JSH.load(str(tmp_path / "t")).search(jq, k=10, rerank_k=40)
    np.testing.assert_array_equal(jids, want)
    np.testing.assert_allclose(jd, want_d, rtol=1e-5, atol=1e-5)
    from_j = SparseHnswIndex.load(str(tmp_path / "j"), device="cpu")
    jwant = jidx.search(jq, k=10, rerank_k=40)[1]
    np.testing.assert_array_equal(from_j.search(q, k=10, rerank_k=40)[1],
                                  jwant)
    np.testing.assert_array_equal(from_j._vocab, jidx._vocab)


def test_bad_arguments():
    with pytest.raises(ValueError, match="l2/ip/cosine"):
        SparseHnswIndex(metric="l1", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        SparseHnswIndex(engine="ivf", device="cpu")
    idx, _, _, q = _pair("block", "ip")
    with pytest.raises(ValueError, match="dimensions"):
        idx.search(S.SparseVecs(q.indices, q.values, VOCAB + 1))
    wide = np.zeros((1, NNZ + 1), np.int64)
    with pytest.raises(ValueError, match="nnz budget"):
        idx.add(S.SparseVecs(wide, np.ones((1, NNZ + 1)), VOCAB))


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_projection_table_on_card():
    """R drawn on the card equals its CPU rows within 1e-6 (the integer
    generator is exact; log1p may differ by an ulp)."""
    dev = _card()
    ranks = torch.arange(0, 30518, 7)
    got = proj_rows(0, ranks.to(dev), 256).cpu()
    want = proj_rows(0, ranks, 256)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_expand_topr_at_the_sparse_shape_on_card():
    """The sparse block engine's stage 1: an int8 copy of bf16 sketches
    (d = 256, IP), r in {50, 100}: keys equal to the plain version's."""
    from tpu_hnsw_torch.index.block import _quantize_rows
    from tpu_hnsw_torch.ops import expand as X
    from tpu_hnsw_torch.ops import topk as T

    dev = _card()
    bi, bv, qi, qv = synthetic_splade(20_000, vocab=30522, nnz=128,
                                      n_queries=64, seed=13)
    idx = SparseHnswIndex(metric="ip", proj_dim=256, block_size=256,
                          device=dev).build(S.SparseVecs(bi, bv, 30522))
    inner = idx.inner
    assert inner.blocks.dtype == torch.bfloat16
    q = S.SparseVecs(qi, qv, 30522)
    r, v, _ = idx._upload_rows(q, idx._rank_of(q.indices, extend=False))
    qt = idx._project(r, v)
    q8, q_scl = _quantize_rows(qt)
    bids = torch.randint(0, inner.n_blocks, (64, 14), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    args = [inner.blocks_score, inner.blocks_sq, inner.block_ids, qt,
            (qt * qt).sum(1), bids, Metric.IP]
    kw = dict(q8=q8, q_scale=q_scl, score_scale=inner.score_scale)
    plain = X.expand_score_reference(*args, **kw)
    for rr in (50, 100):
        d, pos = X.expand_topr(*args, rr, **kw)
        wd, wpos = X.topr_of_scores(plain, rr)
        torch.cuda.synchronize()
        assert torch.equal(T.score_keys(d, pos), T.score_keys(wd, wpos)), rr
