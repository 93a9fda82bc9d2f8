"""tpu_hnsw_torch BinaryHnswIndex (block engine) against tpu_hnsw's, on the
recipe of tests/test_binary_index.py (planted centers + bit flips).

Hamming distances come back as exact integers and jaccard distances from
an exact popcount rerank, so distances are compared exactly; ids are
compared by recall against the BinaryFlatIndex oracle, because hamming
ties everywhere and the packages order tied ids differently.
"""

import contextlib

import numpy as np
import pytest
import torch

from tpu_hnsw.index.binary import BinaryHnswIndex as JBinary
from tpu_hnsw_torch import BinaryFlatIndex, BinaryHnswIndex
from tpu_hnsw_torch.index.binary import unpack_bits
from tpu_hnsw_torch.ops import bitops
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

NBITS = 256
STATE_KEYS = ("blocks", "blocks_sq", "block_ids", "blocks_score",
              "score_scale", "centroids", "centroids_sq")


def _bits(n=4000, nbits=NBITS, nq=64, seed=0):
    """tests/test_binary_index.py's recipe."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2, size=(32, nbits), dtype=np.uint8)
    who = rng.integers(0, 32, size=n)
    flip = rng.random((n, nbits)) < 0.1
    base = centers[who] ^ flip.astype(np.uint8)
    qwho = rng.integers(0, n, size=nq)
    qflip = rng.random((nq, nbits)) < 0.05
    queries = base[qwho] ^ qflip.astype(np.uint8)
    return base, queries


def _popcount_rows(a, b):
    """Exact hamming / jaccard of packed rows a [..., W] and b [..., W]."""
    ta = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    tb = torch.from_numpy(np.ascontiguousarray(b).view(np.int32))
    return bitops.hamming_distance(ta, tb).numpy(), \
        bitops.jaccard_distance(ta, tb).numpy()


def _assert_exact(d, ids, base, queries, metric):
    """Every returned distance equals the exact distance of its id."""
    pb, pq = bitops.pack_bits(base), bitops.pack_bits(queries)
    ok = ids >= 0
    assert ok.all()
    ham, jac = _popcount_rows(pq[:, None, :].repeat(ids.shape[1], 1),
                              pb[ids.astype(np.int64)])
    want = ham.astype(np.float32) if metric == "hamming" else jac
    np.testing.assert_array_equal(d, want)


@contextlib.contextmanager
def _reference_stage1_in_order():
    """The JAX package with lax.top_k in place of its stage-1
    approx_min_k (block.py:212). On the CPU approx_min_k returns the exact
    top-r set but its tied entries in no index order; lax.top_k returns
    the same set ordered by (score, position), as the port's stage 1
    does. Traces are cleared on entry and exit so neither form leaks."""
    import jax

    from tpu_hnsw.ops import topk as JT

    fast = JT.topk_smallest_fast
    JT.topk_smallest_fast = lambda s, k, **_: JT.topk_smallest(s, k)
    jax.clear_caches()
    try:
        yield
    finally:
        JT.topk_smallest_fast = fast
        jax.clear_caches()


@pytest.fixture(scope="module")
def data():
    base, queries = _bits()
    gt = {m: BinaryFlatIndex.from_bits(base, metric=m, device="cpu").search(
        bitops.pack_bits(queries), k=10)[1] for m in ("hamming", "jaccard")}
    return base, queries, gt


@pytest.fixture(scope="module")
def jax_idx(data):
    base, _, _ = data
    return {m: JBinary(NBITS, metric=m, engine="block",
                       block_size=64).build(base)
            for m in ("hamming", "jaccard")}


@pytest.mark.parametrize("metric,floor", [("hamming", 0.9),
                                          ("jaccard", 0.85)])
def test_recall_exact_distances_and_parity_with_jax(data, jax_idx, metric,
                                                    floor):
    """Recall against the exact oracle >= the reference test's floors and
    within 0.05 of the JAX index on the same data (independent builds:
    bf16 vs f32 k-means inputs for jaccard); distances exact.

    Id recall is compared with the reference run in a fixed tie order
    (:func:`_reference_stage1_in_order`), because the order of its stage
    1 decides which of several tied candidates its stage 2 keeps.
    Tie-aware recall (an id whose exact distance is within the oracle's
    10th counts) is compared with the reference as it runs."""
    base, queries, gt = data
    idx = BinaryHnswIndex(NBITS, metric=metric, engine="block",
                          block_size=64, device="cpu").build(base)
    d, ids = idx.search(queries, k=10, probes=16, rerank_k=100)
    jd, _ = jax_idx[metric].search(queries, k=10, probes=16, rerank_k=100)
    with _reference_stage1_in_order():
        jd2, jids = jax_idx[metric].search(queries, k=10, probes=16,
                                           rerank_k=100)
    np.testing.assert_array_equal(jd2, jd)
    r = recall_at_k(ids, gt[metric], 10)
    assert r >= floor
    assert abs(r - recall_at_k(jids, gt[metric], 10)) <= 0.05
    kth = BinaryFlatIndex.from_bits(base, metric=metric, device="cpu").search(
        bitops.pack_bits(queries), k=10)[0][:, 9:10]
    tie, jtie = (d <= kth).mean(), (np.asarray(jd) <= kth).mean()
    assert abs(tie - jtie) <= 0.05
    _assert_exact(d, ids, base, queries, metric)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_search_sends_uint8_bits(data, metric, monkeypatch):
    """Query bits reach the engine as uint8, as build sends them (not the
    reference's host f32 copy, 4x the bytes), and the engine answers as
    it does for that f32 copy: the same ids and distances."""
    base, queries, _ = data
    idx = BinaryHnswIndex(NBITS, metric=metric, engine="block",
                          block_size=64, device="cpu").build(base)
    engine = idx.inner.search_device
    seen = []

    def spy(q, **kw):
        seen.append((q.dtype, kw, engine(q, **kw)))
        return seen[-1][2]

    monkeypatch.setattr(idx.inner, "search_device", spy)
    idx.search(queries, k=10, probes=8, rerank_k=100)
    assert len(seen) == 1 and seen[0][0] == torch.uint8
    want = engine(queries.astype(np.float32), **seen[0][1])
    assert torch.equal(seen[0][2][1], want[1])
    assert torch.equal(seen[0][2][0], want[0])


def test_packed_input_matches_bits_input(data):
    base, queries, _ = data
    a = BinaryHnswIndex(NBITS, engine="block", block_size=64,
                        device="cpu").build(base)
    b = BinaryHnswIndex(NBITS, engine="block", block_size=64,
                        device="cpu").build(
        bitops.pack_bits(base), packed=True)
    da, ia = a.search(queries, k=5, probes=8)
    db, ib = b.search(bitops.pack_bits(queries), k=5, packed=True, probes=8)
    assert np.array_equal(ia, ib) and np.array_equal(da, db)
    assert np.array_equal(unpack_bits(bitops.pack_bits(base), NBITS), base)


@pytest.mark.parametrize("metric,floor", [("hamming", 0.9),
                                          ("jaccard", 0.8)])
def test_add_and_delete(data, metric, floor):
    base, queries, _ = data
    base, queries = base[:2000], queries[:16]
    idx = BinaryHnswIndex(NBITS, metric=metric, engine="block",
                          block_size=64, device="cpu").build(base[:1500])
    ids = idx.add(base[1500:])
    assert (ids == np.arange(1500, 2000)).all() and idx.inner.size == 2000
    oracle = BinaryFlatIndex.from_bits(base, metric=metric, device="cpu")
    _, gt = oracle.search(bitops.pack_bits(queries), k=10)
    d, got = idx.search(queries, k=10, probes=16, rerank_k=100)
    assert recall_at_k(got, gt, 10) >= floor
    _assert_exact(d, got, base, queries, metric)  # rerank rows stay aligned
    victims = np.unique(gt[:, :2])  # block rows and tail rows alike
    idx.delete(victims)
    _, got2 = idx.search(queries, k=10, probes=16, rerank_k=100)
    assert not np.isin(got2, victims).any()


def test_save_load_roundtrip_and_stats(data, tmp_path):
    base, queries, _ = data
    idx = BinaryHnswIndex(NBITS, metric="jaccard", engine="block",
                          block_size=64, device="cpu").build(base[:1500])
    idx.add(base[1500:1510])
    d0, i0 = idx.search(queries, k=5, rerank_k=60, probes=8)
    idx.save(str(tmp_path / "bin"))
    idx2 = BinaryHnswIndex.load(str(tmp_path / "bin"), device="cpu")
    d1, i1 = idx2.search(queries, k=5, rerank_k=60, probes=8)
    assert np.array_equal(i0, i1) and np.array_equal(d0, d1)
    s = idx2.stats()
    assert s["binary_nbits"] == NBITS and s["tail_n"] == 10
    assert s["n"] == 1500 and idx2.n == 1500


def test_graph_engine_raises_not_implemented():
    """The reference's default engine, the graph, once raised and now
    constructs on HnswIndex; an unknown engine still raises."""
    from tpu_hnsw_torch import HnswIndex

    idx = BinaryHnswIndex(NBITS, device="cpu")
    assert idx.engine == "graph" and isinstance(idx.inner, HnswIndex)
    assert idx.inner.cfg.dtype == "bfloat16" and idx.inner.cfg.dim == NBITS
    with pytest.raises(ValueError, match="engine"):
        BinaryHnswIndex(NBITS, engine="ivf", device="cpu")


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_from_state_serves_jax_build_with_equal_distances(data, jax_idx,
                                                          metric):
    """The JAX build's arrays served by the port: distances equal JAX's
    exactly (stage 1 is exact int8 integer dots in both packages, the rerank
    exact), and each returned id has the distance reported at its rank, so
    the ids differ from JAX's only between rows of equal distance."""
    base, queries, _ = data
    j = jax_idx[metric]
    state = {k: np.asarray(getattr(j.inner, k)) for k in STATE_KEYS}
    state.update(n=j.inner.n, n_blocks=j.inner.n_blocks)
    idx = BinaryHnswIndex.from_state(NBITS, metric, state, packed=j._packed,
                                     block_size=64, device="cpu")
    jd, _ = j.search(queries, k=10, probes=8, rerank_k=100)
    d, ids = idx.search(queries, k=10, probes=8, rerank_k=100)
    np.testing.assert_array_equal(d, jd)
    _assert_exact(d, ids, base, queries, metric)


def test_saved_by_jax_loads_in_port_and_back(data, jax_idx, tmp_path):
    """A directory written by tpu_hnsw serves in the port with the same
    distances, and one written by the port loads in tpu_hnsw."""
    base, queries, _ = data
    j = jax_idx["hamming"]
    j.save(str(tmp_path / "j"))
    port = BinaryHnswIndex.load(str(tmp_path / "j"), device="cpu")
    jd, _ = j.search(queries, k=10, probes=8)
    d, ids = port.search(queries, k=10, probes=8)
    np.testing.assert_array_equal(d, jd)
    port.save(str(tmp_path / "p"))
    back = JBinary.load(str(tmp_path / "p"))
    bd, _ = back.search(queries, k=10, probes=8)
    np.testing.assert_array_equal(bd, d)
    assert port.inner.stats()["n"] == back.inner.n == len(base)


def test_binary_index_defaults_to_the_card(monkeypatch):
    """No device means CUDA; without a card construction raises."""
    if torch.cuda.is_available():
        assert BinaryHnswIndex(NBITS,
                               engine="block").inner.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        BinaryHnswIndex(NBITS, engine="block")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert BinaryHnswIndex(NBITS, engine="block").inner.device.type == "cuda"
