"""HnswIndex's lifecycle against tpu_hnsw's: add after build, delete,
compact, vacuum_full, filtered and iterative search, grow, save/load across
the two packages, from_state.

Both packages build the same 800 x 16 rows with the same seed; at this
size their wave builds give equal graphs (checked), so ids, counters and
repair counts are compared exactly and distances to rtol 1e-5.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import HnswConfig, HnswIndex
from tpu_hnsw_torch.io.datasets import synthetic_clustered

torch.set_num_threads(1)

RTOL = 1e-5
CFG = HnswConfig(dim=16, m=8, ef_construction=32, wave_size=64, seed=3,
                 descent_ef=2, expand_per_step=2)


def _jax_index(cfg: HnswConfig, **kw):
    from tpu_hnsw.config import HnswConfig as JCfg
    from tpu_hnsw.index.hnsw import HnswIndex as JIndex

    c = dataclasses.asdict(cfg)
    c["metric"] = cfg.metric.value
    return JIndex(JCfg(**c), **kw)


def _assert_graphs_equal(idx, jidx):
    assert (idx.n, idx.n_upper, idx.entry, idx.entry_level) == (
        jidx.n, jidx.n_upper, jidx.entry, jidx.entry_level)
    for name in ("neighbors0", "upper_nbrs", "upper_slot", "levels",
                 "deleted"):
        np.testing.assert_array_equal(getattr(idx.graph, name).numpy(),
                                      np.asarray(getattr(jidx.graph, name)),
                                      err_msg=name)


def _assert_results_equal(got, want):
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=RTOL,
                               atol=1e-6)
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.fixture(scope="module")
def data():
    return synthetic_clustered(1000, 16, n_queries=48, seed=13)


@pytest.fixture(scope="module")
def built(data):
    base, _ = data
    idx = HnswIndex(CFG, capacity=800, device="cpu").build(base[:800])
    jidx = _jax_index(CFG, capacity=800).build(base[:800])
    return idx, jidx


@pytest.fixture()
def pair(built):
    """Port and JAX indexes over the first 800 rows, copied for each test
    (the port's mutations are in place)."""
    return copy.deepcopy(built[0]), copy.deepcopy(built[1])


def test_add_after_build_grows_and_matches_jax(data, pair):
    """add() past the capacity grows the tables (sentinel re-pointed) and
    inserts in waves: the same graph and search results as JAX's."""
    base, queries = data
    idx, jidx = pair
    _assert_graphs_equal(idx, jidx)
    ids = idx.add(base[800:])
    jids = jidx.add(base[800:])
    np.testing.assert_array_equal(ids, jids)
    assert idx.capacity == jidx.capacity == 1600
    _assert_graphs_equal(idx, jidx)
    for kw in (dict(), dict(ef_search=64, expand=4, descent_ef=4)):
        _assert_results_equal(idx.search(queries, k=10, **kw),
                              jidx.search(queries, k=10, **kw))


def test_add_checkpoints_and_resumes(data, tmp_path):
    """Wave-granular checkpoints (tests/test_vacuum.py:165): add() saves
    every second wave and reports progress after each; a snapshot loads
    and the build finishes on it."""
    base, queries = data
    idx = HnswIndex(CFG, capacity=400, device="cpu")
    seen = []
    ck = str(tmp_path / "ck")
    idx.add(base[:300], checkpoint_every=2, checkpoint_path=ck,
            progress=lambda done, total: seen.append((done, total)))
    assert seen[-1] == (300, 300) and len(seen) >= 2
    resumed = HnswIndex.load(ck, device="cpu")
    assert 0 < resumed.n <= 300 and resumed.n in [d for d, _ in seen]
    resumed.add(base[resumed.n:400])
    assert resumed.n == 400
    assert (resumed.search(queries, k=5, ef_search=40)[1] >= 0).all()


def test_delete_compact_vacuum_match_jax(data, pair):
    """Tombstones (the entry point among them) never come back; compact
    repairs the same lists and leaves the same graph; vacuum_full renumbers
    alike."""
    _, queries = data
    idx, jidx = pair
    victims = np.unique(np.concatenate([
        idx.search(queries, k=3)[1][:, 0], [idx.entry]]))
    idx.delete(victims)
    jidx.delete(victims)
    got, want = idx.search(queries, k=10), jidx.search(queries, k=10)
    _assert_results_equal(got, want)
    assert not np.isin(got[1], victims).any()
    assert idx.compact() == jidx.compact() > 0
    _assert_graphs_equal(idx, jidx)
    _assert_results_equal(idx.search(queries, k=10),
                          jidx.search(queries, k=10))
    np.testing.assert_array_equal(idx.vacuum_full(), jidx.vacuum_full())
    _assert_graphs_equal(idx, jidx)
    got = idx.search(queries, k=10)
    _assert_results_equal(got, jidx.search(queries, k=10))
    assert idx.n == 800 - len(victims) and got[1].max() < idx.n
    idx.delete([-1, 10_000, idx.n])  # outside [0, n): ignored
    assert not idx.graph.deleted.any()


@pytest.mark.parametrize("share,budget", [(0.2, 20000), (0.03, 120)])
def test_search_iterative_matches_jax(data, pair, share, budget):
    """The array-code finalisation returns the reference's per-query loop's
    ids and distances: at a 20% predicate with the default budget (widened
    to the ef cap), and at 3% with a 120-evaluation budget, where queries
    are cut off short of k."""
    _, queries = data
    idx, jidx = pair
    passes = np.random.default_rng(4).random(800) < share
    kw = dict(k=10, ef_search=10, predicate=lambda i: passes[i],
              max_scan_tuples=budget)
    d, ids = idx.search_iterative(queries, **kw)
    jd, jids = jidx.search_iterative(queries, **kw)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(d, jd, rtol=RTOL, atol=1e-6)
    got = ids[ids >= 0]
    assert passes[got].all() and np.isfinite(d[ids >= 0]).all()
    if budget < 1000:
        assert (ids < 0).any(axis=1).mean() > 0.2  # cut off by the budget
    else:
        assert (ids >= 0).all()


def test_filtered_search_and_counters_match_jax(data, pair):
    """filter_mask (a bool mask and an id list) and search_with_stats,
    under scan and descent routing."""
    _, queries = data
    idx, jidx = pair
    mask = np.random.default_rng(8).random(800) < 0.3
    for fm in (mask, np.where(mask)[0]):
        got = idx.search(queries, k=10, ef_search=48, filter_mask=fm)
        _assert_results_equal(got, jidx.search(queries, k=10, ef_search=48,
                                               filter_mask=fm))
        assert mask[got[1][got[1] >= 0]].all()
    for route in ("descent", "scan"):
        d, i, st = idx.search_with_stats(queries, k=10, ef_search=32,
                                         route=route)
        jd, ji, jst = jidx.search_with_stats(queries, k=10, ef_search=32,
                                             route=route)
        _assert_results_equal((d, i), (jd, ji))
        assert st == jst


def test_grow_keeps_graph_and_results(data, pair):
    """grow re-points sentinels to the new capacity and keeps every row,
    edge and tombstone; searches are unchanged."""
    _, queries = data
    idx, jidx = pair
    idx.delete([5, 9])
    before = idx.search(queries, k=10)
    idx.grow(2000)
    jidx.delete([5, 9])
    jidx.grow(2000)
    g = idx.graph
    assert g.cap == 2000 and int(g.neighbors0.max()) == 2000
    _assert_graphs_equal(idx, jidx)
    after = idx.search(queries, k=10)
    _assert_results_equal(after, before)


def test_route_cache_follows_mutation(data):
    """The cached upper-id table (dense-scan routing) refreshes when the
    graph changes in place (tests/test_search.py:141)."""
    base, _ = data
    idx = HnswIndex(CFG, capacity=1000, device="cpu").build(base[:600])
    ids1 = idx._upper_ids_dev()
    n_up1 = idx.n_upper
    assert idx._upper_ids_dev() is ids1  # cached
    idx.add(base[600:])
    ids2 = idx._upper_ids_dev()
    assert idx.n_upper > n_up1
    assert int((ids1 != idx.graph.sentinel).sum()) == n_up1
    assert int((ids2 != idx.graph.sentinel).sum()) == idx.n_upper


def test_save_load_across_packages(data, pair, tmp_path):
    """A directory saved by tpu_hnsw serves in the port with the same ids,
    and one saved by the port loads in tpu_hnsw (bf16 storage crosses in
    tests/test_torch_graph_engines.py's binary graph)."""
    from tpu_hnsw.index.hnsw import HnswIndex as JIndex

    _, queries = data
    _, j = pair
    j.delete([3, 4])
    j.save(str(tmp_path / "j"))
    port = HnswIndex.load(str(tmp_path / "j"), device="cpu")
    want = j.search(queries, k=10)
    _assert_results_equal(port.search(queries, k=10), want)
    port.save(str(tmp_path / "p"))
    back = JIndex.load(str(tmp_path / "p"))
    _assert_results_equal(back.search(queries, k=10), want)
    assert back.n == port.n == 800 and back.capacity == port.capacity


def test_from_state_serves_a_jax_graph(data, built):
    """from_state: numpy arrays under HnswGraph's field names plus the host
    scalars carry a JAX-built graph across: the same ids; the arrays are
    copied, so growing the port's index leaves JAX's untouched."""
    base, queries = data
    j = built[1]
    g = j.graph
    state = {f: np.asarray(getattr(g, f)) for f in g._fields}
    state.update(n=j.n, n_upper=j.n_upper, entry=j.entry,
                 entry_level=j.entry_level)
    idx = HnswIndex.from_state(CFG, state, device="cpu")
    assert idx.capacity == 800
    _assert_results_equal(idx.search(queries, k=10),
                          j.search(queries, k=10))
    idx.add(base[800:850])
    assert idx.n == 850 and int(np.asarray(j.graph.neighbors0).max()) == 800


def test_hnsw_index_defaults_to_the_card(monkeypatch):
    """No device means CUDA; without a card construction raises."""
    assert HnswIndex(CFG, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert HnswIndex(CFG).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        HnswIndex(CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert HnswIndex(CFG).device.type == "cuda"
