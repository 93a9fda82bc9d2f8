"""The graph engine's builds: tpu_hnsw_torch.index.{build, build_cluster}
against tpu_hnsw's and the numpy oracle.

- the wave build at wave_size=1 reproduces the sequential oracle (the
  port's RefHnsw) and JAX's HnswIndex edge for edge (tests/test_build.py:49);
- at wave_size=64: the graph invariants of tests/test_build.py:15-46 and
  recall@10 within 0.01 of JAX's, for L2, IP and cosine;
- the bulk build (k-means path): centroids equal JAX's (atol 1e-3, as
  tests/test_torch_kmeans.py states: f32 products in other summation
  orders can move a near-tie row), levels equal, invariants, recall@10
  within 0.01 of JAX's;
- its NN-descent refinement (``refine_rounds``): the candidates equal
  JAX's on one shared graph, duplicates and sentinel rows included, and
  so does the selection over them; a refine-1 build holds the invariants,
  recall@10 within 0.01 of JAX's refine-1 build and JAX's build_stats
  keys.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch import FlatIndex, HnswConfig, HnswIndex, Metric
from tpu_hnsw_torch.index import build_cluster as BC
from tpu_hnsw_torch.index.graph import to_ref_lists
from tpu_hnsw_torch.index.ref_impl import RefHnsw
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)


def _jax_index(cfg: HnswConfig, **kw):
    from tpu_hnsw.config import HnswConfig as JCfg
    from tpu_hnsw.index.hnsw import HnswIndex as JIndex

    import dataclasses

    c = dataclasses.asdict(cfg)
    c["metric"] = cfg.metric.value
    return JIndex(JCfg(**c), **kw)


def check_invariants(idx: HnswIndex, reachable: bool = True):
    """Degree caps, no self loops or repeated edges, valid ids, edges only
    to elements of that level, untouched trash rows and, for wave builds,
    level-0 reachability from the entry (L2 and cosine; a bulk build's level
    0 is a kNN graph per cluster, which tests/test_bulk_build.py does not
    hold to it)."""
    g = idx.graph
    lists = to_ref_lists(g, idx.n, idx.n_upper)
    levels = g.levels[: idx.n].numpy()
    for i, per_level in enumerate(lists):
        assert len(per_level) == levels[i] + 1
        for lv, row in enumerate(per_level):
            assert len(row) <= idx.cfg.layer_m(lv)
            assert len(set(row)) == len(row), (i, lv)
            assert i not in row, (i, lv)
            for x in row:
                assert 0 <= x < idx.n and levels[x] >= lv
    if reachable and idx.cfg.metric is not Metric.IP:
        seen, todo = {idx.entry}, [idx.entry]
        while todo:
            for x in lists[todo.pop()][0]:
                if x not in seen:
                    seen.add(x)
                    todo.append(x)
        assert len(seen) >= 0.99 * idx.n
    sent = g.sentinel
    assert not g.vectors[sent].any() and float(g.vectors_sq[sent]) == 0
    assert (g.neighbors0[sent] == sent).all()
    assert (g.upper_nbrs[g.cap_upper] == sent).all()
    assert int(g.upper_slot[sent]) == g.cap_upper
    assert int(g.levels[sent]) == 0 and not bool(g.deleted[sent])


def test_wave1_matches_oracle_and_jax():
    """wave_size=1 gives the sequential oracle's graph, and JAX's."""
    base, _ = synthetic_clustered(150, 8, n_queries=1, seed=7)
    levels = np.zeros(150, np.int32)
    rng = np.random.default_rng(0)
    levels[rng.integers(0, 150, 12)] = 1
    levels[rng.integers(0, 150, 3)] = 2
    cfg = HnswConfig(dim=8, m=4, ef_construction=16, wave_size=1, seed=1)
    idx = HnswIndex(cfg, capacity=200, device="cpu")
    idx.add(base, levels=levels)
    ref = RefHnsw(cfg)
    ref.build(base, levels=levels)
    jidx = _jax_index(cfg, capacity=200)
    jidx.add(base, levels=levels)
    assert (idx.entry, idx.entry_level) == (ref.entry, ref.entry_level) \
        == (jidx.entry, jidx.entry_level)
    lists = to_ref_lists(idx.graph, idx.n, idx.n_upper)
    for i in range(150):
        for lv in range(levels[i] + 1):
            assert sorted(lists[i][lv]) == sorted(ref.neighbors[i][lv]), (
                i, lv)
    np.testing.assert_array_equal(idx.graph.neighbors0.numpy(),
                                  np.asarray(jidx.graph.neighbors0))
    np.testing.assert_array_equal(idx.graph.upper_nbrs.numpy(),
                                  np.asarray(jidx.graph.upper_nbrs))
    check_invariants(idx)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_wave_build_matches_jax(metric):
    """wave_size=64 over 800 rows: invariants, and recall@10 at ef 64
    within 0.01 of JAX's build of the same rows."""
    base, queries = synthetic_clustered(800, 16, n_queries=40, seed=9)
    cfg = HnswConfig(dim=16, m=8, ef_construction=32, wave_size=64, seed=2,
                     metric=metric)
    idx = HnswIndex(cfg, capacity=800, device="cpu").build(base)
    assert idx.build_stats == {} and idx.n == 800
    check_invariants(idx)
    jidx = _jax_index(cfg, capacity=800).build(base)
    gt = FlatIndex(base, Metric(metric), device="cpu").search(
        queries, k=10, exact=True)[1]
    r = recall_at_k(idx.search(queries, k=10, ef_search=64)[1], gt, 10)
    jr = recall_at_k(jidx.search(queries, k=10, ef_search=64)[1], gt, 10)
    assert r >= 0.9 and abs(r - jr) <= 0.01, (r, jr)


@pytest.fixture(scope="module")
def bulk():
    """Both packages bulk-build 3000 x 16 rows (cluster_size=256: 12
    k-means clusters, the clustered path), each capturing the centroids
    its k-means returned."""
    from tpu_hnsw.index import build_cluster as JBC
    from tpu_hnsw.parallel import kmeans as JKM
    from tpu_hnsw_torch.parallel import kmeans as KM

    base, queries = synthetic_clustered(3000, 16, n_queries=64, seed=5)
    cfg = HnswConfig(dim=16, m=8, ef_construction=32, seed=2, descent_ef=4)
    seen = {}

    def spy(mod, key):
        real = mod.kmeans

        def run(*a, **kw):
            out = real(*a, **kw)
            seen[key] = np.asarray(out[0])
            return out
        return real, run

    real, run = spy(KM, "port")
    jreal, jrun = spy(JKM, "jax")
    KM.kmeans, JKM.kmeans = run, jrun
    try:
        idx = HnswIndex(cfg, device="cpu")
        BC.build_bulk(idx, base, cluster_size=256)
        jidx = _jax_index(cfg)
        JBC.build_bulk(jidx, base, cluster_size=256)
    finally:
        KM.kmeans, JKM.kmeans = real, jreal
    gt = FlatIndex(base, Metric.L2, device="cpu").search(queries, k=10,
                                                        exact=True)[1]
    return base, queries, cfg, idx, jidx, seen, gt


def test_bulk_build_matches_jax(bulk):
    base, queries, cfg, idx, jidx, seen, gt = bulk
    np.testing.assert_allclose(seen["port"], seen["jax"], atol=1e-3)
    np.testing.assert_array_equal(idx.graph.levels.numpy(),
                                  np.asarray(jidx.graph.levels))
    assert (idx.entry, idx.entry_level, idx.n_upper) == (
        jidx.entry, jidx.entry_level, jidx.n_upper)
    check_invariants(idx, reachable=False)
    st = idx.build_stats
    assert st["mode"] == "bulk" and st["n"] == 3000
    assert st["refine_rounds"] == 0
    assert set(st["stages"]) >= {"kmeans_route_pack", "cluster_candidates",
                                 "link_l0", "nn_descent_refine",
                                 "upper_levels", "total"}
    for ef in (16, 40):
        r = recall_at_k(idx.search(queries, k=10, ef_search=ef)[1], gt, 10)
        jr = recall_at_k(jidx.search(queries, k=10, ef_search=ef)[1], gt, 10)
        assert r >= 0.95 and abs(r - jr) <= 0.01, (ef, r, jr)


@pytest.fixture(scope="module")
def bulk_refine(bulk):
    """The bulk fixture's rows built again by both packages with one
    NN-descent round; JAX reuses the stage programs the fixture compiled."""
    from tpu_hnsw.index import build_cluster as JBC

    base, queries, cfg, idx0, _, _, gt = bulk
    idx = HnswIndex(cfg, device="cpu")
    BC.build_bulk(idx, base, cluster_size=256, refine_rounds=1)
    jidx = _jax_index(cfg)
    JBC.build_bulk(jidx, base, cluster_size=256, refine_rounds=1)
    return queries, idx0, idx, jidx, gt


def test_refine_build_matches_jax(bulk_refine):
    """refine_rounds=1: the graph invariants, recall@10 within 0.01 of the
    reference's refine-1 build at ef 16 and 40, and build_stats with the
    reference's keys (the round's stage included); the round relinks level
    0 (the graph differs from the refine-0 build's)."""
    queries, idx0, idx, jidx, gt = bulk_refine
    check_invariants(idx, reachable=False)
    st, jst = idx.build_stats, jidx.build_stats
    assert set(st) == set(jst) and set(st["stages"]) == set(jst["stages"])
    assert st["refine_rounds"] == jst["refine_rounds"] == 1
    assert not torch.equal(idx.graph.neighbors0, idx0.graph.neighbors0)
    assert torch.equal(idx.graph.upper_nbrs, idx0.graph.upper_nbrs)
    for ef in (16, 40):
        r = recall_at_k(idx.search(queries, k=10, ef_search=ef)[1], gt, 10)
        jr = recall_at_k(jidx.search(queries, k=10, ef_search=ef)[1], gt, 10)
        assert r >= 0.95 and abs(r - jr) <= 0.01, (ef, r, jr)


def test_non_candidates_and_their_selection_match_jax():
    """One RefHnsw graph over small-integer rows (exact distances that tie
    everywhere) carried into both packages, with empty rows past n and the
    sentinel among the node ids: the refinement's candidates equal the
    reference's, hold duplicates (a neighbour reached directly and through
    another neighbour), and their exact rescores and the selection over
    them (trim to ef_construction, then SelectNeighbors, which takes a
    duplicate once) equal the reference's."""
    import jax.numpy as jnp

    from tpu_hnsw.config import HnswConfig as JCfg
    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.index import build_cluster as JBC
    from tpu_hnsw.index import graph as JG
    from tpu_hnsw_torch.index import graph as G

    rng = np.random.default_rng(8)
    base = rng.integers(-2, 3, size=(200, 8)).astype(np.float32)
    cfg = HnswConfig(dim=8, m=4, ef_construction=16, seed=3)
    ref = RefHnsw(cfg)
    ref.build(base)
    g, _, _ = G.from_ref(ref, cfg, cap=256)
    jg, _, _ = JG.from_ref(ref, JCfg(dim=8, m=4, ef_construction=16, seed=3),
                           cap=256)
    nid = np.r_[np.arange(240), [256] * 16].astype(np.int32)
    ci = BC._non_candidates(g, torch.from_numpy(nid), r2=BC.REFINE_R2)
    jci = JBC._non_candidates(jg, jnp.asarray(nid), r2=BC.REFINE_R2)
    np.testing.assert_array_equal(ci.numpy(), np.asarray(jci))
    assert ci.shape == (256, cfg.m0 * (1 + BC.REFINE_R2))
    assert (ci[200:] == 256).all()  # empty rows and the sentinel
    live = ci[:200].numpy()
    dup = [len(set(r[r != 256])) < (r != 256).sum() for r in live]
    assert np.mean(dup) > 0.5
    cd = BC._rescore_chunk(g, torch.from_numpy(nid), ci, metric=Metric.L2)
    jcd = JBC._rescore_chunk(jg, jnp.asarray(nid), jci, metric=JMetric.L2)
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))
    si, sd = BC._select_chunk(g, ci, cd, lm=cfg.m0, metric=Metric.L2,
                              trim=cfg.ef_construction)
    jsi, jsd = JBC._select_chunk(jg, jci, jcd, lm=cfg.m0, metric=JMetric.L2,
                                 trim=cfg.ef_construction)
    np.testing.assert_array_equal(si.numpy(), np.asarray(jsi))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jsd))
    for r in si.numpy():
        r = r[r != 256]
        assert len(set(r)) == len(r)


def test_bulk_upper_levels_keep_the_trash_slot(bulk):
    """Padding rows of an upper level link nothing, so the trash slot of
    the upper table stays all sentinel (check_invariants holds the port to
    it). The reference scores its padding rows (the zero trash vector)
    against the level subset and writes their picks into the trash slot,
    which every level-0 element's slot points at, and gives real elements
    incoming edges from the sentinel."""
    _, _, _, idx, jidx, _, _ = bulk
    g = idx.graph
    assert (g.upper_nbrs[g.cap_upper] == g.sentinel).all()
    jtrash = np.asarray(jidx.graph.upper_nbrs)[jidx.graph.cap_upper]
    assert (jtrash != jidx.graph.sentinel).any()  # the divergence


def test_auto_build_takes_the_bulk_path_from_a_tensor(bulk, monkeypatch):
    """build(auto) takes the bulk path at BULK_THRESHOLD rows, and a tensor
    input builds the graph an array builds with mode="bulk"."""
    base, queries, cfg, _, _, _, _ = bulk
    monkeypatch.setattr(HnswIndex, "BULK_THRESHOLD", 2000)
    t = HnswIndex(cfg, device="cpu").build(torch.from_numpy(base))
    a = HnswIndex(cfg, device="cpu").build(base, mode="bulk")
    assert t.build_stats["mode"] == "bulk"
    assert torch.equal(t.graph.neighbors0, a.graph.neighbors0)
    assert torch.equal(t.graph.upper_nbrs, a.graph.upper_nbrs)


def test_nonfinite_tensor_rejected_before_any_state_changes(bulk):
    """A tensor with a NaN is refused before the index changes: the port's
    index stays empty (no graph, n_upper 0, no level draws spent) and then
    builds the graph a fresh index builds. The reference checks only after
    writing the graph (build_cluster.py:565-567): its rejected index keeps
    a bumped n_upper."""
    import jax.numpy as jnp

    from tpu_hnsw.index import build_cluster as JBC

    base, _, cfg, idx, _, _, _ = bulk
    bad = base.copy()
    bad[7, 3] = np.nan
    port = HnswIndex(cfg, device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        BC.build_bulk(port, torch.from_numpy(bad), cluster_size=256)
    assert port.graph is None and port.n == 0 and port.n_upper == 0
    BC.build_bulk(port, torch.from_numpy(base), cluster_size=256)
    assert torch.equal(port.graph.neighbors0, idx.graph.neighbors0)
    assert torch.equal(port.graph.levels, idx.graph.levels)
    ref = _jax_index(cfg)
    with pytest.raises(ValueError, match="NaN"):
        JBC.build_bulk(ref, jnp.asarray(bad), cluster_size=256)
    assert ref.n == 0 and ref.n_upper > 0  # the divergence the port fixes


def test_bulk_build_links_rows_every_cluster_dropped(monkeypatch):
    """300 copies of one row all take the same two nearest centroids, so
    both clusters hold more members than their 4 * cluster_size slots and
    drop the rest, as the reference does (``mode="drop"``). There a row
    dropped from both of its clusters gets no level-0 link: found by no
    search, and a dead end as a route seed (2,775 such rows in a 1M x 128
    cell's build). The port gives such rows candidates from an exact scan,
    so every row is linked."""
    base, _ = synthetic_clustered(2000, 16, n_queries=1, seed=3)
    base[:300] = base[0]
    cfg = HnswConfig(dim=16, m=8, ef_construction=32, seed=0)

    def degrees():
        idx = HnswIndex(cfg, device="cpu")
        BC.build_bulk(idx, base, cluster_size=16)
        check_invariants(idx, reachable=False)
        return (idx.graph.neighbors0[:2000] != idx.graph.sentinel).sum(1)

    assert degrees().min() > 0
    monkeypatch.setattr(BC, "_link_orphans", lambda *a, **k: None)
    assert (degrees() == 0).sum() > 100  # the reference's drop


def _sq_l2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared L2 distances in float64, ``[len(a), len(b)]``."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)


def test_link_orphans_gives_their_exact_nearest():
    """Rows of the candidate table that hold only sentinels take their k
    nearest of all n rows (never themselves), held to a float64 brute
    force up to f32 ties at the k-th distance; every other row, and the
    rows past n, stay as they were."""
    base, _ = synthetic_clustered(1500, 16, n_queries=1, seed=5)
    n, k = 1500, 12
    idx = HnswIndex(HnswConfig(dim=16, m=8, ef_construction=32, seed=0),
                    device="cpu").build(base)
    g = idx.graph
    gen = torch.Generator().manual_seed(0)
    all_ci = torch.randint(0, n, (2048, 20), generator=gen,
                           dtype=torch.int32)
    orphans = torch.tensor([0, 7, 500, 1499])
    all_ci[orphans] = g.sentinel
    all_ci[n:] = g.sentinel
    kept = all_ci.clone()
    BC._link_orphans(g, all_ci, n, k=k, metric=Metric.L2)
    others = torch.ones(2048, dtype=torch.bool)
    others[orphans] = False
    assert torch.equal(all_ci[others], kept[others])
    assert (all_ci[orphans, k:] == g.sentinel).all()
    d = _sq_l2(base[orphans.numpy()], base)
    d[np.arange(len(orphans)), orphans.numpy()] = np.inf
    for j, row in enumerate(all_ci[orphans, :k].numpy()):
        kth = np.sort(d[j])[k - 1]
        tol = 1e-5 * max(kth, 1.0)
        assert len(set(row)) == k and orphans[j].item() not in row
        assert (d[j, row] <= kth + tol).all()  # none beyond the k-th
        must = np.where(d[j] < kth - tol)[0]  # clear of any tie
        assert set(must) <= set(row)


def test_bulk_build_orphan_rows_link_their_exact_neighbours(monkeypatch):
    """The rows of the dropped-row build above that reach ``_link_orphans``
    with no candidate end with level-0 rows drawn from their brute-force
    nearest: each neighbour lies within the row's k-th nearest distance of
    all rows (k the build's candidate width): a copy of row 0 links only
    to other copies, at distance 0, and a row dropped from two clusters
    that other rows overflowed to its nearest."""
    base, _ = synthetic_clustered(2000, 16, n_queries=1, seed=3)
    base[:300] = base[0]
    cfg = HnswConfig(dim=16, m=8, ef_construction=32, seed=0)
    seen = {}
    link = BC._link_orphans

    def spy(g, all_ci, n, *, k, metric):
        seen["rows"] = torch.nonzero(
            (all_ci[:n] == g.sentinel).all(1)).reshape(-1).numpy()
        seen["k"] = k
        link(g, all_ci, n, k=k, metric=metric)

    monkeypatch.setattr(BC, "_link_orphans", spy)
    idx = HnswIndex(cfg, device="cpu")
    BC.build_bulk(idx, base, cluster_size=16)
    rows, k = seen["rows"], seen["k"]
    assert len(rows) > 100 and k == 32
    nbrs = idx.graph.neighbors0[torch.from_numpy(rows)].numpy()
    d = _sq_l2(base[rows], base)
    d[np.arange(len(rows)), rows] = np.inf
    for j, row in enumerate(nbrs):
        row = row[row != idx.graph.sentinel]
        kth = np.sort(d[j])[k - 1]
        assert len(row) > 0
        assert (d[j, row] <= kth + 1e-5 * max(kth, 1.0)).all(), rows[j]
    assert (rows < 300).sum() > 100  # copies of row 0, whose k-th is 0


def test_incoming_orders_edges_like_the_reference_lexsort():
    """_incoming ranks each target's edges by (distance, position), the
    reference's two-pass lexsort, and keeps the closest incoming_r."""
    rng = np.random.default_rng(3)
    n, lm, cap, r = 300, 6, 320, 4
    ids = rng.integers(0, n, size=(n, lm)).astype(np.int32)
    ids[rng.random((n, lm)) < 0.2] = cap
    d = rng.integers(0, 5, size=(n, lm)).astype(np.float32)  # ties
    nid = np.arange(n, dtype=np.int32)
    inc_ids, inc_d = BC._incoming(torch.from_numpy(ids), torch.from_numpy(d),
                                  torch.from_numpy(nid), cap, incoming_r=r,
                                  cap=cap)
    t, u, dd = ids.reshape(-1), np.repeat(nid, lm), d.reshape(-1)
    order = np.lexsort((dd, t))
    want_i = np.full((cap + 1, r), cap, np.int32)
    want_d = np.full((cap + 1, r), np.inf, np.float32)
    for tt in range(n):
        sel = order[t[order] == tt][:r]
        want_i[tt, :len(sel)] = u[sel]
        want_d[tt, :len(sel)] = dd[sel]
    np.testing.assert_array_equal(inc_ids.numpy(), want_i)
    np.testing.assert_array_equal(inc_d.numpy(), want_d)


def test_rescore_chunk_is_capped_by_width():
    """The bulk build's rescore chunk keeps a [chunk, C, d] gather at or
    under the reference's 32,768 x 128 x 128 elements at any width."""
    for d, want in ((16, 32768), (128, 32768), (1536, 2048)):
        chunk = BC._rescore_rows(1 << 20, 128, d)
        assert chunk == want and chunk * 128 * d <= BC._RESCORE_ELEMS
    assert BC._rescore_rows(4096, 128, 16) == 4096


def test_big_graphs_seed_inserts_and_repairs_by_dense_scan(bulk, monkeypatch):
    """From ROUTE_SCAN_MIN_UPPER upper elements (lowered here), rows added
    to a bulk-built graph, and level-0 repairs, seed their search with the
    nearest live upper elements (the reference descends greedily with ef=1,
    which stranded 27% of the rows added to the 1M x 128 cell): every added
    row is found again, tombstones are never seeds, the invariants hold."""
    import copy

    from tpu_hnsw_torch.index import build as B

    base, _, _, idx0, _, _, _ = bulk
    idx = copy.deepcopy(idx0)
    monkeypatch.setattr(HnswIndex, "ROUTE_SCAN_MIN_UPPER", 0)
    calls = []
    real = B._live_scan_seeds
    monkeypatch.setattr(B, "_live_scan_seeds",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(1)
    extra = (base[rng.integers(0, 3000, 200)]
             + rng.normal(0, 0.3, (200, 16))).astype(np.float32)
    new = idx.add(extra)
    assert calls and idx.n == 3200
    ids = idx.search(extra, k=1, ef_search=64)[1]
    assert (ids[:, 0] == new).mean() == 1.0
    victims = rng.choice(3200, 100, replace=False)
    idx.delete(victims)
    n_calls = len(calls)
    assert idx.compact() > 0 and len(calls) > n_calls
    nbr0 = idx.graph.neighbors0[:3200].numpy()
    live = ~np.isin(np.arange(3200), victims)
    assert not np.isin(nbr0[live], victims).any()
    idx.graph.deleted[torch.from_numpy(victims)] = False  # invariants only
    check_invariants(idx, reachable=False)
