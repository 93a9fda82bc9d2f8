"""The graph engine as the benchmark's ``sift1m-graph.bulk`` cell runs it,
on the CPU at a small size:

- the plain walk (``hnswbench/reference_graph.py``: pgvector's
  ``GetScanItems`` one query at a time over the graph's tensors) returns
  ``RefHnsw.search``'s ids on a graph that ``RefHnsw`` built;
- ``HnswIndex.search_device`` at the cell's arguments (``ef_search`` 40,
  every other argument at its default) against the walk on one bulk-built
  graph, with the step cap and without;
- the engine file's four functions (``hnswbench/engines/graph.py``);
- the spans (``search`` > ``queries``, ``descend`` or ``route_scan``,
  ``beam_level0``, each with its work) and the beam's counters;
- the dense route's two paths: ``HnswIndex``'s table (a sentinel tail,
  its live count cached with it) through ``ops/route.py::route_topk``
  (on the CPU its plain version; on the card one kernel launch a request),
  a table with scattered sentinels (the build's) through the GEMM + top-k
  chain, each counted in ``ROUTE_LAUNCHES``.

Tolerances: ids of at least 99% of queries equal, a query whose two lists
differ only among equal distances counting as equal; distances of a
shared id to ``RTOL`` 1e-5, the graph tests' bound for f32 sums taken in
another order (the walk sums a row in torch's order, the beam in its
batched one). A lower precision (bf16's 8-bit mantissa) would miss it by
orders of magnitude.
"""

import functools

import numpy as np
import pytest
import torch

from hnswbench import check, spec
from hnswbench import reference_graph as RG
from tpu_hnsw_torch import HnswConfig, HnswIndex
from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.index import build as BU
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import search as SE
from tpu_hnsw_torch.index.ref_impl import RefHnsw
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import route as R
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.utils import profiling

torch.set_num_threads(1)

RTOL = 1e-5
K, EF = 10, 40
#: the cell's configuration at the test's size
CONFIG = {"dim": 16, "metric": "l2", "m": 16, "ef_construction": 64,
          "build_seed": 0}


@pytest.fixture(scope="module")
def bulk():
    """A 4,000 x 16 graph built through the engine file (the bulk path),
    200 queries, and the walk's answers on it."""
    base, queries = synthetic_clustered(4000, 16, n_queries=200, seed=3)
    engine = spec.module("engines", "graph")
    idx = engine.build(CONFIG, torch.from_numpy(base))
    q = torch.from_numpy(queries)
    g = idx.graph
    walker = RG.graph(g.vectors, g.neighbors0, g.upper_nbrs, g.upper_slot)
    walked = RG.walk_all(walker, idx.entry, idx.entry_level, q, K, EF, "l2")
    return base, q, engine, idx, walked


def _agree(d_a, i_a, d_b, i_b) -> float:
    """Share of rows whose id sets are equal or whose two distance lists
    are equal to RTOL (the sets then differ among equal distances)."""
    same = [set(a.tolist()) == set(b.tolist())
            or torch.allclose(x, y, rtol=RTOL)
            for a, b, x, y in zip(i_a, i_b, d_a, d_b)]
    return float(np.mean(same))


def _shared_close(d_a, i_a, d_b, i_b) -> None:
    """Each id in both rows has the same distance in both, to RTOL."""
    for a, b, x, y in zip(i_a, i_b, d_a, d_b):
        pos = {int(e): j for j, e in enumerate(b)}
        for j, e in enumerate(a.tolist()):
            if e in pos:
                torch.testing.assert_close(x[j], y[pos[e]], rtol=RTOL,
                                           atol=1e-6)


def _routes(fn):
    """``fn()`` and what it added to each ``ROUTE_LAUNCHES`` path."""
    before = dict(R.ROUTE_LAUNCHES)
    out = fn()
    return out, {k: R.ROUTE_LAUNCHES[k] - before[k] for k in before}


NO_ROUTE = {"fused": 0, "gemm_topk": 0, "plain": 0}
PLAIN = {**NO_ROUTE, "plain": 1}
CHAIN = {**NO_ROUTE, "gemm_topk": 1}


def test_walk_equals_ref_hnsw_search():
    base, queries = synthetic_clustered(600, 12, n_queries=32, seed=11)
    cfg = HnswConfig(dim=12, m=8, ef_construction=32, seed=4)
    ref = RefHnsw(cfg)
    ref.build(base)
    g, _, _ = G.from_ref(ref, cfg)
    walker = RG.graph(g.vectors, g.neighbors0, g.upper_nbrs, g.upper_slot)
    sc, ids, expanded = RG.walk_all(walker, ref.entry, ref.entry_level,
                                    torch.from_numpy(queries), K, EF, "l2")
    for j, q in enumerate(queries):
        want_d, want_i = ref.search(q, k=K, ef_search=EF)
        np.testing.assert_array_equal(ids[j].numpy(), want_i)
        np.testing.assert_allclose(sc[j].numpy(), want_d, rtol=RTOL)
    assert (expanded >= EF).all()  # ef 40 expands at least its 40 results


@pytest.mark.parametrize("route", ["auto", "scan"])
@pytest.mark.parametrize("max_steps", [0, 1000])
def test_search_device_agrees_with_the_walk(bulk, route, max_steps):
    """The cell's call (``route="auto"`` is pgvector's greedy descent at
    this size; ``"scan"`` is the dense route the cell takes at 1M), with
    its step cap (``max_steps`` 0: ef + 16) and with one no query
    reaches."""
    _, q, _, idx, (w_sc, w_ids, expanded) = bulk
    assert int(expanded.max()) < EF + 16  # no walk would hit the cap
    (dist, ids), moved = _routes(lambda: idx.search_device(
        q, k=K, ef_search=EF, route=route, max_steps=max_steps))
    # the dense route takes route_topk's fused path (here its plain
    # version); "auto" descends at this size
    assert moved == (PLAIN if route == "scan" else NO_ROUTE)
    sc = dist.double() ** 2
    assert _agree(sc, ids.long(), w_sc.double(), w_ids) >= 0.99
    _shared_close(sc, ids.long(), w_sc.double(), w_ids)


def test_engine_functions(bulk):
    base, q, engine, idx, _ = bulk
    assert engine.build_stats(idx)["mode"] == "bulk"
    ids, rows = engine.stored(idx)
    assert torch.equal(ids, torch.arange(4000))
    assert check.rows_lost(ids, rows, torch.from_numpy(base)) == 0
    d, i = engine.search(idx, q, K, EF)
    want_d, want_i = idx.search_device(q, k=K, ef_search=EF)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    # fewer rows than k: the sentinel id reads -1, its distance +inf
    small = engine.build(CONFIG, torch.from_numpy(base[:6]))
    d, i = engine.search(small, q[:3], K, EF)
    assert (i[:, 6:] == -1).all() and torch.isinf(d[:, 6:]).all()
    assert (i[:, :6] >= 0).all() and torch.isfinite(d[:, :6]).all()


def _children(spans, parent: str) -> dict:
    out = {}
    for s in spans:
        if s.parent >= 0 and spans[s.parent].name == parent:
            assert spans[s.parent].start <= s.start <= s.end \
                <= spans[s.parent].end
            out[s.name] = s.work
    return out


@pytest.mark.parametrize("route,routing", [("auto", "descend"),
                                           ("scan", "route_scan")])
def test_search_span_tree(bulk, route, routing):
    _, q, _, idx, _ = bulk
    with profiling.record() as rec:
        idx.search_device(q, k=K, ef_search=EF, route=route)
    roots = [s for s in rec.spans if s.parent < 0]
    assert [(s.name, s.work) for s in roots] == [("search", 200)]
    assert _children(rec.spans, "search") == {
        "queries": 200, routing: 200, "beam_level0": 200}


def _beam_counters() -> tuple:
    return (SE.BEAM_STEPS, SE.BEAM_SYNCS, SE.BEAM_ROWS, SE.BEAM_VECTORS,
            SE.BEAM_COUNTED)


@pytest.mark.parametrize("expand", [1, 2])
def test_beam_counters_count_the_level0_loop(bulk, expand):
    """Eight steps that no query finishes in: 8 steps, a termination test
    at steps 0 and 4; the descent's upper-level steps count nothing, and
    with no trace open the least work is not read."""
    _, q, _, idx, _ = bulk
    before = _beam_counters()
    idx.search_device(q, k=K, ef_search=EF, max_steps=8, expand=expand,
                      route="auto")
    after = _beam_counters()
    assert all(type(c) is int for c in after)
    assert [b - a for a, b in zip(before, after)] == [8, 2, 0, 0, 0]


def test_beam_least_work_is_counted_under_a_trace(bulk, tmp_path):
    """Under a trace one beam adds its expanded nodes (at expand 1, each
    query's hops) to ``BEAM_ROWS``, and to ``BEAM_VECTORS`` the distinct
    ids among its seed and those nodes' neighbours, as a visited set
    would read them: held to Python sets over the beam's history ring.
    They never exceed the port's own scoring (its evaluations, which score
    a node again once the pool has dropped it, and the seed)."""
    _, q, _, idx, _ = bulk
    g, Q = idx.graph, q.shape[0]
    before = _beam_counters()
    with profiling.trace(str(tmp_path)):
        _, ids, hops, evals = idx._search(q, K, EF, None, None, 0,
                                          "descent", None, True)
    rows, vectors, counted = [b - a for a, b in
                              zip(before[2:], _beam_counters()[2:])]
    assert counted == 1 and rows == int(hops.sum())
    seeds = SE.descend_seeds(g, q, idx.entry, idx.entry_level, 0)
    _, ring_ids, state = SE._search_layer_body(
        g, q, seeds, 0, level0=True, ef=EF, expand=1, max_steps=EF + 16,
        metric=idx.cfg.metric, skip_deleted=True, mask_deleted_results=True,
        return_state=True)
    assert torch.equal(ring_ids[:, :K], ids)  # the same beam
    sent, want = g.sentinel, 0
    for s, ring in zip(seeds.tolist(), state[3].tolist()):
        done = [e for e in ring if e != sent]
        seen = set(s) | {x for e in done for x in g.neighbors0[e].tolist()}
        want += len(seen - {sent})
    assert vectors == want
    assert vectors <= int(evals.sum()) + Q


def test_a_beam_whose_ring_wrapped_is_not_counted(bulk, tmp_path):
    """At ef 200 the beam runs past the 64-slot history ring, which then
    no longer holds every expanded id: no least work is counted."""
    _, q, _, idx, _ = bulk
    before = _beam_counters()
    with profiling.trace(str(tmp_path)):
        idx.search_device(q, k=K, ef_search=200, route="auto")
    moved = [b - a for a, b in zip(before, _beam_counters())]
    assert moved[0] > 64 and moved[2:] == [0, 0, 0]


def test_engine_refuses_a_build_with_unlinked_rows(monkeypatch):
    """Without the bulk build's orphan repair, 300 copies of one row leave
    rows with no level-0 link (``tests/test_torch_graph_build.py``): the
    engine refuses that index at set-up instead of serving it."""
    from tpu_hnsw_torch.index import build_cluster as BC

    base, _ = synthetic_clustered(2000, 16, n_queries=1, seed=3)
    base[:300] = base[0]
    engine = spec.module("engines", "graph")
    cfg = {**CONFIG, "m": 8, "ef_construction": 32}
    monkeypatch.setattr(BC, "_link_orphans", lambda *a, **k: None)
    monkeypatch.setattr(BC, "build_bulk", functools.partial(
        BC.build_bulk, cluster_size=16))
    with pytest.raises(RuntimeError, match="no level-0 link"):
        engine.build(cfg, torch.from_numpy(base))


def test_spans_and_counters_add_no_operation(bulk):
    """With no sink and no trace open every region is the shared no-op, and
    a sink launches nothing either: the same operators run, in the same
    numbers, with the recorder off and on."""
    from torch.profiler import ProfilerActivity, profile

    _, q, _, idx, _ = bulk
    assert profiling.annotate("beam_level0", 3) is profiling.annotate(
        "search")

    def ops(sink: bool) -> dict:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if sink:
                with profiling.record():
                    idx.search_device(q, k=K, ef_search=EF, route="scan")
            else:
                idx.search_device(q, k=K, ef_search=EF, route="scan")
        return {e.key: e.count for e in prof.key_averages()
                if e.key.startswith("aten::")}

    assert ops(False) == ops(True)


@pytest.mark.parametrize("descent_ef", [1, 4])
def test_scan_seeds_take_the_fused_route(bulk, descent_ef):
    """Over ``HnswIndex``'s route table the dense route is one
    ``route_topk`` call on its fused path (on the CPU the plain version).
    Its seeds equal the GEMM + top-k chain's (``route.py``'s, as the route
    took it before) in every row whose best ``descent_ef + 1`` float64
    scores lie further apart than f32 rounding (d * eps * (max |q|^2 +
    max |v|^2)), and such rows are nearly all."""
    _, q, _, idx, _ = bulk
    g, metric = idx.graph, idx.cfg.metric
    ids, live = idx._route_table()
    assert live.dtype == torch.int32 and live.shape == (1,)
    n_live = int(live)
    assert n_live == idx.n_upper and (ids[n_live:] == g.sentinel).all()
    fused, moved = _routes(lambda: SE._scan_seeds_body(
        g, q, ids, live, descent_ef, metric))
    assert moved == PLAIN
    v, v_sq = G.gather_vectors(g, ids)
    chain = ids[R.route_topk_reference(
        v, v_sq, q, (q * q).sum(1), descent_ef, metric, live=live,
        select=T.topk_smallest_fast)[:, 0]]
    assert fused.shape == chain.shape == (q.shape[0], descent_ef)
    v = v[:n_live].double()
    q64 = q.double()
    sc = ((q64 * q64).sum(1)[:, None] + (v * v).sum(1)[None]
          - 2 * q64 @ v.T).sort(1)[0][:, :descent_ef + 1]
    tol = q.shape[1] * float(np.finfo(np.float32).eps) * (
        float((q64 * q64).sum(1).max()) + float((v * v).sum(1).max()))
    apart = ((sc[:, 1:] - sc[:, :-1]) > tol).all(1)
    assert apart.float().mean() > 0.95
    assert torch.equal(fused[apart], chain[apart])


@pytest.mark.parametrize("width,path", [(4, PLAIN), (64, CHAIN)])
def test_scattered_sentinels_are_never_seeds(bulk, width, path):
    """The build's table (``_live_scan_seeds``: tombstoned upper ids turned
    into sentinels in place) under inner product with every dot negative,
    where a sentinel's zero row would score -0 and beat every live row:
    the sentinels are moved behind the live ids and counted out, so no
    seed is a sentinel or a tombstone, and each row's first seed is the
    live row of the best float64 score. At a width the kernel takes the
    route is the fused path; at the build's ``ef_construction`` (64) it
    stays on the GEMM + top-k chain."""
    _, _, _, idx, _ = bulk
    rng = np.random.default_rng(5)
    g = idx.graph
    vec = torch.from_numpy(rng.uniform(0.1, 1.0, tuple(g.vectors.shape))
                           .astype(np.float32))
    vec[g.cap] = 0.0
    ids = idx._route_table()[0]
    n_live = idx.n_upper
    deleted = torch.zeros_like(g.deleted)
    dead = ids[torch.from_numpy(rng.choice(n_live, n_live // 3,
                                           replace=False))].long()
    deleted[dead] = True
    g2 = g._replace(vectors=vec, vectors_sq=(vec * vec).sum(1),
                    deleted=deleted)
    q = -torch.from_numpy(rng.uniform(0.1, 1.0, (60, g.dim))
                          .astype(np.float32))
    seeds, moved = _routes(lambda: BU._live_scan_seeds(g2, q, ids, width,
                                                       Metric.IP))
    assert moved == path
    assert seeds.shape == (60, width)
    assert not (seeds == g.sentinel).any()
    assert not deleted[seeds.long()].any()
    alive = ids[:n_live][~deleted[ids[:n_live].long()]].long()
    best = alive[(q.double() @ vec[alive].double().T).argmax(1)]
    assert torch.equal(seeds[:, 0].long(), best)


@pytest.mark.cuda
def test_a_card_request_routes_in_one_launch():
    """On the card, a graph with more than ``ROUTE_SCAN_MIN_UPPER`` upper
    elements served as the cell serves it (``route="auto"``, 4,096
    queries): its route is one launch of the route kernel and no chain
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base, queries = synthetic_clustered(80_000, 16, n_queries=4096, seed=4)
    idx = spec.module("engines", "graph").build(
        CONFIG, torch.from_numpy(base).cuda())
    assert idx.n_upper >= HnswIndex.ROUTE_SCAN_MIN_UPPER
    q = torch.from_numpy(queries).cuda()
    idx.search_device(q, k=K, ef_search=EF)  # the live count, once
    (_, ids), moved = _routes(lambda: idx.search_device(q, k=K,
                                                        ef_search=EF))
    torch.cuda.synchronize()
    assert moved == {**NO_ROUTE, "fused": 1}
    assert (ids != idx.graph.sentinel).all()
