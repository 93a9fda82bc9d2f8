"""The graph engine's search side: tpu_hnsw_torch.index.{ref_impl, graph,
select, search} against tpu_hnsw's.

Both packages load one RefHnsw oracle graph (``from_ref``) and search it
with the same numpy queries: ids and the per-query counters are equal, and
scores agree to rtol 1e-5 (f32 sums in different orders). A tie-heavy case
(small integer vectors, so distances are exact integers and tie
everywhere) holds the tie order to ``lax.top_k``'s.

The JAX package is imported inside the tests that compare against it, so
the card's machine, which has no JAX, can run the card test alone:
``python -m pytest --noconftest tests/test_torch_graph.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import search as SE
from tpu_hnsw_torch.index import select as SEL
from tpu_hnsw_torch.index.ref_impl import RefHnsw
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import topk as T

torch.set_num_threads(1)

RTOL = 1e-5


def _jax_cfg(cfg):
    from tpu_hnsw.config import HnswConfig as JCfg

    return JCfg(dim=cfg.dim, metric=cfg.metric.value, m=cfg.m,
                ef_construction=cfg.ef_construction, seed=cfg.seed)


def _jm(metric):
    """The JAX package's Metric member of the same value (its engines test
    ``metric is Metric.L2`` against their own enum)."""
    from tpu_hnsw.config import Metric as JMetric

    return JMetric(Metric(metric).value)


def _graphs(base, cfg, levels=None):
    """(port graph, JAX graph, ref) over one RefHnsw build of ``base``."""
    from tpu_hnsw.index import graph as JG

    ref = RefHnsw(cfg)
    ref.build(base, levels=levels)
    g, _, _ = G.from_ref(ref, cfg)
    jg, _, _ = JG.from_ref(ref, _jax_cfg(cfg))
    return g, jg, ref


@pytest.fixture(scope="module")
def clustered():
    """600 x 12 clustered rows, 32 queries, a RefHnsw graph (m=8)."""
    base, queries = synthetic_clustered(600, 12, n_queries=32, seed=11)
    cfg = HnswConfig(dim=12, m=8, ef_construction=32, seed=4)
    g, jg, ref = _graphs(base, cfg)
    return base, queries, cfg, g, jg, ref


@pytest.fixture(scope="module")
def ties():
    """400 x 8 rows of small integers (levels drawn), so every distance is
    an exact integer and ties abound; 24 integer queries."""
    rng = np.random.default_rng(5)
    base = rng.integers(-2, 3, size=(400, 8)).astype(np.float32)
    queries = rng.integers(-2, 3, size=(24, 8)).astype(np.float32)
    cfg = HnswConfig(dim=8, m=4, ef_construction=16, seed=6)
    g, jg, ref = _graphs(base, cfg)
    return base, queries, cfg, g, jg, ref


def _assert_same(out, jout):
    """(scores, ids[, hops, evals]) equal to the JAX tuple: ids and counters
    exactly, scores to RTOL."""
    got = [t.numpy() for t in out]
    want = [np.asarray(t) for t in jout]
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-6)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ref_impl_graphs_equal_jax_ref(metric):
    """The port's copy of the numpy oracle builds the JAX package's graph:
    the same levels, entry and neighbour lists."""
    from tpu_hnsw.index.ref_impl import RefHnsw as JRef

    base, _ = synthetic_clustered(300, 8, n_queries=1, seed=3)
    cfg = HnswConfig(dim=8, m=4, ef_construction=16, seed=2, metric=metric)
    ref, jref = RefHnsw(cfg), JRef(_jax_cfg(cfg))
    ref.build(base)
    jref.build(base)
    assert ref.levels == jref.levels
    assert (ref.entry, ref.entry_level) == (jref.entry, jref.entry_level)
    assert ref.neighbors == jref.neighbors


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("lm", [4, 16, 48])
def test_select_neighbors_matches_jax(clustered, metric, lm):
    """Random candidate sets with sentinels and repeated ids, unsorted, each
    row's distances to a point off the corpus (a base among its own
    candidates would tie its distance with an f32 product): the same ids
    as JAX's select_neighbors (lm=48 exceeds C+1 and pads)."""
    import jax.numpy as jnp

    from tpu_hnsw.index.select import select_neighbors as jselect

    _, _, _, g, jg, _ = clustered
    rng = np.random.default_rng(lm)
    B, C, sent = 40, 40, g.sentinel
    ids = rng.integers(0, 600, size=(B, C)).astype(np.int32)
    ids[:, 5:9] = ids[:, :4]  # repeats
    ids[rng.random((B, C)) < 0.2] = sent
    base = g.vectors[:600].numpy()
    at = base[rng.integers(0, 600, B)] + rng.normal(size=(B, base.shape[1]))
    d = ((base[ids.clip(0, 599)] - at[:, None]) ** 2).sum(-1).astype(
        np.float32)
    d[ids == sent] = np.inf
    m = Metric(metric)
    si, sd = SEL.select_neighbors(g, torch.from_numpy(ids),
                                  torch.from_numpy(d), lm=lm, metric=m)
    ji, jd = jselect(jg, jnp.asarray(ids), jnp.asarray(d), lm=lm,
                     metric=_jm(m))
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("case", ["clustered", "ties"])
@pytest.mark.parametrize("level", [0, 1])
def test_search_layer_matches_jax(case, level, request):
    import jax.numpy as jnp

    from tpu_hnsw.index.search import search_layer as jlayer

    base, queries, cfg, g, jg, ref = request.getfixturevalue(case)
    seeds = np.full((len(queries), 1), ref.entry, np.int32)
    for ef, expand in ((16, 1), (24, 4)):
        out = SE.search_layer(g, torch.from_numpy(queries),
                              torch.from_numpy(seeds), level,
                              level0=level == 0, ef=ef, expand=expand,
                              metric=cfg.metric)
        jout = jlayer(jg, jnp.asarray(queries), jnp.asarray(seeds),
                      jnp.int32(level), level0=level == 0, ef=ef,
                      expand=expand, metric=_jm(cfg.metric))
        _assert_same(out, jout)


@pytest.mark.parametrize("case", ["clustered", "ties"])
@pytest.mark.parametrize("expand,descent_ef", [(1, 1), (2, 3), (4, 8)])
def test_search_matches_jax(case, expand, descent_ef, request):
    """Descent then the level-0 beam: ids, hops and distance evaluations
    equal JAX's."""
    import jax.numpy as jnp

    from tpu_hnsw.index.search import search as jsearch

    base, queries, cfg, g, jg, ref = request.getfixturevalue(case)
    kw = dict(entry=ref.entry, entry_level=ref.entry_level, k=10,
              ef_search=40, expand=expand, descent_ef=descent_ef,
              with_counters=True)
    _assert_same(SE.search(g, torch.from_numpy(queries), metric=cfg.metric,
                           **kw),
                 jsearch(jg, jnp.asarray(queries), metric=_jm(cfg.metric),
                         **kw))


@pytest.mark.parametrize("case", ["clustered", "ties"])
def test_descend_matches_jax(case, request):
    """The standalone greedy descent (ef=1 at each upper level) lands every
    query on JAX's level-0 seed; graph_degree gives each level's width."""
    import jax.numpy as jnp

    from tpu_hnsw.index.search import descend as jdescend

    base, queries, cfg, g, jg, ref = request.getfixturevalue(case)
    got = SE.descend(g, torch.from_numpy(queries), ref.entry,
                     ref.entry_level, metric=cfg.metric)
    want = jdescend(jg, jnp.asarray(queries), ref.entry, ref.entry_level,
                    metric=_jm(cfg.metric))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [G.graph_degree(cfg, lv) for lv in (0, 1, 2)] == [
        g.neighbors0.shape[1], g.upper_nbrs.shape[2], g.upper_nbrs.shape[2]]


@pytest.mark.parametrize("case", ["clustered", "ties"])
def test_scan_routed_search_matches_jax(case, request):
    """Dense-scan routing over the level >= 1 subset (U <= 256, where the
    reference's top-k is exact): seeds and search results equal JAX's."""
    import jax.numpy as jnp

    from tpu_hnsw.index.search import scan_seeds as jscan
    from tpu_hnsw.index.search import search as jsearch

    base, queries, cfg, g, jg, ref = request.getfixturevalue(case)
    upper = np.where(np.asarray(ref.levels) >= 1)[0]
    assert len(upper) <= 256
    upper_ids = np.concatenate([upper, np.full(256 - len(upper),
                                               g.sentinel)]).astype(np.int32)
    seeds = SE.scan_seeds(g, torch.from_numpy(queries),
                          torch.from_numpy(upper_ids), descent_ef=4,
                          metric=cfg.metric)
    jseeds = jscan(jg, jnp.asarray(queries), jnp.asarray(upper_ids),
                   descent_ef=4, metric=_jm(cfg.metric))
    np.testing.assert_array_equal(seeds.numpy(), np.asarray(jseeds))
    kw = dict(entry=ref.entry, entry_level=ref.entry_level, k=10,
              ef_search=32, expand=2, descent_ef=4, with_counters=True)
    _assert_same(SE.search(g, torch.from_numpy(queries), metric=cfg.metric,
                           upper_ids=torch.from_numpy(upper_ids), **kw),
                 jsearch(jg, jnp.asarray(queries), metric=_jm(cfg.metric),
                         upper_ids=jnp.asarray(upper_ids), **kw))


def test_search_masks_deleted_and_filtered_like_jax(clustered):
    """Tombstones navigate but never return, and a filter mask keeps
    disallowed rows out: ids equal JAX's."""
    import jax.numpy as jnp

    from tpu_hnsw.index.search import search as jsearch

    base, queries, cfg, g, jg, ref = clustered
    rng = np.random.default_rng(9)
    deleted = np.zeros(g.cap + 1, bool)
    deleted[rng.choice(600, 60, replace=False)] = True
    deleted[ref.entry] = True
    allowed = np.zeros(g.cap + 1, bool)
    allowed[:600] = rng.random(600) < 0.5
    g2 = g._replace(deleted=torch.from_numpy(deleted))
    jg2 = jg._replace(deleted=jnp.asarray(deleted))
    kw = dict(entry=ref.entry, entry_level=ref.entry_level, k=10,
              ef_search=40, expand=2)
    out = SE.search(g2, torch.from_numpy(queries), metric=cfg.metric,
                    allowed=torch.from_numpy(allowed), **kw)
    jout = jsearch(jg2, jnp.asarray(queries), metric=_jm(cfg.metric),
                   allowed=jnp.asarray(allowed), **kw)
    _assert_same(out, jout)
    ids = out[1].numpy()
    live = ids != g.sentinel
    assert live.all(axis=1).mean() > 0.9
    assert not deleted[ids[live]].any() and allowed[ids[live]].all()


@pytest.mark.parametrize("case", ["clustered", "ties"])
def test_resumable_search_matches_jax(case, request):
    """A resumable start and two widened resumes: pools and counters equal
    JAX's at every step."""
    import jax.numpy as jnp

    from tpu_hnsw.index import search as JSE

    base, queries, cfg, g, jg, ref = request.getfixturevalue(case)
    q, jq = torch.from_numpy(queries), jnp.asarray(queries)
    d, i, st = SE.search_resumable_start(g, q, ref.entry, ref.entry_level,
                                         ef=10, expand=2, metric=cfg.metric,
                                         descent_ef=2)
    jd, ji, jst = JSE.search_resumable_start(jg, jq, ref.entry,
                                             ref.entry_level, ef=10,
                                             expand=2,
                                             metric=_jm(cfg.metric),
                                             descent_ef=2)
    for ef in (20, 40):
        _assert_same((d, i, st[4], st[5]), (jd, ji, jst[4], jst[5]))
        d, i, st = SE.search_resume(g, q, st, ef=ef, expand=2,
                                    metric=cfg.metric)
        jd, ji, jst = JSE.search_resume(jg, jq, jst, ef=ef, expand=2,
                                        metric=_jm(cfg.metric))
    _assert_same((d, i, st[4], st[5]), (jd, ji, jst[4], jst[5]))


def test_batched_search_matches_oracle(clustered):
    """The lockstep beam returns the pointer-chasing oracle's result set
    for every query (tests/test_search.py:25)."""
    base, queries, cfg, g, _, ref = clustered
    _, ids = SE.search(g, torch.from_numpy(queries), entry=ref.entry,
                       entry_level=ref.entry_level, k=10, ef_search=40,
                       metric=cfg.metric)
    for qi, q in enumerate(queries):
        _, want = ref.search(q, k=10, ef_search=40)
        assert set(ids[qi].tolist()) == set(want.tolist()), qi


def test_check_every_does_not_change_results(clustered, monkeypatch):
    """The loop tests termination every CHECK_EVERY steps; testing it before
    every step, as the reference does, returns the same pools and
    counters."""
    base, queries, cfg, g, _, ref = clustered
    kw = dict(entry=ref.entry, entry_level=ref.entry_level, k=10,
              ef_search=40, metric=cfg.metric, expand=2, descent_ef=2,
              with_counters=True)
    a = SE.search(g, torch.from_numpy(queries), **kw)
    monkeypatch.setattr(SE, "CHECK_EVERY", 1)
    b = SE.search(g, torch.from_numpy(queries), **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_from_ref_round_trips_and_keeps_trash_rows(clustered):
    base, _, cfg, g, _, ref = clustered
    assert G.to_ref_lists(g, len(base), 0) == ref.neighbors
    sent = g.sentinel
    assert not g.vectors[sent].any() and (g.neighbors0[sent] == sent).all()
    assert (g.upper_nbrs[g.cap_upper] == sent).all()
    assert int(g.upper_slot[sent]) == g.cap_upper


def test_lexsort_order_matches_reference_lexsort():
    """One stable sort of the int64 key (target << 32 | ordered distance
    bits) orders like jnp.lexsort((d, t)): target, then distance, then
    position; ties, -0.0, +inf and negative distances included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    t = rng.integers(0, 50, size=5000).astype(np.int32)
    t[:100] = 2 ** 31 - 1
    d = rng.integers(-4, 5, size=5000).astype(np.float32) / 4
    d[rng.random(5000) < 0.1] = np.inf
    d[rng.random(5000) < 0.05] = -0.0
    order = T.lexsort_order(torch.from_numpy(t), torch.from_numpy(d))
    np.testing.assert_array_equal(order.numpy(),
                                  np.asarray(jnp.lexsort((d, t))))


def test_merge_pools_keeps_the_earlier_entry_at_ties():
    """merge_pools in lax.top_k's order: among equal distances the pool's
    own (earlier) entries first."""
    import jax.numpy as jnp

    from tpu_hnsw.ops.topk import merge_pools as jmerge

    rng = np.random.default_rng(1)
    da = np.sort(rng.integers(0, 4, (6, 8)), 1).astype(np.float32)
    db = rng.integers(0, 4, (6, 5)).astype(np.float32)
    ia = rng.integers(0, 100, (6, 8)).astype(np.int32)
    ib = rng.integers(100, 200, (6, 5)).astype(np.int32)
    fa, fb = rng.random((6, 8)) < 0.5, np.zeros((6, 5), bool)
    got = T.merge_pools(*(torch.from_numpy(a) for a in (da, ia, fa, db, ib,
                                                        fb)), 8)
    want = jmerge(*(jnp.asarray(a) for a in (da, ia, fa, db, ib, fb)), 8)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.cuda
def test_search_on_card_equals_cpu():
    """The graph path's search on the card returns the CPU run's ids and
    counters on the same graph (scores to RTOL), descent and scan routing,
    with a filter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base, queries = synthetic_clustered(2000, 32, n_queries=64, seed=1)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, seed=2)
    ref = RefHnsw(cfg)
    ref.build(base)
    g, _, _ = G.from_ref(ref, cfg)
    gd = G.to_device(g, "cuda")
    upper = np.where(np.asarray(ref.levels) >= 1)[0]
    upper_ids = torch.from_numpy(np.concatenate(
        [upper, np.full(256 - len(upper) % 256, g.sentinel)]).astype(
            np.int32))
    allowed = torch.from_numpy(np.random.default_rng(0).random(g.cap + 1)
                               < 0.5)
    for kw in (dict(expand=1, descent_ef=1), dict(expand=4, descent_ef=8),
               dict(expand=2, descent_ef=4, upper_ids=upper_ids),
               dict(expand=2, descent_ef=1, allowed=allowed)):
        args = dict(entry=ref.entry, entry_level=ref.entry_level, k=10,
                    ef_search=48, metric=cfg.metric, with_counters=True)
        cpu = SE.search(g, torch.from_numpy(queries), **args, **kw)
        card_kw = {k: (v.cuda() if isinstance(v, torch.Tensor) else v)
                   for k, v in kw.items()}
        card = SE.search(gd, torch.from_numpy(queries).cuda(), **args,
                         **card_kw)
        torch.testing.assert_close(card[0].cpu(), cpu[0], rtol=RTOL,
                                   atol=1e-5)
        for a, b in zip(card[1:], cpu[1:]):
            assert torch.equal(a.cpu(), b), kw
