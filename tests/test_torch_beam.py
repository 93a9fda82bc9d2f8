"""The level-0 serving beam: tpu_hnsw_torch.ops.beam and its use in
tpu_hnsw_torch.index.search.search.

- the rule (``kernel_takes``, ``path``): f32 storage, expand 1, ef up to
  ``BEAM_MAX_EF``, degree up to ``MAX_DEGREE``, not a resumable scan; a
  CPU tensor takes the loop, counted as ``"plain"``;
- ``_count_beam`` on a history shaped as the kernel leaves it (a sentinel
  tail a query, the longest beam read in the same host read) against a
  hand count;
- idle is absorbing, the claim the kernel's per-query termination rests
  on: the lockstep loop testing termination before every step and every
  fourth returns the same pools, counters and (where the ring did not
  wrap) rings;
- the CUDA kernel against the loop on the card (needs a card; skips here):
  on integer-valued rows, whose f32 sums are exact in any order, every
  output equal (ids, scores, counters, rings where they did not wrap), at
  ties everywhere; on the clustered rows as they are, ids on >= 99.9% of
  rows (a near-tie may flip with the sum order), distances within f32
  rounding, steps and rings on the rows that agree, evals on 99.9% of
  them.

No JAX here, so the card's machine, which has none, runs the card tests:
``python -m pytest --noconftest tests/test_torch_beam.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import search as SE
from tpu_hnsw_torch.index.ref_impl import RefHnsw
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.ops import beam as B

torch.set_num_threads(1)

def _takes(**kw) -> bool:
    args = dict(expand=1, ef=40, metric=Metric.L2, degree=32)
    dtype = kw.pop("dtype", torch.float32)
    return B.kernel_takes(dtype, **{**args, **kw})


# ------------------------------------------------------------ the CPU


def test_the_rule_sends_what_the_kernel_does_not_take_to_the_loop():
    assert _takes()
    assert _takes(ef=B.BEAM_MAX_EF) and _takes(degree=B.MAX_DEGREE)
    for metric in (Metric.IP, Metric.COSINE, Metric.L1):
        assert _takes(metric=metric)
    assert not _takes(dtype=torch.bfloat16)
    assert not _takes(expand=2)
    assert not _takes(ef=B.BEAM_MAX_EF + 1)
    assert not _takes(degree=B.MAX_DEGREE + 1)
    assert not _takes(resumable=True)
    assert not _takes(metric=Metric.HAMMING)


@pytest.fixture(scope="module")
def small():
    """600 x 12 clustered rows, 24 queries, a RefHnsw graph (m 8)."""
    base, queries = synthetic_clustered(600, 12, n_queries=24, seed=3)
    cfg = HnswConfig(dim=12, m=8, ef_construction=32, seed=4)
    ref = RefHnsw(cfg)
    ref.build(base)
    g, _, _ = G.from_ref(ref, cfg)
    return base, queries, cfg, g, ref


def test_a_cpu_tensor_takes_the_loop_and_counts_plain(small):
    """Every serving beam on the CPU is the loop, counted ``"plain"``,
    whatever the rule says of its shape; the resumable scans too."""
    _, queries, cfg, g, ref = small
    q = torch.from_numpy(queries)
    assert B.path(g, q, expand=1, ef=40, metric=cfg.metric) == "plain"
    assert B.path(g, q, expand=2, ef=400, metric=cfg.metric) == "plain"
    before = dict(B.BEAM_LAUNCHES)
    kw = dict(entry=ref.entry, entry_level=ref.entry_level, k=10,
              metric=cfg.metric)
    SE.search(g, q, ef_search=40, **kw)
    SE.search(g, q, ef_search=40, expand=2, **kw)
    _, _, state = SE.search_resumable_start(
        g, q, ref.entry, ref.entry_level, ef=20, metric=cfg.metric)
    SE.search_resume(g, q, state, ef=40, metric=cfg.metric)
    assert B.BEAM_LAUNCHES == {**before, "plain": before["plain"] + 4}


def test_count_beam_reads_a_kernel_shaped_history():
    """Each query's expanded ids, then the sentinel: the rows are the
    expanded ids, the vectors the distinct live (and allowed) ids of the
    seeds and of those rows; the longest beam comes back and is read in
    the same host read; a beam whose ring wrapped is not counted."""
    cfg = HnswConfig(dim=4, m=2)
    g = G.init_graph(cfg, 10, "cpu")
    s = g.sentinel
    g.neighbors0[:10] = torch.tensor(
        [[1, 2, 3, s], [0, 2, s, s], [0, 1, 4, 5], [0, 6, s, s],
         [2, 7, 8, s], [2, 9, s, s], [3, s, s, s], [4, s, s, s],
         [4, 9, s, s], [5, 8, s, s]], dtype=torch.int32)
    g.deleted[7] = True
    allowed = torch.ones(11, dtype=torch.bool)
    allowed[9] = False
    seeds = torch.tensor([[0, s], [4, 7]], dtype=torch.int32)
    hist = torch.tensor([[0, 2, 1, s, s], [4, 8, s, s, s]],
                        dtype=torch.int32)
    steps = torch.tensor([3, 2], dtype=torch.int32)
    # query 0: seeds {0}, rows 0, 2, 1 -> {1, 2, 3} | {0, 1, 4, 5} | {0, 2}
    # query 1: seeds {4, 7} (a deleted seed is still read), rows 4, 8 ->
    # {2, 8} (7 deleted) | {4} (9 disallowed)
    want_vectors = len({0, 1, 2, 3, 4, 5}) + len({4, 7, 2, 8})
    r0, v0, c0 = SE.BEAM_ROWS, SE.BEAM_VECTORS, SE.BEAM_COUNTED
    assert SE._count_beam(g, seeds, hist, steps, 1, allowed) == 3
    assert (SE.BEAM_ROWS - r0, SE.BEAM_VECTORS - v0,
            SE.BEAM_COUNTED - c0) == (5, want_vectors, 1)
    wrapped = torch.tensor([6, 2], dtype=torch.int32)
    assert SE._count_beam(g, seeds, hist, wrapped, 1, allowed) == 6
    assert SE.BEAM_COUNTED - c0 == 1  # not counted
    # the loop's host count reads the same history the same way
    assert SE._count_beam(g, seeds, hist, 3, 1, allowed) == 3
    assert (SE.BEAM_ROWS - r0, SE.BEAM_VECTORS - v0) == (
        10, 2 * want_vectors)


def _graph(metric: Metric, seed: int):
    """A 600 x 12 RefHnsw graph for ``metric`` (rows normalised for
    cosine), 24 queries, seeds [24, 3] with sentinel columns."""
    base, queries = synthetic_clustered(600, 12, n_queries=24, seed=seed)
    if metric is Metric.COSINE:
        base = base / np.linalg.norm(base, axis=1, keepdims=True)
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cfg = HnswConfig(dim=12, metric=metric, m=8, ef_construction=32,
                     seed=4)
    ref = RefHnsw(cfg)
    ref.build(base)
    g, _, _ = G.from_ref(ref, cfg)
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 600, (24, 3)).astype(np.int32)
    seeds[::5, 1] = g.sentinel
    return g, torch.from_numpy(queries), torch.from_numpy(seeds), rng


@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.COSINE])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ef", [40, 60])
def test_idle_is_absorbing(metric, masked, ef, monkeypatch):
    """A query whose termination test fails stays idle: the loop testing
    before every step returns the pools, counters and steps of the loop
    testing every fourth, so a query may stop at its own first failing
    test. The rings are equal where they did not wrap (ef 40: 56 steps in
    56 slots); at ef 60 (76 steps, 64 slots) the idle steps' sentinels may
    overwrite a finished query's slots."""
    g, q, seeds, rng = _graph(metric, 11 + ef)
    allowed = None
    if masked:
        g.deleted[torch.from_numpy(rng.choice(600, 60, replace=False))] = \
            True
        allowed = torch.from_numpy(rng.random(g.cap + 1) < 0.6)
    kw = dict(level0=True, ef=ef, expand=1, max_steps=ef + 16,
              metric=metric, skip_deleted=True, mask_deleted_results=True,
              with_counters=True, return_state=True, allowed=allowed)
    outs = []
    for every in (1, 4):
        monkeypatch.setattr(SE, "CHECK_EVERY", every)
        steps0 = SE.BEAM_STEPS
        outs.append((SE._search_layer_body(g, q, seeds, 0, **kw),
                     SE.BEAM_STEPS - steps0))
    (d1, i1, s1), n1 = outs[0]
    (d4, i4, s4), n4 = outs[1]
    assert torch.equal(d1, d4) and torch.equal(i1, i4)
    for a, b in zip(s1[:3] + s1[4:], s4[:3] + s4[4:]):
        assert torch.equal(a, b)  # pool, flags, hops, evals
    # the lockstep loop's steps are the longest beam's, rounded up to
    # the next test
    assert n1 == int(s1[4].max()) and n1 <= n4 < n1 + 4
    if ef + 16 <= SE.ring_width(ef + 16, 1):
        assert torch.equal(s1[3], s4[3])


# ------------------------------------------------------------ the card

#: rows, dim and queries of the cell-shaped graph (sift1m-graph.bulk's
#: request at a tenth of its rows)
CELL_N, CELL_D, CELL_Q = 100_000, 128, 4096


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cell():
    """A bulk-built graph at the cell's m 16 / ef_construction 64 on the
    card, its queries and route-scan seeds; the same graph with integer
    rows in [-4, 4] and integer queries."""
    from tpu_hnsw_torch import HnswIndex

    dev = _card()
    base, queries = synthetic_clustered(CELL_N, CELL_D, n_queries=CELL_Q,
                                        seed=21)
    cfg = HnswConfig(dim=CELL_D, m=16, ef_construction=64, seed=0)
    idx = HnswIndex(cfg, device=dev).build(torch.from_numpy(base).to(dev),
                                           mode="bulk")
    q = torch.from_numpy(queries).to(dev)
    seeds = SE.scan_seeds(idx.graph, q, idx._route_table()[0],
                          descent_ef=1, metric=Metric.L2)
    gen = torch.Generator(device=dev).manual_seed(8)
    g = idx.graph
    ints = g._replace(vectors=torch.randint(
        -4, 5, g.vectors.shape, generator=gen, device=dev).float())
    ints.vectors[g.sentinel] = 0
    qi = torch.randint(-4, 5, q.shape, generator=gen, device=dev).float()
    return idx, q, seeds, ints, qi


def _magnitude(g, q, ids, metric: Metric) -> torch.Tensor:
    """float64 sum of the absolute terms of each (query, id) score: the
    scale of its f32 rounding."""
    x = g.vectors[ids.long()].double()
    qq = q.double()[:, None, :]
    if metric is Metric.L2:
        return ((qq - x) ** 2).sum(-1)
    if metric is Metric.L1:
        return (qq - x).abs().sum(-1)
    return (qq * x).abs().sum(-1)


def _kernel_against_loop(g, q, seeds, *, ef: int, metric: Metric,
                         allowed=None, exact: bool = True,
                         share: float = 0.999):
    """Runs both on the card and holds the kernel to the loop: every row
    equal where ``exact`` (integer rows), else ids equal on ``share`` of
    the rows and the rest as the module says."""
    max_steps = ef + 16
    ring = SE.ring_width(max_steps, 1)
    launches = B.BEAM_LAUNCHES["kernel"]
    kd, ki, kh, khops, kevals = B.beam_level0(
        g, q, seeds, ef=ef, max_steps=max_steps, metric=metric, ring=ring,
        allowed=allowed)
    assert B.BEAM_LAUNCHES["kernel"] == launches + 1
    ld, li, state = SE._search_layer_body(
        g, q, seeds, 0, level0=True, ef=ef, expand=1, max_steps=max_steps,
        metric=metric, skip_deleted=True, mask_deleted_results=True,
        with_counters=True, return_state=True, allowed=allowed)
    torch.cuda.synchronize()
    Q = q.shape[0]
    same = (ki == li).all(1)
    assert int(same.sum()) >= (Q if exact else share * Q), \
        f"ids differ on {Q - int(same.sum())} of {Q} rows"
    if exact:
        assert torch.equal(kd, ld)
    # the scores differ only in their f32 sum order: each within
    # 2 d eps of its terms' absolute sum from the loop's
    fin = torch.isfinite(kd) & same[:, None]
    assert torch.equal(torch.isfinite(kd)[same], torch.isfinite(ld)[same])
    mag = _magnitude(g, q, torch.where(fin, ki, 0), metric)
    tol = 2 * q.shape[1] * float(np.finfo(np.float32).eps) * mag
    gap = (kd.double() - ld.double()).abs()
    assert bool((gap[fin] <= tol[fin]).all()), float(gap[fin].max())
    assert torch.equal(khops[same], state[4][same])
    # a near-tie at the pool's last slot can keep a node in one pool and
    # drop it from the other, which then scores it again: the same
    # expansions with one eval more (2 of 4,096 rows in IP on an H100)
    evals_same = kevals[same] == state[5][same]
    assert int(evals_same.sum()) >= (evals_same.numel() if exact
                                     else share * evals_same.numel())
    if max_steps <= ring:  # the ring did not wrap
        assert torch.equal(kh[same], state[3][same])
    assert int(khops.max()) <= max_steps
    got = ki[ki != g.sentinel].long()
    assert not bool(g.deleted[got].any())
    if allowed is not None:
        assert bool(allowed[got].all())
    return same


@pytest.mark.cuda
def test_kernel_equals_loop_at_the_cell_shape(cell):
    """4,096 queries, d 128, ef 40, m 16 on a 100k-row bulk-built graph,
    seeded by the dense route, as sift1m-graph.bulk serves them."""
    idx, q, seeds, ints, qi = cell
    _kernel_against_loop(idx.graph, q, seeds, ef=40, metric=Metric.L2,
                         exact=False)
    _kernel_against_loop(ints, qi, seeds, ef=40, metric=Metric.L2)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 33, 512])
@pytest.mark.parametrize("ef", [10, 41, 256])
def test_kernel_equals_loop_at_other_widths(cell, Q, ef):
    _, _, seeds, ints, qi = cell
    _kernel_against_loop(ints, qi[:Q], seeds[:Q], ef=ef, metric=Metric.L2)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.IP, Metric.COSINE, Metric.L1])
def test_kernel_equals_loop_in_each_metric(cell, metric):
    """The cell's graph scored by another metric: the beam's function does
    not depend on how the graph was built. Integer rows (cosine scores as
    IP does), then the clustered rows (normalised for IP and cosine), whose
    normalised scores crowd within f32 rounding of each other: 21 of 4,096
    pools differed from the loop's in IP on an H100, so 99% here; the
    integer rows show that only the scores' rounding can part them."""
    idx, q, seeds, ints, qi = cell
    _kernel_against_loop(ints, qi, seeds, ef=40, metric=metric)
    g = idx.graph
    if metric is not Metric.L1:
        g = g._replace(vectors=torch.nn.functional.normalize(g.vectors,
                                                             dim=1))
        q = torch.nn.functional.normalize(q, dim=1)
    _kernel_against_loop(g, q, seeds, ef=40, metric=metric, exact=False,
                         share=0.99)


@pytest.mark.cuda
@pytest.mark.parametrize("ef", [40, 64])
def test_kernel_equals_loop_with_gaps_deletes_and_a_filter(cell, ef):
    """Adjacency rows padded with sentinels (half the rows keep 5-20 of
    their 32 links), seeds with sentinel columns and an unseeded row, 5%
    of rows deleted, and a 60% filter; each alone, then all together, on
    integer rows."""
    _, _, seeds, g, q = cell
    dev = q.device
    gen = torch.Generator(device=dev).manual_seed(5)
    cut = torch.randint(5, 21, (g.cap + 1, 1), generator=gen, device=dev)
    short = torch.rand((g.cap + 1, 1), generator=gen, device=dev) < 0.5
    col = torch.arange(g.neighbors0.shape[1], device=dev)[None, :]
    gaps = g._replace(neighbors0=torch.where(
        short & (col >= cut), g.sentinel, g.neighbors0).contiguous())
    deleted = g.deleted.clone()
    deleted[:g.cap] = torch.rand(g.cap, generator=gen, device=dev) < 0.05
    allowed = torch.rand(g.cap + 1, generator=gen, device=dev) < 0.6
    wide = torch.cat([seeds[:1024], torch.randint(
        0, g.cap, (1024, 2), generator=gen, device=dev,
        dtype=torch.int32)], 1)
    wide[::7, 1] = g.sentinel
    wide[3] = g.sentinel
    qq = q[:1024]
    _kernel_against_loop(gaps, qq, wide, ef=ef, metric=Metric.L2)
    _kernel_against_loop(g._replace(deleted=deleted), qq, wide, ef=ef,
                         metric=Metric.L2)
    _kernel_against_loop(g, qq, wide, ef=ef, metric=Metric.L2,
                         allowed=allowed)
    _kernel_against_loop(gaps._replace(deleted=deleted), qq, wide, ef=ef,
                         metric=Metric.L2, allowed=allowed)


@pytest.mark.cuda
def test_search_launches_the_kernel_once_a_call(cell):
    """``search()`` on the card: one kernel launch a call where the rule
    takes it, the loop (counted ``"loop"``) at expand 2 and past
    ``BEAM_MAX_EF``."""
    idx, q, _, _, _ = cell
    qq = q[:256]
    before = dict(B.BEAM_LAUNCHES)
    for _ in range(3):
        idx.search_device(qq, k=10, ef_search=40)
    idx.search_device(qq, k=10, ef_search=40, expand=2)
    idx.search_device(qq, k=10, ef_search=B.BEAM_MAX_EF + 1)
    assert B.BEAM_LAUNCHES == {**before, "kernel": before["kernel"] + 3,
                               "loop": before["loop"] + 2}
