"""The route: tpu_hnsw_torch.ops.route.

- the plain version against ``topk_smallest_by_index`` over
  ``centroid_scores`` (L2 and IP, one group and eight, padded groups) and
  against the reference's ``_route_exact_body`` on tie-heavy integer data;
- the dispatch: a CPU tensor takes the plain version, bf16 centroids or
  ``p > MAX_P`` the GEMM + top-k chain, each counted by path (the fused
  path by kernel launch), the chain under the plain version's contract;
- the split of a group's centroids over CTAs at the cells' shapes;
- the CUDA kernel against the plain version (needs a card; skips here):
  integer-valued rows, whose f32 dots are exact in any summation order, so
  ids must be equal (ties to the lower index, planted duplicates, ragged
  shapes, padded groups), and normal rows at the benchmark cells' shapes,
  held to the float64 scores within the f32 tolerance; the top-1 epilogue
  (p 1) at the graph route's shape, a sentinel tail, and ragged, split and
  unsplit grids.

The JAX package is imported inside the one test that compares with it, so
the card's machine, which has no JAX, can run the card tests alone:
``python -m pytest --noconftest tests/test_torch_route.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import route as R
from tpu_hnsw_torch.ops import topk as T

torch.set_num_threads(1)

METRICS = [Metric.L2, Metric.IP]
#: the graph route's table in ``sift1m-graph.bulk``: ~62,400 level >= 1
#: elements of 1M, sentinel padded to a multiple of 256
GRAPH_LIVE = 62_400
GRAPH_U = 62_464


def _case(seed, Q, L, b, d, *, ints=False, dup=0, normal_rows=False):
    """(centroids [L, b, d], c_sq [L, b], q [Q, d], q_sq [Q]) f32 on the CPU:
    integers in [-4, 4] (exact dots) or normal rows; ``dup`` centroids of
    each group copied onto later columns."""
    rng = np.random.default_rng(seed)
    if ints:
        c = rng.integers(-4, 5, size=(L, b, d)).astype(np.float32)
        q = rng.integers(-4, 5, size=(Q, d)).astype(np.float32)
    else:
        c = rng.normal(size=(L, b, d)).astype(np.float32)
        q = rng.normal(size=(Q, d)).astype(np.float32)
        if normal_rows:
            c /= np.linalg.norm(c, axis=-1, keepdims=True)
            q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for k in range(dup):
        src, dst = rng.integers(0, b, size=2)
        c[:, max(src, dst)] = c[:, min(src, dst)]
    c, q = torch.from_numpy(c), torch.from_numpy(q)
    return c, (c * c).sum(-1), q, (q * q).sum(-1)


def _by_index(c, csq, q, qsq, p, metric):
    L, b, _ = c.shape
    sc = R.centroid_scores(c.reshape(L * b, -1), csq.reshape(-1), q, qsq,
                           metric).view(q.shape[0], L, b)
    return sc, T.topk_smallest_by_index(sc, p)[1]


# ------------------------------------------------------------ the CPU


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("L", [1, 8])
def test_plain_equals_topk_by_index(metric, L):
    """On integer rows (ties everywhere) the plain version's ids are
    ``topk_smallest_by_index``'s: ascending score, ties to the lower id;
    a ``[b, d]`` table is one group."""
    c, csq, q, qsq = _case(1, 23, L, 300, 16, ints=True, dup=5)
    _, want = _by_index(c, csq, q, qsq, 7, metric)
    got = R.route_topk_reference(c, csq, q, qsq, 7, metric)
    assert torch.equal(got, want)
    if L == 1:
        assert torch.equal(
            R.route_topk_reference(c[0], csq[0], q, qsq, 7, metric), want)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("offset", [False, True])
def test_plain_padded_groups(metric, offset):
    """Columns past a group's live count are never chosen: a group with
    fewer live centroids than p gives its live ones, then -1; ``offset``
    adds l * b to group l's ids and leaves -1 alone."""
    L, b, p = 3, 40, 6
    c, csq, q, qsq = _case(2, 11, L, b, 8)
    live = torch.tensor([40, 17, 4], dtype=torch.int32)
    got = R.route_topk_reference(c, csq, q, qsq, p, metric, live=live,
                                 offset=offset)
    assert got.shape == (11, L, p)
    for l in range(L):
        n = int(live[l])
        _, want = _by_index(c[l:l + 1, :n], csq[l:l + 1, :n], q, qsq,
                            min(p, n), metric)
        want = want[:, 0] + (l * b if offset else 0)
        assert torch.equal(got[:, l, :min(p, n)], want)
        assert (got[:, l, min(p, n):] == -1).all()


def test_plain_wider_than_the_group():
    """p past b: the b ids in order, then -1."""
    c, csq, q, qsq = _case(3, 5, 2, 6, 4)
    got = R.route_topk_reference(c, csq, q, qsq, 9, Metric.L2, offset=True)
    _, want = _by_index(c, csq, q, qsq, 6, Metric.L2)
    assert torch.equal(got[..., :6], want + torch.tensor([0, 6])[:, None])
    assert (got[..., 6:] == -1).all()


@pytest.mark.parametrize("metric", METRICS)
def test_plain_equals_the_reference_route(metric):
    """The plain version's ids equal the reference's ``_route_exact_body``
    (one f32 dot and ``topk_smallest_fast``) on integer rows with planted
    duplicate centroids: rows of 200 centroids, where the reference takes
    the exact ``lax.top_k`` (ties to the lower index)."""
    import jax.numpy as jnp

    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.index.block import _route_exact_body

    c, csq, q, qsq = _case(4, 31, 1, 200, 12, ints=True, dup=8)
    want = np.asarray(_route_exact_body(
        jnp.asarray(c[0].numpy()), jnp.asarray(csq[0].numpy()),
        jnp.asarray(q.numpy()), jnp.asarray(qsq.numpy()), 200, p=9,
        metric=JMetric(metric.value)))
    got = R.route_topk_reference(c[0], csq[0], q, qsq, 9, metric)[:, 0]
    np.testing.assert_array_equal(got.numpy(), want)


def _counted(fn):
    before = dict(R.ROUTE_LAUNCHES)
    out = fn()
    return out, {k: R.ROUTE_LAUNCHES[k] - before[k] for k in before}


def test_dispatch_cpu_takes_the_plain_version():
    c, csq, q, qsq = _case(5, 9, 2, 50, 8)
    got, moved = _counted(lambda: R.route_topk(c, csq, q, qsq, 4, Metric.L2))
    assert moved == {"fused": 0, "gemm_topk": 0, "plain": 1}
    assert torch.equal(got,
                       R.route_topk_reference(c, csq, q, qsq, 4, Metric.L2))


def test_dispatch_bf16_takes_the_gemm_topk_chain():
    """bf16 centroids keep the chain (the query rounded to bf16, f32
    sums), whatever the device."""
    c, csq, q, qsq = _case(6, 9, 1, 300, 8)
    cb = c.to(torch.bfloat16)
    got, moved = _counted(
        lambda: R.route_topk(cb[0], csq[0], q, qsq, 4, Metric.IP))
    assert moved == {"fused": 0, "gemm_topk": 1, "plain": 0}
    want = T.topk_smallest_fast(
        R.centroid_scores(cb[0], csq[0], q, qsq, Metric.IP), 4)[1]
    assert torch.equal(got[:, 0], want)
    assert not R.fused(cb, 4) and R.fused(c, 4)


def test_dispatch_wide_p_takes_the_gemm_topk_chain():
    c, csq, q, qsq = _case(7, 9, 2, 200, 8)
    live = torch.tensor([200, 150], dtype=torch.int32)
    p = R.MAX_P + 1
    got, moved = _counted(lambda: R.route_topk(
        c, csq, q, qsq, p, Metric.L2, live=live, offset=True))
    assert moved == {"fused": 0, "gemm_topk": 1, "plain": 0}
    assert got.shape == (9, 2, p)
    # group 1's ids are its live columns, offset by its 200 centroids
    assert (got[:, 1] >= 200).all() and (got[:, 1] < 350).all()


@pytest.mark.parametrize("metric", METRICS)
def test_chain_shares_the_plain_contract(metric):
    """The GEMM + top-k chain (bf16 centroids here) gives what the fused
    path gives past a group's live centroids: -1, never a padded id, and
    the stacked offsets on live ids alone."""
    L, b, p = 3, 300, 9
    c, csq, q, qsq = _case(8, 13, L, b, 8)
    cb = c.to(torch.bfloat16)
    live = torch.tensor([300, 120, 5], dtype=torch.int32)
    got, moved = _counted(lambda: R.route_topk(
        cb, csq, q, qsq, p, metric, live=live, offset=True))
    assert moved == {"fused": 0, "gemm_topk": 1, "plain": 0}
    want = R.route_topk_reference(cb, csq, q, qsq, p, metric, live=live,
                                  offset=True, select=T.topk_smallest_fast)
    assert torch.equal(got, want)
    assert (got[:, 2, 5:] == -1).all() and (got[:, 2, :5] >= 2 * b).all()
    assert ((got[:, 1] >= b) & (got[:, 1] < b + 120)).all()


@pytest.mark.parametrize("shape,want", [
    ((4096, 8, 5127, 8), 1),     # deep10m.bulk: 256 CTAs already
    ((4096, 1, 4102, 8), 9),     # sift1m.bulk: 32 query tiles x 9 ranges
    ((32, 1, 4102, 8), 33),      # sift1m.interactive: a tile a CTA
    ((4096, 1, GRAPH_U, 1), 8),  # sift1m-graph.bulk: 32 tiles x 8 ranges
])
def test_split_count_at_the_cells(shape, want):
    """At an H100's 132 SMs x 2 CTAs, at p 8 and at p 1 (the top-1
    instantiation also holds two CTAs an SM: registers bound it)."""
    assert R.split_count(*shape, 264) == want


@pytest.mark.parametrize("Q,L,b,p", [(1, 1, 1, 1), (5, 3, 9000, 128),
                                     (100000, 1, 300, 40), (7, 2, 70, 33)])
def test_split_count_limits(Q, L, b, p):
    """At most MAX_SPLIT ranges a row, SPLIT_KEYS keys, and no range
    empty."""
    S = R.split_count(Q, L, b, p, 264)
    tiles = -(-b // R.TILE)
    assert 1 <= S <= min(R.MAX_SPLIT, tiles)
    assert S == 1 or S * p <= R.SPLIT_KEYS
    span = -(-tiles // S)
    assert -(-tiles // span) == S


# ------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *ts):
    return [t.to(dev) for t in ts]


def _kernel(c, csq, q, qsq, p, metric, live=None, offset=False):
    """The kernel's ids: through ``route_topk`` where it takes the kernel
    (p up to MAX_P), else through the launch itself (p up to
    KERNEL_MAX_P)."""
    if R.fused(c, p):
        return R.route_topk(c, csq, q, qsq, p, metric, live=live,
                            offset=offset)
    return R._launch(c, csq, q, qsq, p, metric, live, offset)


def _assert_equal_on_card(case, p, metric, live=None, offset=False):
    """The kernel's ids equal the plain version's (on the card: the same
    GEMM + keyed top-k in torch) and the fused counter moves once."""
    c, csq, q, qsq = _on(_card(), *case)
    if live is not None:
        live = live.to(c.device)
    want = R.route_topk_reference(c, csq, q, qsq, p, metric, live=live,
                                  offset=offset)
    got, moved = _counted(lambda: _kernel(c, csq, q, qsq, p, metric,
                                          live=live, offset=offset))
    torch.cuda.synchronize()
    assert moved == {"fused": 1, "gemm_topk": 0, "plain": 0}
    assert got.shape == want.shape
    bad = (got != want).any(-1).nonzero()[:3].tolist()
    assert torch.equal(got, want), bad
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(4096, 1, 4102, 128), (4096, 8, 5127, 96)],
                         ids=["sift1m_bulk", "deep10m_bulk"])
def test_kernel_exact_at_the_cells_shapes(metric, shape):
    """Integer rows at the cells' shapes (p 8): every dot is exact, so the
    kernel's ids equal the plain version's, ties to the lower index."""
    Q, L, b, d = shape
    _assert_equal_on_card(_case(10, Q, L, b, d, ints=True, dup=20), 8,
                          metric)


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 32, 4097])
@pytest.mark.parametrize("p", [1, 8, 34, 128])
def test_kernel_ragged_shapes(Q, p):
    """Q in {1, 32, 4097} (a partly filled query tile), b = 300 (not a
    multiple of the 128-centroid tile), p up to KERNEL_MAX_P, two
    groups."""
    _assert_equal_on_card(_case(11 + p, Q, 2, 300, 20, ints=True, dup=6), p,
                          Metric.L2, offset=True)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [R.MAX_P + 1, 34, 105])
def test_card_wide_p_takes_the_gemm_topk_chain(p):
    """Past MAX_P, where the chain is the faster, a card's f32 route takes
    it: the plain version with ``topk_smallest_fast``, one chain counted,
    no launch; padded columns give -1 as on the fused path."""
    c, csq, q, qsq = _on(_card(), *_case(18, 700, 2, 600, 24))
    live = torch.tensor([600, 200], dtype=torch.int32, device=c.device)
    got, moved = _counted(lambda: R.route_topk(
        c, csq, q, qsq, p, Metric.L2, live=live, offset=True))
    assert moved == {"fused": 0, "gemm_topk": 1, "plain": 0}
    want = R.route_topk_reference(c, csq, q, qsq, p, Metric.L2, live=live,
                                  offset=True, select=T.topk_smallest_fast)
    assert torch.equal(got, want)
    assert ((got[:, 1] >= 600) & (got[:, 1] < 800)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Q,L", [(0, 2), (5, 0)])
def test_kernel_empty_launches_nothing(Q, L):
    """No query or no group: an empty ``[Q, L, p]`` result, and the fused
    counter, which counts launches, stays put."""
    c, csq, q, qsq = _on(_card(), *_case(17, Q, L, 50, 8))
    got, moved = _counted(lambda: R.route_topk(c, csq, q, qsq, 4,
                                               Metric.L2))
    assert got.shape == (Q, L, 4)
    assert moved == {"fused": 0, "gemm_topk": 0, "plain": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_kernel_planted_duplicates_take_the_lower_index(metric):
    """Every centroid of normal rows has an exact copy at another column:
    a pair scores bit-equal, so the ten chosen are five pairs, the lower
    column of each first."""
    dev = _card()
    c, _, q, qsq = _case(12, 300, 1, 700, 32)
    perm = torch.randperm(1400, generator=torch.Generator().manual_seed(0))
    c = torch.cat([c, c], 1)[:, perm]
    c, csq, q, qsq = _on(dev, c, (c * c).sum(-1), q, qsq)
    got, moved = _counted(lambda: R.route_topk(c, csq, q, qsq, 10, metric))
    assert moved == {"fused": 1, "gemm_topk": 0, "plain": 0}
    twin = perm.to(dev) % 700  # each column's source row
    src = twin[got[:, 0]]
    assert torch.equal(src[:, 0::2], src[:, 1::2])
    assert (got[:, 0, 0::2] < got[:, 0, 1::2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("metric,p", [
    pytest.param(metric, p, id=str(metric) + ("-p1" if p == 1 else ""))
    for p in (8, 1) for metric in METRICS])
def test_kernel_never_chooses_padding(metric, p):
    """Groups with 5,127, 3,000, 130 and 3 live centroids of 5,127 (the
    stacked layout's padding): no id past a group's live count, -1 past a
    row's live centroids, ids offset into the stacked table; at p 8 and
    through the top-1 epilogue."""
    L, b = 4, 5127
    live = torch.tensor([5127, 3000, 130, 3], dtype=torch.int32)
    got = _assert_equal_on_card(_case(13, 600, L, b, 24, ints=True), p,
                                metric, live=live, offset=True)
    for l in range(L):
        ids = got[:, l]
        n = int(live[l])
        ok = ids >= 0
        assert (ids[ok] >= l * b).all() and (ids[ok] < l * b + n).all()
        assert ok[:, :min(p, n)].all() and not ok[:, min(p, n):].any()


def _graph_table(seed, Q, U, live, d):
    """The graph route's operands on the card, integer rows: ``[U, d]``
    gathered upper vectors (one group) whose rows past ``live`` are the
    sentinel's zero row, their norms, the queries and theirs."""
    c, _, q, _ = _case(seed, Q, 1, U, d, ints=True)
    c = c[0]
    c[live:] = 0.0
    c, q = _on(_card(), c, q)
    return c, (c * c).sum(-1), q, (q * q).sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", [Metric.L2, Metric.IP, Metric.COSINE])
def test_top1_exact_at_the_graph_shape(metric):
    """The graph route at ``sift1m-graph.bulk``'s shape: 4,096 queries
    against 62,400 live of 62,464 upper vectors (a sentinel tail), d 128,
    p 1. On integer rows (exact dots, ties everywhere) the top-1 epilogue's
    ids equal the plain version's, ties to the lower index; no sentinel
    column is chosen, though under IP a zero row would beat every row whose
    dot is negative."""
    c, csq, q, qsq = _graph_table(20, 4096, GRAPH_U, GRAPH_LIVE, 128)
    live = torch.tensor([GRAPH_LIVE], dtype=torch.int32, device=c.device)
    got = _assert_equal_on_card((c, csq, q, qsq), 1, metric, live=live)
    assert ((got >= 0) & (got < GRAPH_LIVE)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("Q,U,live,split", [
    (77, 1000, 999, True),       # one query tile, 8 ranges
    (4097, 300, 300, True),      # a partly filled query tile, 3 ranges
    (33_000, 1000, 1000, False),  # 258 query tiles fill the card unsplit
    (5, 130, 3, True),           # fewer live columns than a tile
])
def test_top1_ragged_shapes(Q, U, live, split):
    """p 1 at ragged shapes: Q not a multiple of the 128-query tile, U
    not a multiple of the 128-centroid tile, a split grid (keys through
    ``route_topk_reduce``) and an unsplit one."""
    c, csq, q, qsq = _graph_table(21, Q, U, live, 20)
    S = R.split_count(Q, 1, U, 1, R._slots(c.device.index or 0, 1))
    assert (S > 1) == split
    _assert_equal_on_card((c, csq, q, qsq), 1, Metric.L2,
                          live=torch.tensor([live], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_top1_planted_duplicates_take_the_lower_index(metric):
    """Every centroid of normal rows has an exact copy at another column:
    the pair scores bit-equal, so the one chosen is the lower column of
    its pair."""
    dev = _card()
    c, _, q, qsq = _case(22, 300, 1, 700, 32)
    perm = torch.randperm(1400, generator=torch.Generator().manual_seed(1))
    c = torch.cat([c, c], 1)[:, perm]
    c, csq, q, qsq = _on(dev, c, (c * c).sum(-1), q, qsq)
    got, moved = _counted(lambda: R.route_topk(c, csq, q, qsq, 1, metric))
    assert moved == {"fused": 1, "gemm_topk": 0, "plain": 0}
    src = perm.to(dev) % 700  # each column's source row
    first = torch.full((700,), 1400, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, src, torch.arange(1400, device=dev), "amin")
    assert torch.equal(got[:, 0, 0], first[src[got[:, 0, 0]]])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_top1_and_p8_on_the_same_inputs(metric):
    """p 8 (the survivor epilogue) still equals the plain version on the
    inputs p 1 (the top-1 epilogue) runs on, and p 1's id is p 8's
    first."""
    case = _case(23, 1000, 1, 4102, 64, ints=True, dup=30)
    p8 = _assert_equal_on_card(case, 8, metric)
    p1 = _assert_equal_on_card(case, 1, metric)
    assert torch.equal(p1[..., 0], p8[..., 0])


@pytest.mark.cuda
def test_kernel_odd_width_and_unaligned_queries():
    """d = 37, and d = 40 with a query table 4 bytes past 16-byte
    alignment, take the 4-byte copies; ids equal the plain version's."""
    _assert_equal_on_card(_case(14, 700, 3, 1000, 37, ints=True), 12,
                          Metric.L2)
    dev = _card()
    c, csq, q, qsq = _on(dev, *_case(16, 700, 3, 1000, 40, ints=True))
    qd = torch.cat([torch.zeros(1, device=dev), q.reshape(-1)])[1:]
    qd = qd.view(700, 40)
    assert qd.data_ptr() % 16 == 4
    want = R.route_topk_reference(c, csq, qd, qsq, 12, Metric.L2)
    assert torch.equal(R.route_topk(c, csq, qd, qsq, 12, Metric.L2), want)


def _f64_gap(got, c, q, metric, live=None):
    """The widest margin by which a chosen centroid's float64 score is
    worse than an unchosen live one's, and the widest inversion of the
    chosen order, over every row."""
    c64, q64 = c.double(), q.double()
    L, b, _ = c.shape
    dots = torch.einsum("qd,lbd->qlb", q64, c64)
    sc = ((q64 * q64).sum(1)[:, None, None] + (c64 * c64).sum(-1)[None]
          - 2 * dots) if metric is Metric.L2 else -dots
    if live is not None:
        sc = torch.where(torch.arange(b, device=sc.device)[None, None, :]
                         >= live.to(sc.device)[None, :, None], torch.inf, sc)
    chosen = torch.gather(sc, 2, got)
    others = sc.scatter(2, got, torch.inf).amin(-1)
    worst = (chosen.amax(-1) - others).clamp_min(0).max().item()
    order = ((chosen[..., :-1] - chosen[..., 1:]).clamp_min(0).max().item()
             if chosen.shape[-1] > 1 else 0.0)
    return worst, order


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", [(4096, 1, 4102, 128, 8),
                                   (4096, 8, 5127, 96, 8),
                                   (32, 1, 4102, 128, 8),
                                   (4096, 1, GRAPH_U, 128, 1)],
                         ids=["sift1m_bulk", "deep10m_bulk",
                              "sift1m_interactive", "sift1m_graph_bulk"])
def test_kernel_within_f32_of_float64(metric, shape):
    """Normal rows (unit rows for the IP shape, as DEEP's): every chosen
    centroid's float64 score is no worse than any unchosen one's, and the
    chosen order holds, within d * eps_f32 * (max |q|^2 + max |c|^2), the
    f32 tolerance of a dot summed in another order; and ids differ from
    the plain version's (a cuBLAS GEMM) in few rows, only at near-ties.
    The graph route's shape takes p 1."""
    dev = _card()
    Q, L, b, d, p = shape
    c, csq, q, qsq = _on(dev, *_case(15, Q, L, b, d,
                                     normal_rows=metric is Metric.IP))
    got = R.route_topk(c, csq, q, qsq, p, metric)
    want = R.route_topk_reference(c, csq, q, qsq, p, metric)
    tol = d * np.finfo(np.float32).eps * (
        (q * q).sum(1).max().item() + (c * c).sum(-1).max().item())
    worst, order = _f64_gap(got, c, q, metric)
    assert worst <= tol and order <= tol, (worst, order, tol)
    differ = (got != want).any(-1).float().mean().item()
    assert differ < 0.01, differ
