"""Batched, masked frontier-expansion beam search (port of
``tpu_hnsw/index/search.py``).

pgvector's per-query pointer-chasing ``HnswSearchLayer`` becomes a batch of
queries stepping in lockstep; each step

1. picks each query's best unexpanded pool candidate(s),
2. gathers their adjacency rows (one batched gather: the per-hop neighbour
   page read),
3. gathers the neighbour vectors and scores them (f32, elementwise),
4. merges the scored neighbours into the fixed-width pool by top-k.

Deduplication checks membership in the pool and in a ring of recent
expansions, memory O(Q * (ef + steps)) and independent of N. A node pruned
from the pool can be scored again (never expanded again): more distance
evaluations, never a lost candidate.

A query goes inactive when its best unexpanded candidate is farther than
its worst pooled result (the ``d_c > f`` break of ``HnswSearchLayer``). The
reference tests that for the whole batch before every step (a
``lax.while_loop`` condition); here it costs a host sync, so the loop
tests it every :data:`CHECK_EVERY` steps and never runs more than
``max_steps``. A step taken when no query is active changes nothing that
is returned: no query picks a candidate, so pools, expanded flags and
counters stay as they are, and only the history ring, which the caller
never reads (a resume resets it), takes sentinel entries. The results equal
the reference's.

Every top-k here orders ties by position, as ``lax.top_k`` does
(:func:`~tpu_hnsw_torch.ops.topk.topk_smallest_by_index`): hamming
distances on the binary graph are small integers and tie everywhere.
"""

from __future__ import annotations

import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.ops import beam as B
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import route as R
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.utils.profiling import annotate, tracing

#: steps between two termination tests of the lockstep loop (each a sync)
CHECK_EVERY = 4

#: level-0 beam steps run so far: the loop's lockstep steps; on the kernel
#: path (``ops/beam.py``) a request's longest beam, read only under an open
#: trace (:func:`_count_beam`)
BEAM_STEPS = 0
#: termination tests of the level-0 beam that read the device (host syncs)
BEAM_SYNCS = 0
#: the least work of the serving beams counted under an open trace
#: (:func:`_count_beam`): (query, expanded node) adjacency rows read, the
#: distinct vectors those rows and the seeds name (pgvector's visited set
#: reads each once), and the beams so counted
BEAM_ROWS = 0
BEAM_VECTORS = 0
BEAM_COUNTED = 0


def _neighbor_rows(g: G.HnswGraph, ids: torch.Tensor, level0: bool,
                   level: int) -> torch.Tensor:
    """Adjacency rows of ``ids`` at a level (the upper level clipped into
    the table, as the reference clips its dynamic level)."""
    if level0:
        return G.neighbor_rows(g, ids, 0)
    return G.neighbor_rows(g, ids, min(max(level, 1), g.upper_nbrs.shape[1]))


def init_pool(g: G.HnswGraph, q: torch.Tensor, init_ids: torch.Tensor,
              metric: Metric, ef: int):
    """A sorted pool of width ef from seed ids ``[Q, S]``."""
    v, _ = G.gather_vectors(g, init_ids)
    dists = D.batched_scores(q, v, metric)
    dists = torch.where(init_ids == g.sentinel, torch.inf, dists)
    s = init_ids.shape[1]
    if s < ef:
        dists = torch.nn.functional.pad(dists, (0, ef - s), value=torch.inf)
        init_ids = torch.nn.functional.pad(init_ids, (0, ef - s),
                                           value=g.sentinel)
    pool_d, sel = T.topk_smallest_by_index(dists, ef)
    return pool_d, torch.gather(init_ids, 1, sel)


def ring_width(max_steps: int, expand: int, hist_window: int = 64) -> int:
    """Slots of a beam's history ring: ``hist_window``, at most the ids
    ``max_steps`` steps of ``expand`` expand, at least one step's."""
    return max(min(hist_window, max_steps * expand), expand)


def _search_layer_body(g: G.HnswGraph, q: torch.Tensor, init_ids, level: int,
                       *, level0: bool, ef: int, expand: int, max_steps: int,
                       metric: Metric, skip_deleted: bool,
                       hist_window: int = 64,
                       mask_deleted_results: bool = False,
                       with_counters: bool = False, init_state=None,
                       return_state: bool = False,
                       reset_frontier: bool = False, allowed=None):
    """The beam at one level (search.py:86-271). ``q`` is ``[Q, d]`` in the
    storage dtype. ``allowed`` (``[cap+1]`` bool) keeps disallowed elements
    out of the pool like tombstones; seeds that are disallowed or deleted
    are masked out of the results at the end.

    ``with_counters`` adds per-query (hops, dist_evals) int32 counters.
    ``init_state`` / ``return_state`` make the search resumable: the state is
    (pool_d, pool_i, pool_x, hist, hops, evals); a resume may widen ef, and
    ``reset_frontier`` clears the expanded flags and the history so the kept
    pool becomes the new frontier.

    At level 0 each step run moves :data:`BEAM_STEPS`, and each
    termination test :data:`BEAM_SYNCS` (host ints: no launch, no sync)."""
    global BEAM_STEPS, BEAM_SYNCS
    E = min(expand, ef)
    deg = g.neighbors0.shape[1] if level0 else g.upper_nbrs.shape[2]
    sent = g.sentinel
    Q = q.shape[0]
    dev = q.device
    H = ring_width(max_steps, E, hist_window)
    hist_slots = max(H // E, 1)

    if init_state is not None:
        # the loop updates these in place; the caller's state stays as it was
        pool_d, pool_i, pool_x, hist, hops, evals = (
            t.clone() for t in init_state)
        if pool_d.shape[1] < ef:  # widen: pad with empty slots
            pad = ef - pool_d.shape[1]
            pool_d = torch.nn.functional.pad(pool_d, (0, pad),
                                             value=torch.inf)
            pool_i = torch.nn.functional.pad(pool_i, (0, pad), value=sent)
            pool_x = torch.nn.functional.pad(pool_x, (0, pad))
        if reset_frontier:
            # a widened resume: every retained entry is already expanded,
            # so the kept pool becomes the frontier again (search.py:155)
            pool_x = torch.zeros_like(pool_x)
            hist = torch.full((Q, H), sent, dtype=torch.int32, device=dev)
        if hist.shape[1] < H:
            hist = torch.nn.functional.pad(hist, (0, H - hist.shape[1]),
                                           value=sent)
        H = hist.shape[1]
        hist_slots = max(H // E, 1)
    else:
        pool_d, pool_i = init_pool(g, q, init_ids, metric, ef)
        pool_x = torch.zeros((Q, ef), dtype=torch.bool, device=dev)
        hist = torch.full((Q, H), sent, dtype=torch.int32, device=dev)
        hops = torch.zeros(Q, dtype=torch.int32, device=dev)
        evals = torch.zeros(Q, dtype=torch.int32, device=dev)

    if E > 1:
        col = torch.arange(E * deg, device=dev)
        earlier_col = col[None, None, :] < col[None, :, None]
    no_flags = torch.zeros((Q, E * deg), dtype=torch.bool, device=dev)

    for step in range(max_steps):
        valid = pool_i != sent
        unexp = valid & ~pool_x
        pool_max = torch.where(valid.all(1), pool_d.amax(1), torch.inf)
        # the E best unexpanded candidates within the termination bound
        cand_d, pos = T.topk_smallest_by_index(
            torch.where(unexp, pool_d, torch.inf), E)
        ok = torch.isfinite(cand_d) & (cand_d <= pool_max[:, None])
        if step % CHECK_EVERY == 0:
            BEAM_SYNCS += int(level0)
            if not bool(ok.any()):
                break  # no query is active: the reference's loop ends here
        BEAM_STEPS += int(level0)
        e_ids = torch.where(ok, torch.gather(pool_i, 1, pos), sent)
        pool_x.scatter_(1, pos, torch.gather(pool_x, 1, pos) | ok)
        s0 = (step % hist_slots) * E
        hist[:, s0:s0 + E] = e_ids

        nbrs = _neighbor_rows(g, e_ids, level0, level).reshape(Q, E * deg)
        fresh = nbrs != sent
        if skip_deleted:
            fresh &= ~g.deleted[nbrs]
        if allowed is not None:
            fresh &= allowed[nbrs]
        fresh &= ~(nbrs[:, :, None] == pool_i[:, None, :]).any(2)
        fresh &= ~(nbrs[:, :, None] == hist[:, None, :]).any(2)
        if E > 1:  # two expanded nodes may share a neighbour
            fresh &= ~((nbrs[:, :, None] == nbrs[:, None, :])
                       & earlier_col).any(2)

        v, _ = G.gather_vectors(g, nbrs)
        dists = torch.where(fresh, D.batched_scores(q, v, metric), torch.inf)
        ids = torch.where(fresh, nbrs, sent)
        pool_d, pool_i, pool_x = T.merge_pools(pool_d, pool_i, pool_x, dists,
                                               ids, no_flags, ef)
        if with_counters:
            hops += ok.any(1).to(torch.int32)
            evals += fresh.sum(1, dtype=torch.int32)

    state = (pool_d, pool_i, pool_x, hist, hops, evals)
    if mask_deleted_results or allowed is not None:
        # tombstoned or disallowed seeds navigate but are never returned;
        # expansion never adds them, so only seeds can be masked here
        if mask_deleted_results:
            drop = g.deleted[pool_i]
        else:
            drop = torch.zeros_like(pool_x)
        if allowed is not None:
            drop |= ~allowed[pool_i]
        pool_d, sel = T.topk_smallest_by_index(
            torch.where(drop, torch.inf, pool_d), ef)
        pool_i = torch.where(torch.isinf(pool_d), sent,
                             torch.gather(pool_i, 1, sel))
    if return_state:
        return pool_d, pool_i, state
    if with_counters:
        return pool_d, pool_i, hops, evals
    return pool_d, pool_i


def search_layer(g: G.HnswGraph, q: torch.Tensor, init_ids: torch.Tensor,
                 level: int = 0, *, level0: bool = True, ef: int,
                 expand: int = 1, max_steps: int = 0,
                 metric: Metric = Metric.L2, skip_deleted: bool = True,
                 allowed=None):
    """ef-bounded beam at one level from seeds ``[Q, S]``. Returns (pool
    dists ``[Q, ef]``, pool ids ``[Q, ef]``) ascending; sentinel ids carry
    +inf."""
    if max_steps <= 0:
        max_steps = 2 * ef + 16
    return _search_layer_body(g, q, init_ids, level, level0=level0, ef=ef,
                              expand=expand, max_steps=max_steps,
                              metric=metric, skip_deleted=skip_deleted,
                              allowed=allowed)


def _descend_body(g: G.HnswGraph, q: torch.Tensor, entry: int,
                  entry_level: int, down_to: int, metric: Metric,
                  max_steps: int = 128, descent_ef: int = 1) -> torch.Tensor:
    """Greedy descent from ``entry_level`` down to ``down_to`` (exclusive):
    seeds ``[Q, descent_ef]``. The reference runs it as a device loop over
    every table level (search.py:461-500); the entry level is known here,
    so the host loops over the levels that run. ``descent_ef=1`` is
    pgvector's ef=1 upper-level loop."""
    Q = q.shape[0]
    seeds = torch.full((Q, max(descent_ef, 1)), g.sentinel,
                       dtype=torch.int32, device=q.device)
    seeds[:, 0] = entry
    L = g.upper_nbrs.shape[1]
    for lvl in range(entry_level, max(down_to, entry_level - L), -1):
        seeds = _search_layer_body(
            g, q, seeds, lvl, level0=False, ef=descent_ef,
            expand=min(4, descent_ef), max_steps=max_steps, metric=metric,
            skip_deleted=True)[1]
    return seeds


def descend_seeds(g: G.HnswGraph, q: torch.Tensor, entry: int,
                  entry_level: int, down_to: int, *,
                  metric: Metric = Metric.L2, descent_ef: int = 1,
                  max_steps: int = 128) -> torch.Tensor:
    """Upper-level descent producing seeds for a search at ``down_to`` (the
    routing half of ``HnswFindElementNeighbors``)."""
    return _descend_body(g, q, entry, entry_level, down_to, metric,
                         max_steps=max_steps, descent_ef=descent_ef)


def descend(g: G.HnswGraph, q: torch.Tensor, entry: int, entry_level: int,
            *, down_to: int = 0, metric: Metric = Metric.L2) -> torch.Tensor:
    """Standalone greedy descent (build path and tests)."""
    return _descend_body(g, q, entry, entry_level, down_to, metric)


def search_resumable_start(g: G.HnswGraph, queries: torch.Tensor, entry: int,
                           entry_level: int, *, ef: int, expand: int = 1,
                           max_steps: int = 0, metric: Metric = Metric.L2,
                           descent_ef: int = 1):
    """First pass of a resumable scan: descent and the level-0 beam,
    returning the level-0 state too. Returns (pool_d, pool_i, state)."""
    if max_steps <= 0:
        max_steps = ef // max(expand, 1) + 16
    q = queries.to(g.vectors.dtype)
    seeds = _descend_body(g, q, entry, entry_level, 0, metric,
                          descent_ef=descent_ef)
    B.BEAM_LAUNCHES[B.path(g, q, expand=expand, ef=ef, metric=metric,
                           resumable=True)] += 1
    return _search_layer_body(
        g, q, seeds, 0, level0=True, ef=ef, expand=expand,
        max_steps=max_steps, metric=metric, skip_deleted=True,
        mask_deleted_results=True, with_counters=True, return_state=True)


def search_resume(g: G.HnswGraph, queries: torch.Tensor, state, *, ef: int,
                  expand: int = 1, max_steps: int = 0,
                  metric: Metric = Metric.L2):
    """Continue a level-0 scan from ``state`` with a (possibly wider) ef;
    expanded nodes are not expanded again beyond the history window's
    re-scores."""
    if max_steps <= 0:
        max_steps = ef // max(expand, 1) + 16
    q = queries.to(g.vectors.dtype)
    B.BEAM_LAUNCHES[B.path(g, q, expand=expand, ef=ef, metric=metric,
                           resumable=True)] += 1
    return _search_layer_body(
        g, q, None, 0, level0=True, ef=ef, expand=expand,
        max_steps=max_steps, metric=metric, skip_deleted=True,
        mask_deleted_results=True, with_counters=True, return_state=True,
        init_state=state, reset_frontier=True)


def route_table(ids: torch.Tensor, sentinel: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense route's table from sentinel-padded upper ids ``[U]`` int32:
    (the ids with their sentinels moved behind the live ones, which keep
    their order; the ``[1]`` int32 count of live ids), both made on the
    device, with no host read."""
    pad = ids == sentinel
    order = torch.argsort(pad.to(torch.uint8), stable=True)
    return ids[order], (~pad).sum(dtype=torch.int32).reshape(1)


def _scan_seeds_body(g: G.HnswGraph, q: torch.Tensor, upper_ids: torch.Tensor,
                     live: torch.Tensor, descent_ef: int,
                     metric: Metric) -> torch.Tensor:
    """Dense routing over the level >= 1 subset in place of greedy descent:
    each query's ``descent_ef`` nearest upper elements exactly, scored as
    one ``[Q, U]`` product would score them (search.py:405-442).
    ``upper_ids`` ``[U]`` int32 and ``live`` ``[1]`` int32 are a
    :func:`route_table`: live ids first, only sentinels past them. The
    route is ``ops/route.py::route_topk`` over the gathered vectors as one
    group of ``live`` centroids: on the card the route kernel up to its
    ``MAX_P`` (no score matrix), the GEMM + top-k chain wider (the build's
    ``ef_construction``). Returns seeds ``[Q, descent_ef]`` (at most U)."""
    if metric is Metric.L1:
        raise NotImplementedError("L1 routing has no matmul form")
    v, v_sq = G.gather_vectors(g, upper_ids)
    q = q.contiguous()
    ti = R.route_topk(v, v_sq, q, D.squared_norms(q),
                      min(descent_ef, upper_ids.shape[0]), metric,
                      live=live)[:, 0]
    # -1 (no live column left) reads the table's last id, a sentinel: a row
    # has fewer live columns than it asks for only when live < U
    return upper_ids[ti]


def scan_seeds(g: G.HnswGraph, q: torch.Tensor, upper_ids: torch.Tensor, *,
               descent_ef: int = 8, metric: Metric = Metric.L2):
    """:func:`_scan_seeds_body` over sentinel-padded ``upper_ids``, their
    sentinels anywhere (tests/tools)."""
    return _scan_seeds_body(g, q.to(g.vectors.dtype),
                            *route_table(upper_ids, g.sentinel), descent_ef,
                            metric)


def _count_beam(g: G.HnswGraph, seeds: torch.Tensor, hist: torch.Tensor,
                steps, E: int, allowed) -> int:
    """Adds one level-0 beam's least work to :data:`BEAM_ROWS` and
    :data:`BEAM_VECTORS` (one host read): the adjacency rows of the nodes
    it expanded, and the distinct vectors of the seeds and of those rows'
    neighbours that it may score. Read off the history ring, which holds
    every expanded id (the sentinel where a query did not step) as long as
    it has not wrapped; a beam whose ring wrapped is not counted. ``steps``
    is the loop's step count, or the kernel's steps ``[Q]`` a query, whose
    longest is read in the same host read. Returns the beam's steps."""
    global BEAM_ROWS, BEAM_VECTORS, BEAM_COUNTED
    slots = hist.shape[1] // E
    if isinstance(steps, int) and steps > slots:
        return steps
    sent = g.sentinel
    nbrs = g.neighbors0[hist].reshape(hist.shape[0], -1)
    skip = g.deleted[nbrs]
    if allowed is not None:
        skip |= ~allowed[nbrs]
    ids = torch.cat([seeds, torch.where(skip, sent, nbrs)], 1).sort(1)[0]
    new = torch.ones_like(ids, dtype=torch.bool)
    new[:, 1:] = ids[:, 1:] != ids[:, :-1]
    reads = [(hist != sent).sum(), (new & (ids != sent)).sum()]
    if not isinstance(steps, int):
        reads.append(steps.max().to(torch.int64))
    rows, vectors, *longest = torch.stack(reads).tolist()
    steps = longest[0] if longest else steps
    if steps <= slots:
        BEAM_ROWS += rows
        BEAM_VECTORS += vectors
        BEAM_COUNTED += 1
    return steps


def search(g: G.HnswGraph, queries: torch.Tensor, *, entry: int,
           entry_level: int, k: int, ef_search: int, metric: Metric,
           expand: int = 1, max_steps: int = 0, descent_ef: int = 1,
           with_counters: bool = False, upper_ids=None, upper_live=None,
           allowed=None):
    """Full query search (pgvector's ``GetScanItems``): upper-level routing
    (greedy descent, or the dense scan of the level >= 1 subset when
    ``upper_ids`` is given: :func:`_scan_seeds_body`) then the
    ef_search-bounded level-0 beam. ``upper_live``: the live count of an
    ``upper_ids`` that is already a :func:`route_table` (``HnswIndex``
    caches one an epoch); None: the table is made here.
    Returns (scores ``[Q, k]`` ascending, ids ``[Q, k]``), plus per-query
    (hops, dist_evals) with ``with_counters``. The level-0 beam takes the
    path :func:`~tpu_hnsw_torch.ops.beam.path` picks."""
    global BEAM_STEPS
    ef = max(ef_search, k)
    if max_steps <= 0:
        # natural termination lands near ef/expand steps; the margin covers
        # slow tail queries without running the batch long after the rest
        max_steps = ef // max(expand, 1) + 16
    q = queries.to(g.vectors.dtype)
    nq = q.shape[0]
    if upper_ids is not None and metric is not Metric.L1:
        with annotate("route_scan", nq):
            if upper_live is None:
                upper_ids, upper_live = route_table(upper_ids, g.sentinel)
            seeds = _scan_seeds_body(g, q, upper_ids, upper_live,
                                     max(descent_ef, 1), metric)
    else:
        with annotate("descend", nq):
            seeds = _descend_body(g, q, entry, entry_level, 0, metric,
                                  descent_ef=descent_ef)
    counting, steps0 = tracing(), BEAM_STEPS
    path = B.path(g, q, expand=expand, ef=ef, metric=metric)
    with annotate("beam_level0", nq):
        if path == "kernel":
            pool_d, pool_i, hist, hops, evals = B.beam_level0(
                g, q, seeds, ef=ef, max_steps=max_steps, metric=metric,
                ring=ring_width(max_steps, 1), allowed=allowed)
        else:
            B.BEAM_LAUNCHES[path] += 1
            out = _search_layer_body(g, q, seeds, 0, level0=True, ef=ef,
                                     expand=expand, max_steps=max_steps,
                                     metric=metric, skip_deleted=True,
                                     mask_deleted_results=True,
                                     with_counters=with_counters,
                                     return_state=counting, allowed=allowed)
            if counting:
                pool_d, pool_i, (_, _, _, hist, hops, evals) = out
            elif with_counters:
                pool_d, pool_i, hops, evals = out
            else:
                pool_d, pool_i = out
    # after the beam's range, which keeps its device time
    if counting and path == "kernel":
        BEAM_STEPS += _count_beam(g, seeds, hist, hops, 1, allowed)
    elif counting:
        _count_beam(g, seeds, hist, BEAM_STEPS - steps0, min(expand, ef),
                    allowed)
    if with_counters:
        return pool_d[:, :k], pool_i[:, :k], hops, evals
    return pool_d[:, :k], pool_i[:, :k]
