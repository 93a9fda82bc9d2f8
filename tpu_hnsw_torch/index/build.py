"""Wave-batched HNSW construction (port of ``tpu_hnsw/index/build.py``).

pgvector's per-tuple insert loop (``HnswInsertTupleOnDisk``) becomes waves
of B vectors inserted together:

1. one batched descent and ef_construction search per level for the whole
   wave (:mod:`.search`),
2. one batched ``SelectNeighbors`` per level (:mod:`.select`),
3. reciprocal edges with deterministic conflict resolution: the (target,
   new element) updates of a wave are sorted by (target, distance) and
   applied in fixed-size chunks, each chunk reading the adjacency the
   previous chunk wrote (pgvector's per-element lock discipline of
   ``HnswUpdateConnection``, with the same append-or-reselect semantics).

Elements of one wave do not see each other during their searches, as
concurrent workers of pgvector's parallel build may not; ``wave_size=1``
reproduces the sequential build exactly, and intra-wave brute-force link
candidates restore sequential-grade connectivity at large waves. Where the
reference donates the graph to a jitted step, the port updates its tensors
in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import select as S
from tpu_hnsw_torch.index.search import _scan_seeds_body, search_layer
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T

# Reciprocal insertions per target per chunk: a target receiving more new
# edges than this within one chunk keeps the closest UPDATE_R (across
# chunks the loop serialises, so only same-chunk overflow is lossy).
UPDATE_R = 16
UPDATE_CHUNK = 8192


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _set_wave(g: G.HnswGraph, ids, vecs, levels, slots) -> G.HnswGraph:
    """Scatter a wave's vectors, norms, levels and slots into the tables, in
    place (the reference donates ``g``). Padding rows carry the sentinel id,
    a zero vector, level 0 and the trash slot: the trash row's own values,
    so it stays as it was."""
    vecs = vecs.to(g.vectors.dtype)
    g.vectors[ids] = vecs
    g.vectors_sq[ids] = D.squared_norms(vecs)
    g.levels[ids] = levels
    g.upper_slot[ids] = slots
    return g


def _mask_pool(pool_d, pool_i, n_valid: int, sentinel: int):
    """Invalidate pool rows >= n_valid (the padding rows of a wave)."""
    keep = (torch.arange(pool_i.shape[0], device=pool_i.device)
            < n_valid)[:, None]
    return (torch.where(keep, pool_d, torch.inf),
            torch.where(keep, pool_i, sentinel))


def _write_own_lists(g: G.HnswGraph, ids, slots, sel_ids, level: int, *,
                     level0: bool) -> G.HnswGraph:
    """Write the wave elements' own adjacency rows at a level, in place.
    Padding rows (sentinel id, trash slot) write all-sentinel rows, the
    trash rows' own contents."""
    if level0:
        g.neighbors0[ids] = F.pad(sel_ids, (0, g.neighbors0.shape[1]
                                            - sel_ids.shape[1]),
                                  value=g.sentinel)
        return g
    lvl = min(max(level - 1, 0), g.upper_nbrs.shape[1] - 1)
    g.upper_nbrs[slots, lvl] = F.pad(
        sel_ids, (0, g.upper_nbrs.shape[2] - sel_ids.shape[1]),
        value=g.sentinel)
    return g


def _reciprocal_update(g: G.HnswGraph, targets, sources, dists, level: int,
                       *, level0: bool, lm: int, metric: Metric
                       ) -> G.HnswGraph:
    """Apply the reciprocal-edge updates ``(targets, sources, dists)``
    (sorted by (target, distance)) chunk after chunk, in place: for each
    (target, new) pair, ``HnswUpdateConnection`` (append when the target
    has room, else re-select over existing and new). The reference runs the
    chunks under ``lax.scan``.

    ``[P, U]`` updates are P disjoint graphs' lists (each sorted on its
    own, no target shared): chunk c applies every row's columns
    ``[c*ch, (c+1)*ch)`` together, so each graph sees the chunks it would
    see alone."""
    sent = g.sentinel
    dev = targets.device
    if targets.ndim == 1:
        targets, sources, dists = targets[None], sources[None], dists[None]
    P, U = targets.shape
    ch = min(UPDATE_CHUNK, U)
    nchunks = (U + ch - 1) // ch
    pad = nchunks * ch - U
    if pad:
        targets = F.pad(targets, (0, pad), value=sent)
        sources = F.pad(sources, (0, pad), value=sent)
        dists = F.pad(dists, (0, pad), value=torch.inf)
    lvl = min(max(level - 1, 0), g.upper_nbrs.shape[1] - 1)
    idx = torch.arange(P * ch, device=dev)
    for c in range(nchunks):
        t = targets[:, c * ch:(c + 1) * ch].reshape(-1)
        u = sources[:, c * ch:(c + 1) * ch].reshape(-1)
        d = dists[:, c * ch:(c + 1) * ch].reshape(-1)
        # group rows by target within the chunk
        first = torch.ones(P * ch, dtype=torch.bool, device=dev)
        first[1:] = t[1:] != t[:-1]
        run_start = torch.cummax(torch.where(first, idx, 0), 0).values
        rank = idx - run_start
        seg = torch.cumsum(first, 0) - 1  # chunk-local unique-target slot
        valid = t != sent
        tu = torch.full((P * ch,), sent, dtype=torch.int32, device=dev)
        tu[seg] = torch.where(valid, t, sent)
        # ranks past UPDATE_R land in the trash column UPDATE_R
        keep = valid & (rank < UPDATE_R)
        col = torch.where(rank < UPDATE_R, rank, UPDATE_R)
        new_ids = torch.full((P * ch, UPDATE_R + 1), sent,
                             dtype=torch.int32, device=dev)
        new_dists = torch.full((P * ch, UPDATE_R + 1), torch.inf,
                               device=dev)
        new_ids[seg, col] = torch.where(keep, u, sent)
        new_dists[seg, col] = torch.where(keep, d, torch.inf)
        new_ids, new_dists = new_ids[:, :UPDATE_R], new_dists[:, :UPDATE_R]

        # current adjacency of each unique target
        if level0:
            old = g.neighbors0[tu]
        else:
            slots = g.upper_slot[tu]
            old = g.upper_nbrs[:, lvl][slots]
        old = torch.where((tu == sent)[:, None], sent, old)
        # distances target -> existing neighbours, computed again (the flat
        # layout stores no per-edge distances)
        tvec, _ = G.gather_vectors(g, tu)
        ovec, _ = G.gather_vectors(g, old)
        od = torch.where(old == sent, torch.inf,
                         D.batched_scores(tvec, ovec, metric))
        # a new id may already sit in the target's list
        dup = (new_ids[:, :, None] == old[:, None, :]).any(2)
        new_ids = torch.where(dup, sent, new_ids)
        new_dists = torch.where(dup, torch.inf, new_dists)
        sel_ids, _ = S.select_neighbors(
            g, torch.cat([old, new_ids], 1), torch.cat([od, new_dists], 1),
            lm=lm, metric=metric)
        # unused segments hold the sentinel: they rewrite the trash row with
        # the all-sentinel row it holds
        if level0:
            g.neighbors0[tu] = F.pad(sel_ids,
                                     (0, g.neighbors0.shape[1] - lm),
                                     value=sent)
        else:
            g.upper_nbrs[slots, lvl] = F.pad(
                sel_ids, (0, g.upper_nbrs.shape[2] - lm), value=sent)
    return g


def _wave_link_candidates(vecs, ids, n_valid: int, sentinel: int, *, w: int,
                          metric: Metric):
    """Within-wave brute-force top-w candidates per wave element (wavemates
    only; padding rows and the diagonal masked). Returns (dists ``[B, w]``,
    ids ``[B, w]``), merged into the candidate pools before selection."""
    B = vecs.shape[0]
    scores = D.pairwise_scores(vecs, vecs, metric)
    r = torch.arange(B, device=vecs.device)
    bad = ((r[:, None] == r[None, :]) | (r[:, None] >= n_valid)
           | (r[None, :] >= n_valid))
    vals, pos = T.topk_smallest_by_index(
        torch.where(bad, torch.inf, scores), w)
    return vals, torch.where(torch.isfinite(vals), ids[pos], sentinel)


def _sorted_updates(sel_ids, sel_dists, src_ids):
    """Flatten selections into (target, source, dist) updates sorted by
    target, then distance, then position (``jnp.lexsort((d, t))``)."""
    B, lm = sel_ids.shape
    t = sel_ids.reshape(-1)
    u = src_ids[:, None].expand(B, lm).reshape(-1)
    d = sel_dists.reshape(-1)
    order = T.lexsort_order(t, d)
    return t[order], u[order], d[order]


def _splice_seeds(prev_pool, seeds_all, n_prev: int, sentinel: int):
    """Rows < n_prev keep their carried pool row; later rows get their
    descent seed, sentinel padded to the pool's width."""
    padded = F.pad(seeds_all, (0, prev_pool.shape[1] - seeds_all.shape[1]),
                   value=sentinel)
    rows = torch.arange(prev_pool.shape[0], device=prev_pool.device)
    return torch.where((rows < n_prev)[:, None], prev_pool, padded)


def _live_scan_seeds(g: G.HnswGraph, q, upper_ids, width: int,
                     metric: Metric):
    """Each row's ``width`` nearest live level >= 1 elements (dense-scan
    routing with tombstones masked, so a build never links to one), 4,096
    rows at a time (a repair batch of 32k rows would otherwise score an
    8 GB ``[rows, U]`` matrix at 1M)."""
    live = torch.where(g.deleted[upper_ids], g.sentinel, upper_ids)
    return torch.cat([_scan_seeds_body(g, q[s:s + 4096], live, width, metric)
                      for s in range(0, q.shape[0], 4096)])


def _prefix_bucket(B: int, m: int, level: int, bp: int) -> int:
    """Rows searched at ``level`` for a wave of B: an expectation-based
    bucket (3x the expected count of elements at that level), widened to
    next_pow2(bp) if the draw exceeds it. The padded rows are masked."""
    exp = max(1, int(B * (float(m) ** -level) * 3) + 8)
    bucket = min(B, next_pow2(exp))
    if bp > bucket:
        bucket = min(B, next_pow2(bp))
    return bucket


def insert_wave(g: G.HnswGraph, cfg: HnswConfig, vecs: torch.Tensor,
                ids_np: np.ndarray, levels_np: np.ndarray,
                slots_np: np.ndarray, n_valid: int, entry: int,
                entry_level: int, upper_ids=None) -> G.HnswGraph:
    """Insert one wave, in place. The caller guarantees: ``vecs [B, d]`` (on
    the graph's device; padding rows zero) sorted by level descending,
    normalised; padding ids are the sentinel; entry >= 0; upper-table slots
    allocated on the host.

    With ``upper_ids`` (the level >= 1 subset, as dense-scan routing takes
    it), rows that join at level 0 seed their level-0 search with their
    ef_construction nearest upper elements instead of the greedy ef=1
    descent. The reference always descends greedily; on a bulk-built graph,
    whose level 0 is a kNN graph per cluster, that strands rows in a wrong
    basin, where no neighbour keeps an edge to them (27% of 10,000 rows
    added to the 1M x 128 cell could not be found again)."""
    metric = cfg.metric
    efc = cfg.ef_construction
    E = cfg.build_expand_per_step
    sent = g.sentinel
    B = vecs.shape[0]
    dev = g.device

    ids = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
    levels = torch.from_numpy(levels_np.astype(np.int32)).to(dev)
    slots = torch.from_numpy(slots_np.astype(np.int32)).to(dev)
    g = _set_wave(g, ids, vecs, levels, slots)

    q_all = vecs.to(g.vectors.dtype)
    seeds_all = torch.full((B, 1), entry, dtype=torch.int32, device=dev)
    prev_pool = None  # [*, efc] pool of the previous (higher) level
    bp_prev = 0       # true (unpadded) previous prefix count

    for lc in range(entry_level, 0, -1):
        bp = int((levels_np >= lc).sum())  # prefix rows searching this level
        if bp > 0:
            bp_pad = _prefix_bucket(B, cfg.m, lc, bp)
            if prev_pool is None:
                seeds = F.pad(seeds_all[:bp_pad], (0, efc - 1), value=sent)
            else:
                pp = prev_pool[:bp_pad]
                if pp.shape[0] < bp_pad:
                    pp = F.pad(pp, (0, 0, 0, bp_pad - pp.shape[0]),
                               value=sent)
                seeds = _splice_seeds(pp, seeds_all[:bp_pad], bp_prev, sent)
            pool_d, pool_i = search_layer(g, q_all[:bp_pad], seeds, lc,
                                          level0=False, ef=efc, expand=E,
                                          metric=metric)
            pool_d, pool_i = _mask_pool(pool_d, pool_i, min(bp, n_valid),
                                        sent)
            sel_pool_d, sel_pool_i = pool_d, pool_i
            if cfg.link_within_wave and bp > 1:
                wv, wi = _wave_link_candidates(
                    q_all[:bp_pad], ids[:bp_pad], min(bp, n_valid), sent,
                    w=min(cfg.m, bp_pad), metric=metric)
                sel_pool_d = torch.cat([pool_d, wv], 1)
                sel_pool_i = torch.cat([pool_i, wi], 1)
            sel_ids, sel_dists = S.select_neighbors(
                g, sel_pool_i, sel_pool_d, lm=cfg.m, metric=metric)
            g = _write_own_lists(g, ids[:bp_pad], slots[:bp_pad], sel_ids,
                                 lc, level0=False)
            t, u, d = _sorted_updates(sel_ids, sel_dists, ids[:bp_pad])
            g = _reciprocal_update(g, t, u, d, lc, level0=False, lm=cfg.m,
                                   metric=metric)
            prev_pool, bp_prev = pool_i, min(bp, n_valid)
        # greedy descent for every row (prefix rows' results are unused)
        _, seeds_all = search_layer(g, q_all, seeds_all, lc, level0=False,
                                    ef=1, expand=1, max_steps=128,
                                    metric=metric)

    # level 0: the whole wave
    if upper_ids is not None:
        seeds_all = _live_scan_seeds(g, q_all, upper_ids, efc, metric)
    if prev_pool is None:
        seeds0 = F.pad(seeds_all, (0, efc - seeds_all.shape[1]), value=sent)
    else:
        pp = prev_pool
        if pp.shape[0] < B:
            pp = F.pad(pp, (0, 0, 0, B - pp.shape[0]), value=sent)
        seeds0 = _splice_seeds(pp, seeds_all, bp_prev, sent)
    pool_d, pool_i = search_layer(g, q_all, seeds0, 0, level0=True, ef=efc,
                                  expand=E, metric=metric)
    pool_d, pool_i = _mask_pool(pool_d, pool_i, n_valid, sent)
    if cfg.link_within_wave and n_valid > 1:
        wv, wi = _wave_link_candidates(q_all, ids, n_valid, sent,
                                       w=min(cfg.m, B), metric=metric)
        pool_d = torch.cat([pool_d, wv], 1)
        pool_i = torch.cat([pool_i, wi], 1)
    sel_ids, sel_dists = S.select_neighbors(g, pool_i, pool_d, lm=cfg.m0,
                                            metric=metric)
    g = _write_own_lists(g, ids, slots, sel_ids, 0, level0=True)
    t, u, d = _sorted_updates(sel_ids, sel_dists, ids)
    return _reciprocal_update(g, t, u, d, 0, level0=True, lm=cfg.m0,
                              metric=metric)
