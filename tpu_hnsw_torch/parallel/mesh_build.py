"""The lockstep build of every graph partition (port of
``tpu_hnsw/parallel/mesh_build.py``).

The reference builds P independent shard graphs at once, one per device
under ``shard_map``, with one compiled wave step for every shard and every
wave. Here the partition axis is a batch axis on one device, as the
stacked searchers serve it: one wave step advances every partition, with
one ``search_layer`` per level over all partitions' wave rows, one
``select_neighbors``, one own-list write and one reciprocal update.

Layout: a disjoint union. The P graphs live in one
:class:`~tpu_hnsw_torch.index.graph.HnswGraph` of ``P*cap + 1`` rows and
``P*cap_u + 1`` upper slots: partition p's element i is row ``p*cap + i``,
its upper slot j is ``p*cap_u + j``, and the one trash row (the union's
sentinel ``P*cap``) and trash slot are shared. No edge ever crosses a
partition, so the beam search, selection and writes of the sequential path
run on the union unchanged, and the offset keeps each partition's
(distance, id) order, so ties resolve as in a partition built alone. A
leading ``[P, ...]`` axis would need a batched copy of every graph gather
in ``search_layer``; the union needs none. What is per partition is
batched over a ``[P, rows]`` view of the wave: the within-wave link
candidates, the live-row masks, and the reciprocal updates, which sort
and chunk each partition's list on its own (``build._reciprocal_update``
over ``[P, U]``), so every partition sees the chunk boundaries it would
see alone.

The host keeps the reference's decisions: levels from
``np.random.default_rng(cfg.seed)`` per partition (the port's
``HnswIndex._draw_levels``); every partition follows the wave schedule of
the largest one, ``wave = min(wave_size, max(1, pos), n_max - pos)``, and a
finished partition's rows are masked (``n_valid = 0``); upper slots are
allocated per partition; a partition searches a level only up to its own
entry level, and its rows above it write nothing but sentinel rows; the
per-level pad is the maximum over partitions; the entry is promoted after
every wave; every part has ``capacity = n_max``. Where a partition has
``HnswIndex.ROUTE_SCAN_MIN_UPPER`` upper elements it seeds level 0 from
its nearest live upper elements, as the port's sequential
``HnswIndex._insert_wave`` does (the reference's traced wave step has no
such branch), so each partition equals the sequential wave build of its
rows.

With a ``torch.distributed`` group (or 1-D ``DeviceMesh``) of R ranks, rank
r builds partitions ``[r*P/R, (r+1)*P/R)`` in lockstep and every graph is
then broadcast from its owner, so each rank holds all P parts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index import build as B
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import select as S
from tpu_hnsw_torch.index.hnsw import HnswIndex
from tpu_hnsw_torch.index.search import search_layer
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import collectives as C


class _ShardPlan:
    """Host bookkeeping of one partition: its rows, level draws, position
    in the schedule, upper-slot count and entry point (local ids)."""

    def __init__(self, cfg: HnswConfig, x: np.ndarray):
        self.x = x
        self.n = x.shape[0]
        self.rng = np.random.default_rng(cfg.seed)
        u = np.maximum(self.rng.random(self.n), 1e-12)
        self.levels = np.minimum((-np.log(u) * cfg.ml).astype(np.int64),
                                 cfg.max_level).astype(np.int32)
        self.pos = 0
        self.n_upper = 0
        self.entry = -1
        self.entry_level = -1


def _init_union(cfg: HnswConfig, parts: int, cap: int, device) -> G.HnswGraph:
    """Empty union of ``parts`` graphs of ``cap`` rows each."""
    return G.init_graph(cfg, parts * cap, device,
                        cap_upper=parts * G.upper_capacity(cap, cfg.m))


def _row_mask(counts: torch.Tensor, rows: int) -> torch.Tensor:
    """``[P*rows]`` bool: row r of partition p is below ``counts[p]``."""
    r = torch.arange(rows, device=counts.device)
    return (r[None, :] < counts[:, None]).reshape(-1)


def _splice(prev_pool, prev_rows: int, rows: int, seeds, n_prev, sent: int):
    """Per partition: rows below ``n_prev[p]`` keep their carried pool row
    (``prev_pool [P*prev_rows, efc]``), later rows get their seed ``seeds
    [P*rows, s]``, sentinel padded to the pool's width."""
    P = n_prev.shape[0]
    efc = prev_pool.shape[1]
    pp = prev_pool.reshape(P, prev_rows, efc)
    if prev_rows >= rows:
        pp = pp[:, :rows]
    else:
        pp = F.pad(pp, (0, 0, 0, rows - prev_rows), value=sent)
    padded = F.pad(seeds, (0, efc - seeds.shape[1]), value=sent)
    keep = _row_mask(n_prev, rows)[:, None]
    return torch.where(keep, pp.reshape(P * rows, efc), padded)


def _link_candidates(q, ids, n_valid, sent: int, *, w: int, metric: Metric):
    """Within-wave brute-force top-w per row, each partition against its
    own wavemates: ``q [P, R, d]``, ``ids [P, R]``, ``n_valid [P]``.
    Returns (dists, ids) ``[P*R, w]``, as ``build._wave_link_candidates``
    gives for each partition."""
    P, R, _ = q.shape
    qf = q.float()
    if metric is Metric.L1:
        sc = torch.cdist(qf, qf, p=1)
    else:
        dots = torch.bmm(qf, qf.transpose(1, 2))
        if metric is Metric.L2:
            sq = (qf * qf).sum(-1)
            sc = torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2.0 * dots,
                                 0.0)
        else:
            sc = -dots
    r = torch.arange(R, device=q.device)
    nv = n_valid[:, None, None]
    bad = ((r[None, :, None] == r[None, None, :]) | (r[None, :, None] >= nv)
           | (r[None, None, :] >= nv))
    vals, pos = T.topk_smallest_by_index(torch.where(bad, torch.inf, sc), w)
    cand = torch.gather(ids, 1, pos.reshape(P, R * w)).reshape(P, R, w)
    vals = vals.reshape(P * R, w)
    return vals, torch.where(torch.isfinite(vals), cand.reshape(P * R, w),
                             sent)


def _sorted_updates(sel_ids, sel_dists, src_ids, P: int):
    """Each partition's (target, source, dist) updates sorted by target,
    then distance, then position: ``[P, R*lm]`` each."""
    R, lm = sel_ids.shape[0] // P, sel_ids.shape[1]
    t = sel_ids.reshape(P, R * lm)
    u = src_ids.reshape(P, R, 1).expand(P, R, lm).reshape(P, R * lm)
    d = sel_dists.reshape(P, R * lm)
    order = T.lexsort_order(t, d)
    return (torch.gather(t, 1, order), torch.gather(u, 1, order),
            torch.gather(d, 1, order))


def _connect(g, cfg, q, ids, slots, pool_d, pool_i, live_n, level: int,
             rows: int, P: int):
    """Select, write own lists and reciprocal edges for ``P*rows`` wave rows
    at one level; rows at or past ``live_n[p]`` write only sentinel rows
    to the trash row."""
    metric, sent = cfg.metric, g.sentinel
    level0 = level == 0
    lm = cfg.m0 if level0 else cfg.m
    live = _row_mask(live_n, rows)
    pool_d = torch.where(live[:, None], pool_d, torch.inf)
    pool_i = torch.where(live[:, None], pool_i, sent)
    sel_d, sel_i = pool_d, pool_i
    if cfg.link_within_wave and rows > 1:
        wv, wi = _link_candidates(q.reshape(P, rows, -1), ids.reshape(P, rows),
                                  live_n, sent, w=min(cfg.m, rows),
                                  metric=metric)
        sel_d, sel_i = torch.cat([pool_d, wv], 1), torch.cat([pool_i, wi], 1)
    sel_ids, sel_dists = S.select_neighbors(g, sel_i, sel_d, lm=lm,
                                            metric=metric)
    w_ids = torch.where(live, ids, sent)
    w_slots = torch.where(live, slots, g.cap_upper)
    B._write_own_lists(g, w_ids, w_slots, sel_ids, level, level0=level0)
    t, u, d = _sorted_updates(sel_ids, sel_dists, w_ids, P)
    B._reciprocal_update(g, t, u, d, level, level0=level0, lm=lm,
                         metric=metric)
    return pool_i


def _upper_ids(g, p: int, cap: int, n_upper: int) -> torch.Tensor:
    """Partition p's level >= 1 elements as union ids, ascending, padded
    with the union sentinel as ``HnswIndex._route_table`` pads them."""
    upad = max(-(-n_upper // 256) * 256, 256)
    lv = g.levels[p * cap:(p + 1) * cap]
    ids = torch.nonzero(lv >= 1).reshape(-1)[:upad].to(torch.int32) + p * cap
    return F.pad(ids, (0, upad - ids.shape[0]), value=g.sentinel)


def _insert_wave_union(g, cfg, plans, cap: int, wave: int):
    """One wave of every partition (``insert_wave`` over the union), and
    the host bookkeeping after it. Rows pad to the wave's own power of
    two, as the port's sequential wave does."""
    P = len(plans)
    bpad = B.next_pow2(wave)
    dev = g.device
    sent, cap_u = g.sentinel, g.cap_upper // P
    efc, E, metric = cfg.ef_construction, cfg.build_expand_per_step, cfg.metric
    vecs = np.zeros((P, bpad, cfg.dim), np.float32)
    ids = np.full((P, bpad), sent, np.int64)
    lv = np.zeros((P, bpad), np.int32)
    slots = np.full((P, bpad), g.cap_upper, np.int64)
    nv = np.zeros(P, np.int64)
    scan = []  # (partition, its upper ids) for dense-scan seeding
    for p, pl in enumerate(plans):
        take = min(wave, pl.n - pl.pos)
        if take <= 0:
            continue
        sl = slice(pl.pos, pl.pos + take)
        order = np.argsort(-pl.levels[sl], kind="stable")
        lvs = pl.levels[sl][order]
        vecs[p, :take] = pl.x[sl][order]
        ids[p, :take] = p * cap + pl.pos + order
        lv[p, :take] = lvs
        n_up = int((lvs >= 1).sum())
        if pl.n_upper + n_up > cap_u:
            raise RuntimeError("upper-level table overflow")
        slots[p, :n_up] = p * cap_u + pl.n_upper + np.arange(n_up)
        pl.n_upper += n_up
        nv[p] = take
        # HnswIndex._resolve_route("auto") as the sequential wave asks it,
        # after the wave's slots are counted and before its rows are set
        if (metric is not Metric.L1 and pl.n_upper
                and pl.n_upper >= HnswIndex.ROUTE_SCAN_MIN_UPPER):
            scan.append((p, _upper_ids(g, p, cap, pl.n_upper)))
    ent = np.array([p * cap + pl.entry if pl.entry >= 0 else sent
                    for p, pl in enumerate(plans)], np.int64)
    ent_lv = np.array([pl.entry_level if nv[p] else -1
                       for p, pl in enumerate(plans)])

    def t(a, dt=torch.int32):
        return torch.from_numpy(a).to(dev, dt)

    ids_t, slots_t = t(ids.reshape(-1)), t(slots.reshape(-1))
    vecs_t = t(vecs.reshape(-1, cfg.dim), torch.float32)
    B._set_wave(g, ids_t, vecs_t, t(lv.reshape(-1)), slots_t)
    q_all = vecs_t.to(g.vectors.dtype)
    seeds_all = t(np.repeat(ent, bpad))[:, None]
    prev_pool, prev_rows, n_prev = None, 0, None
    for lc in range(int(ent_lv.max()), 0, -1):
        bp = np.where(ent_lv >= lc, (lv >= lc).sum(1), 0)
        if bp.any():
            rows = max(B._prefix_bucket(bpad, cfg.m, lc, int(b))
                       for b in bp if b > 0)
            sel = (torch.arange(P, device=dev)[:, None] * bpad
                   + torch.arange(rows, device=dev)[None, :]).reshape(-1)
            if prev_pool is None:
                seeds = F.pad(seeds_all[sel], (0, efc - 1), value=sent)
            else:
                seeds = _splice(prev_pool, prev_rows, rows, seeds_all[sel],
                                n_prev, sent)
            pool_d, pool_i = search_layer(g, q_all[sel], seeds, lc,
                                          level0=False, ef=efc, expand=E,
                                          metric=metric)
            live_n = t(np.minimum(bp, nv), torch.int64)
            pool_i = _connect(g, cfg, q_all[sel], ids_t[sel], slots_t[sel],
                              pool_d, pool_i, live_n, lc, rows, P)
            prev_pool, prev_rows, n_prev = pool_i, rows, live_n
        # greedy descent of every row (a partition below this level stays
        # at its entry: its upper lists there hold only sentinels)
        _, seeds_all = search_layer(g, q_all, seeds_all, lc, level0=False,
                                    ef=1, expand=1, max_steps=128,
                                    metric=metric)

    seeds0 = F.pad(seeds_all, (0, efc - seeds_all.shape[1]), value=sent)
    for p, upper in scan:
        r = slice(p * bpad, (p + 1) * bpad)
        seeds0[r] = B._live_scan_seeds(g, q_all[r], upper, efc, metric)
    if prev_pool is not None:
        seeds0 = _splice(prev_pool, prev_rows, bpad, seeds0, n_prev, sent)
    pool_d, pool_i = search_layer(g, q_all, seeds0, 0, level0=True, ef=efc,
                                  expand=E, metric=metric)
    _connect(g, cfg, q_all, ids_t, slots_t, pool_d, pool_i,
             t(nv, torch.int64), 0, bpad, P)

    # host entry promotion (the metapage update)
    for p, pl in enumerate(plans):
        if nv[p]:
            if int(lv[p, 0]) > pl.entry_level:
                pl.entry = int(ids[p, 0]) - p * cap
                pl.entry_level = int(lv[p, 0])
            pl.pos += int(nv[p])


def _boot(g, cfg, plans, cap: int) -> None:
    """Each non-empty partition's first row becomes its entry point with no
    search (the metapage init)."""
    P = len(plans)
    cap_u = g.cap_upper // P
    live = [p for p, pl in enumerate(plans) if pl.n]
    if not live:
        return
    for p in live:
        pl = plans[p]
        pl.entry, pl.entry_level, pl.pos = 0, int(pl.levels[0]), 1
        pl.n_upper = 1 if pl.entry_level >= 1 else 0
    dev = g.device
    B._set_wave(
        g, torch.tensor([p * cap for p in live], device=dev),
        torch.from_numpy(np.stack([plans[p].x[0] for p in live])).to(dev),
        torch.tensor([plans[p].entry_level for p in live], dtype=torch.int32,
                     device=dev),
        torch.tensor([p * cap_u if plans[p].entry_level >= 1
                      else g.cap_upper for p in live], dtype=torch.int32,
                     device=dev))


def _build_lockstep(cfg: HnswConfig, plans, cap: int, device) -> G.HnswGraph:
    g = _init_union(cfg, len(plans), cap, device)
    _boot(g, cfg, plans, cap)
    n_max = max((pl.n for pl in plans), default=0)
    pos = 1
    while pos < n_max:
        wave = min(cfg.wave_size, max(1, pos), n_max - pos)
        _insert_wave_union(g, cfg, plans, cap, wave)
        pos += wave
    return g


def _split(g: G.HnswGraph, P: int, p: int, cap: int) -> G.HnswGraph:
    """Partition p's graph out of the union, with its own ids, sentinel
    (``cap``) and trash rows."""
    cap_u = g.cap_upper // P
    rows = slice(p * cap, (p + 1) * cap)
    urows = slice(p * cap_u, (p + 1) * cap_u)

    def local(a):
        return torch.where(a == g.sentinel, cap, a - p * cap)

    slot = g.upper_slot[rows]
    return G.HnswGraph(
        vectors=F.pad(g.vectors[rows], (0, 0, 0, 1)),
        vectors_sq=F.pad(g.vectors_sq[rows], (0, 1)),
        neighbors0=F.pad(local(g.neighbors0[rows]), (0, 0, 0, 1), value=cap),
        upper_nbrs=F.pad(local(g.upper_nbrs[urows]), (0, 0, 0, 0, 0, 1),
                         value=cap),
        upper_slot=F.pad(torch.where(slot == g.cap_upper, cap_u,
                                     slot - p * cap_u), (0, 1), value=cap_u),
        levels=F.pad(g.levels[rows], (0, 1)),
        deleted=F.pad(g.deleted[rows], (0, 1)),
    )


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group`` (bool and
    bf16 travel as integers, which every backend carries)."""
    if t.dtype == torch.bfloat16:
        x = t.view(torch.int16).contiguous()
    elif t.dtype == torch.bool:
        x = t.to(torch.uint8)
    else:
        x = t.contiguous()
    dist.broadcast(x, src=src, group=group)
    if t.dtype == torch.bfloat16:
        return x.view(torch.bfloat16)
    return x.to(torch.bool) if t.dtype == torch.bool else x


def is_group(mesh) -> bool:
    return mesh is not None and (hasattr(mesh, "get_group")
                                 or isinstance(mesh, dist.ProcessGroup))


def build_partitions_mesh(cfg: HnswConfig, shard_rows: list, mesh=None,
                          device=None) -> list[HnswIndex]:
    """Build P partition graphs in lockstep; ``shard_rows`` are P arrays of
    prepared rows (normalised for cosine). Returns P :class:`HnswIndex` on
    ``device`` (default: the card), each with ``capacity = n_max`` and the
    scalars and level generator its sequential build would leave.

    ``mesh``: a ``torch.distributed`` group or 1-D DeviceMesh of R ranks
    builds P / R partitions a rank and broadcasts every graph from its
    owner; anything else (``None``, ``"auto"``) builds every partition on
    ``device``."""
    from tpu_hnsw_torch.utils.device import entry_device

    dev = entry_device(device)
    P = len(shard_rows)
    group, R = C.resolve_group(mesh) if is_group(mesh) else (None, 1)
    if P % R:
        raise ValueError(f"n_partitions={P} must be a multiple of the mesh "
                         f"size {R}")
    local = P // R
    me = dist.get_rank(group) if group is not None else 0
    plans = [_ShardPlan(cfg, np.asarray(x, np.float32)) for x in shard_rows]
    cap = max((pl.n for pl in plans), default=0)
    mine = range(me * local, (me + 1) * local)
    g = _build_lockstep(cfg, [plans[p] for p in mine], cap, dev)
    parts = []
    for p, pl in enumerate(plans):
        owner = p // local
        if owner == me:
            graph = _split(g, local, p - me * local, cap)
            scalars = torch.tensor([pl.n_upper, pl.entry, pl.entry_level],
                                   dtype=torch.int64, device=dev)
        else:
            graph = G.init_graph(cfg, cap, dev)
            scalars = torch.zeros(3, dtype=torch.int64, device=dev)
        if group is not None:
            src = dist.get_global_rank(group, owner)
            graph = G.HnswGraph(**{
                f: _broadcast(getattr(graph, f), src, group)
                for f in ("vectors", "vectors_sq", "neighbors0",
                          "upper_nbrs", "upper_slot", "levels", "deleted")})
            scalars = _broadcast(scalars, src, group)
        sub = HnswIndex(cfg, capacity=cap, device=dev)
        sub.graph = graph
        sub.n = pl.n
        sub.n_upper, sub.entry, sub.entry_level = (
            int(v) for v in scalars.cpu())
        sub._rng = pl.rng  # later adds draw what the sequential build's do
        parts.append(sub)
    return parts
