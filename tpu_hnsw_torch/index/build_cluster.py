"""Bulk HNSW construction through clustering (port of
``tpu_hnsw/index/build_cluster.py``).

The wave build is bound by random row gathers. This path builds a graph
with the same structure another way:

1. k-means splits the data into overlapping clusters (each element joins
   its ``overlap`` nearest centroids), so candidate generation is dense
   per-cluster distance products (bf16 operands, f32 sums) and a top-k,
   with no graph traversal;
2. each element's candidates go through pgvector's ``SelectNeighbors``
   pruning (:mod:`.select`) after an exact f32 re-score;
3. reciprocal edges come back through one parallel symmetrisation pass
   (every directed edge sorted by (target, distance), scattered into
   per-target incoming slots, then one final selection);
4. upper levels take the exact top-k within each (geometrically
   shrinking) level subset, with the same selection.

The result is a standard :class:`~tpu_hnsw_torch.index.hnsw.HnswIndex`
graph; search, wave inserts, delete, compact and persistence work on it
unchanged. Per-stage times land in ``index.build_stats``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index import build as B
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import select as S
from tpu_hnsw_torch.index.block import _all_finite, _normalize_rows
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import kmeans as KM

#: elements of the reference's largest rescore gather (32,768 rows x 128
#: candidates x d=128): the chunk is cut so no width gathers more
_RESCORE_ELEMS = 32768 * 128 * 128


def _floor_pow2(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


def _rescore_rows(n_bucket: int, C: int, d: int) -> int:
    """Rows per rescore chunk: the reference's 32,768 (bounded by the
    bucket), cut to a power of two whose ``[rows, C, d]`` gather holds at
    most the reference's d=128 gather (rows are independent, so the chunk
    does not change results)."""
    return min(32768, n_bucket, _floor_pow2(_RESCORE_ELEMS // max(C * d, 1)))


def _pad_rows(a: torch.Tensor, m_pad: int, fill) -> torch.Tensor:
    if a.shape[0] == m_pad:
        return a
    return torch.cat([a, torch.full((m_pad - a.shape[0], *a.shape[1:]), fill,
                                    dtype=a.dtype, device=a.device)])


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------


def _cluster_batch(vectors, mem, sentinel: int, *, k_cand: int,
                   metric: Metric):
    """Top-``k_cand`` in-cluster candidate ids for a batch of clusters
    ``[b, CS]`` -> ``[b, CS, k_cand]``. The reference multiplies bf16
    operands into f32 sums; a torch bf16 product would round its output to
    bf16, so the operands are rounded to bf16 and multiplied in f32 (TF32
    off). Its ``approx_min_k`` is the exact top-k here."""
    b, CS = mem.shape
    vf = G.gather_rows(vectors, mem).to(torch.bfloat16).float()
    dots = torch.bmm(vf, vf.transpose(1, 2))
    if metric is Metric.L2:
        sq = (vf * vf).sum(-1)
        sc = torch.clamp_min(sq[:, :, None] + sq[:, None, :] - 2 * dots, 0.0)
    else:
        sc = -dots
    sc = torch.where((mem != sentinel)[:, None, :], sc, torch.inf)
    sc.diagonal(dim1=1, dim2=2).fill_(torch.inf)
    vals, idx = T.topk_smallest_fast(sc, k_cand)
    ids = torch.gather(mem[:, None, :].expand(b, CS, CS), 2, idx)
    return torch.where(torch.isfinite(vals), ids, sentinel)


def _route_chunk(xb, cj, *, overlap: int):
    """Nearest-``overlap`` centroid ids for one vector chunk."""
    return T.topk_smallest_by_index(D.pairwise_scores(xb, cj, Metric.L2),
                                    overlap)[1]


def _pack_members(top_c, n_real: int, sentinel: int, *, L: int, cs_cap: int,
                  overlap: int):
    """Per-cluster member lists on the device: ``top_c [n, overlap]`` (each
    row's nearest centroid ids) -> members ``[L, cs_cap]`` int32, sentinel
    padded. Rows past ``n_real`` and overflowing slots go to trash row L
    (and column 0 there)."""
    n = top_c.shape[0]
    dev = top_c.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    iota = torch.arange(n, device=dev)
    rows_live = iota < n_real
    members = torch.full((L + 1, cs_cap), sentinel, dtype=torch.int32,
                         device=dev)
    cur = torch.zeros(L + 1, dtype=torch.int64, device=dev)
    for o in range(overlap):
        a = torch.where(rows_live, top_c[:, o], L)
        order = torch.argsort(a, stable=True)
        a_s = a[order]
        first = torch.ones(n, dtype=torch.bool, device=dev)
        first[1:] = a_s[1:] != a_s[:-1]
        run_start = torch.cummax(torch.where(first, iota, 0), 0).values
        dst = cur[a_s] + (iota - run_start)
        ok = (dst < cs_cap) & (a_s < L)
        members[torch.where(ok, a_s, L), torch.where(ok, dst, 0)] = \
            torch.where(ok, ids[order], sentinel)
        cur = (members != sentinel).sum(1)
    return members[:L]


def _union_per_element(members, cand, sentinel: int, *, n_bucket: int,
                       overlap: int):
    """Each element's candidate rows from its clusters: members ``[L, CS]``,
    cand ``[L, CS, K]`` -> ``[n_bucket, overlap*K]`` (row n_bucket of the
    scatter is trash)."""
    K = cand.shape[2]
    flat_m = members.reshape(-1)
    flat_c = cand.reshape(-1, K)
    order = torch.argsort(flat_m, stable=True)  # sentinels sort last
    m_s = flat_m[order]
    c_s = flat_c[order]
    idx = torch.arange(m_s.shape[0], device=m_s.device)
    first = torch.ones_like(m_s, dtype=torch.bool)
    first[1:] = m_s[1:] != m_s[:-1]
    run_start = torch.cummax(torch.where(first, idx, 0), 0).values
    occ = idx - run_start
    ok = (m_s != sentinel) & (occ < overlap)
    out = torch.full((n_bucket + 1, overlap, K), sentinel, dtype=torch.int32,
                     device=m_s.device)
    out[torch.where(ok, m_s.long(), n_bucket), torch.where(ok, occ, 0)] = \
        torch.where(ok[:, None], c_s, sentinel)
    return out[:n_bucket].reshape(n_bucket, overlap * K)


def _link_orphans(g: G.HnswGraph, all_ci, n: int, *, k: int,
                  metric: Metric) -> None:
    """Rows of ``all_ci`` (``[>= n, w]``, ``w >= k``) that hold no
    candidate take their ``k`` nearest of all ``n`` rows from an exact
    scan, in place (one host read). A cluster holds at most ``cs_cap``
    members and drops the rest, as the reference does (``mode="drop"``);
    a row dropped from each of its clusters would get no level-0 link and
    be found by no search, and where it is an upper element it strands
    every query routed to it."""
    orphans = torch.nonzero((all_ci[:n] == g.sentinel).all(1)).reshape(-1)
    if not orphans.numel():
        return
    every = torch.arange(n, dtype=torch.int32, device=all_ci.device)
    for s in range(0, orphans.numel(), 8192):
        rows = orphans[s:s + 8192]
        all_ci[rows, :k] = _subset_topk(g, rows.to(torch.int32), every, k=k,
                                        metric=metric, xblock=16384)[1]


def _rescore_chunk(g: G.HnswGraph, b_ids, c_ids, *, metric: Metric):
    """Exact f32 base -> candidate scores for one chunk."""
    bv, _ = G.gather_vectors(g, b_ids)
    cv, _ = G.gather_vectors(g, c_ids)
    sc = D.batched_scores(bv, cv, metric)
    bad = (c_ids == g.sentinel) | (c_ids == b_ids[:, None])
    return torch.where(bad, torch.inf, sc)


def _select_chunk(g: G.HnswGraph, ci, cd, *, lm: int, metric: Metric,
                  trim: int):
    if trim and ci.shape[1] > trim:
        cd, sel = T.topk_smallest_by_index(cd, trim)
        ci = torch.gather(ci, 1, sel)
    return S.select_neighbors(g, ci, cd, lm=lm, metric=metric)


def _incoming(prelim_ids, prelim_d, nid, sentinel: int, *, incoming_r: int,
              cap: int):
    """Scatter every directed edge (u -> t) into t's incoming slots, the
    closest ``incoming_r`` first. The (target, distance) order is
    ``jnp.lexsort``'s (:func:`~tpu_hnsw_torch.ops.topk.lexsort_order`: one
    int64 key, legal here, where the reference's x64-off JAX truncated it).
    Row ``cap`` of the slots is trash."""
    t = prelim_ids.reshape(-1)
    u = nid[:, None].expand(prelim_ids.shape).reshape(-1)
    d = prelim_d.reshape(-1)
    order = T.lexsort_order(t, d)
    t, u, d = t[order], u[order], d[order]
    idx = torch.arange(t.shape[0], device=t.device)
    first = torch.ones_like(t, dtype=torch.bool)
    first[1:] = t[1:] != t[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    ok = (t != sentinel) & (rank < incoming_r)
    row = torch.where(ok, t.long(), cap)
    col = torch.where(ok, rank, 0)
    inc_ids = torch.full((cap + 1, incoming_r), sentinel, dtype=torch.int32,
                         device=t.device)
    inc_d = torch.full((cap + 1, incoming_r), torch.inf, device=t.device)
    inc_ids[row, col] = torch.where(ok, u, sentinel)
    inc_d[row, col] = torch.where(ok, d, torch.inf)
    return inc_ids, inc_d


def _final_select_chunk(g: G.HnswGraph, pi, pd, rows, inc_ids, inc_d, *,
                        lm: int, metric: Metric):
    ci = torch.cat([pi, inc_ids[rows]], 1)
    cd = torch.cat([pd, inc_d[rows]], 1)
    return S.select_neighbors(g, ci, cd, lm=lm, metric=metric)[0]


def _subset_topk(g: G.HnswGraph, q_ids, x_ids, *, k: int, metric: Metric,
                 xblock: int):
    """Exact top-k of ``q_ids`` among ``x_ids`` (global ids, sentinel padded;
    self hits excluded), a running merge over blocks of ``xblock``."""
    sent = g.sentinel
    qf = g.vectors[q_ids].float()
    xf = g.vectors[x_ids].float()
    best_d = torch.full((q_ids.shape[0], k), torch.inf, device=qf.device)
    best_i = torch.full((q_ids.shape[0], k), sent, dtype=torch.int32,
                        device=qf.device)
    qs = (qf * qf).sum(-1)
    for s in range(0, x_ids.shape[0], xblock):
        xb = xf[s:s + xblock]
        ib = x_ids[s:s + xblock]
        dots = qf @ xb.T
        if metric is Metric.L2:
            sc = torch.clamp_min(
                qs[:, None] + (xb * xb).sum(-1)[None, :] - 2 * dots, 0.0)
        else:
            sc = -dots
        sc = torch.where((ib == sent)[None, :], torch.inf, sc)
        sc = torch.where(ib[None, :] == q_ids[:, None], torch.inf, sc)
        vals, pos = T.topk_smallest_by_index(sc, min(k, xblock))
        d2 = torch.cat([best_d, vals], 1)
        i2 = torch.cat([best_i, ib[pos]], 1)
        best_d, sel = T.topk_smallest_by_index(d2, k)
        best_i = torch.gather(i2, 1, sel)
    # a block with fewer than k finite rows surfaces +inf ids; padding
    # query rows (the sentinel) get none, so they link nothing and write
    # the trash slot's own all-sentinel row (the reference scores the zero
    # trash vector against the subset and writes its picks there)
    best_d = torch.where((q_ids == sent)[:, None], torch.inf, best_d)
    return best_d, torch.where(torch.isfinite(best_d), best_i, sent)


def _link(g, node_ids_pad, ci_pad, cd_pad, m_pad: int, lm: int, trim: int,
          chunk: int, metric: Metric):
    """Select per element, symmetrise through the incoming slots, select
    again: each element's final list ``[m_pad, lm]``."""
    pre_i, pre_d = [], []
    for s in range(0, m_pad, chunk):
        si, sd = _select_chunk(g, ci_pad[s:s + chunk], cd_pad[s:s + chunk],
                               lm=lm, metric=metric, trim=trim)
        pre_i.append(si)
        pre_d.append(sd)
    pi = torch.cat(pre_i)
    pd = torch.cat(pre_d)
    inc_ids, inc_d = _incoming(pi, pd, node_ids_pad, g.sentinel,
                               incoming_r=32, cap=g.cap)
    return torch.cat([
        _final_select_chunk(g, pi[s:s + chunk], pd[s:s + chunk],
                            node_ids_pad[s:s + chunk], inc_ids, inc_d,
                            lm=lm, metric=metric)
        for s in range(0, m_pad, chunk)])


def _non_candidates(g: G.HnswGraph, node_ids, *, r2: int):
    """Candidates of an NN-descent refinement round: each row's level-0
    neighbours, then the first ``r2`` neighbours of each of them, ``[ch]``
    -> ``[ch, deg + deg*r2]``. Sentinel rows and sentinel neighbours give
    sentinel entries; ids are clamped into ``[0, cap]`` (the trash row), as
    the reference's ``mode="clip"`` gathers read. Nothing is deduplicated:
    a neighbour reached twice is the same candidate twice, which selection
    takes once."""
    sent = g.sentinel
    nb = g.neighbors0[torch.clamp(node_ids, 0, sent).long()]   # [ch, deg]
    nb = torch.where((node_ids == sent)[:, None], sent, nb)
    nb2 = g.neighbors0[torch.clamp(nb, 0, sent).long()][:, :, :r2]
    nb2 = torch.where((nb == sent)[:, :, None], sent, nb2)
    return torch.cat([nb, nb2.reshape(nb.shape[0], -1)], 1)


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

#: neighbours of each neighbour an NN-descent round adds (the reference's r2)
REFINE_R2 = 8


def build_bulk(index, data, cluster_size: int = 1024, overlap: int = 2,
               kmeans_iters: int = 5, refine_rounds: int = 0) -> None:
    """Bulk-build the empty ``index`` from ``data`` (an array, or an
    ``[n, d]`` tensor that stays on the device). Per-stage host seconds
    (each stage ends in a device sync) land in ``index.build_stats``.
    ``refine_rounds`` NN-descent rounds relink level 0 from each row's
    neighbours and their neighbours (off by default, as in the reference,
    which measured one round at 1M as 15.2 s of a 38.2 s build for at most
    0.0005 recall@10).

    A tensor is checked for NaN and infinity before any state changes; the
    reference checks only after it has written the graph and bumped
    ``n_upper`` (build_cluster.py:565-567), so a rejected build left its
    index changed."""
    cfg: HnswConfig = index.cfg
    metric = cfg.metric
    if index.n != 0:
        raise ValueError("build_bulk requires an empty index")
    dev = index.device
    stages: dict[str, float] = {}
    clock = [time.perf_counter()]

    def mark(name: str):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages[name] = round(stages.get(name, 0.0) + now - clock[0], 3)
        clock[0] = now

    if isinstance(data, torch.Tensor):
        if data.ndim != 2 or data.shape[1] != cfg.dim:
            raise ValueError(f"expected {cfg.dim} dimensions, not "
                             f"{data.shape[-1] if data.ndim else 0}")
        x = data.to(dev, torch.float32)
        if not _all_finite(x):
            raise ValueError("NaN or infinity values are not allowed")
        if metric.needs_normalized:
            x = _normalize_rows(x)
    else:
        x = torch.from_numpy(index._prep(data)).to(dev)
    n = x.shape[0]
    index._ensure_graph(n)
    g = index.graph
    sent = g.sentinel
    mark("prep_alloc")

    levels = index._draw_levels(n)
    slots = np.full(n, g.cap_upper, np.int32)
    upper_rows = np.where(levels >= 1)[0]
    if index.n_upper + len(upper_rows) > g.cap_upper:
        raise RuntimeError("upper-level table overflow; increase capacity")
    slots[upper_rows] = index.n_upper + np.arange(len(upper_rows),
                                                  dtype=np.int32)
    index.n_upper += len(upper_rows)
    lv_t = torch.from_numpy(levels).to(dev)
    sl_t = torch.from_numpy(slots).to(dev)
    for s in range(0, n, 262144):  # bounds the f32 norm temporaries
        e = min(n, s + 262144)
        B._set_wave(g, torch.arange(s, e, device=dev), x[s:e], lv_t[s:e],
                    sl_t[s:e])
    del x
    index._touch()
    mark("upload_vectors")

    # ---- level 0 candidates from overlapping clusters
    L = max(1, math.ceil(n / cluster_size))
    nid = torch.arange(n, dtype=torch.int32, device=dev)
    if L <= overlap:
        members = _pad_rows(nid, B.next_pow2(n), sent)[None, :]
        overlap_eff = 1
    else:
        overlap_eff = overlap
        vecs_n = g.vectors[:n]
        centroids, _ = KM.kmeans(vecs_n, L, iters=kmeans_iters, seed=cfg.seed,
                                 sample=min(n, 65536), balance=False,
                                 assign_full=False)
        blk = 131072
        top_c = torch.cat([_route_chunk(vecs_n[s:s + blk].float(), centroids,
                                        overlap=overlap)
                           for s in range(0, n, blk)])
        members = _pack_members(top_c, n, sent, L=L,
                                cs_cap=B.next_pow2(4 * cluster_size),
                                overlap=overlap)
    mark("kmeans_route_pack")

    CS = members.shape[1]
    k_cand = int(min(cfg.ef_construction, CS - 1))
    bc = max(1, (1 << 28) // (CS * CS * 4))  # clusters per batch: <= 1 GB
    cand = torch.cat([_cluster_batch(g.vectors, members[s:s + bc], sent,
                                     k_cand=k_cand, metric=metric)
                      for s in range(0, members.shape[0], bc)])
    mark("cluster_candidates")

    n_bucket = B.next_pow2(n)
    all_ci = _union_per_element(members, cand, sent, n_bucket=n_bucket,
                                overlap=overlap_eff)
    del cand
    _link_orphans(g, all_ci, n, k=k_cand, metric=metric)
    mark("union_candidates")

    # exact re-score in chunks of rows
    chunk = _rescore_rows(n_bucket, all_ci.shape[1], cfg.dim)
    n_pad = -(-n // chunk) * chunk
    ci_p = all_ci[:n_pad] if n_pad <= n_bucket else _pad_rows(all_ci, n_pad,
                                                              sent)
    # rows >= n of the union are scattered by sentinel members: made inert
    ci_p = torch.where((torch.arange(n_pad, device=dev) < n)[:, None], ci_p,
                       sent)
    nid_p = _pad_rows(nid, n_pad, sent)
    cd_p = torch.cat([_rescore_chunk(g, nid_p[s:s + chunk],
                                     ci_p[s:s + chunk], metric=metric)
                      for s in range(0, n_pad, chunk)])
    mark("rescore_l0")

    def link_level0(ci, cd):
        final0 = _link(g, nid_p, ci, cd, n_pad, cfg.m0, cfg.ef_construction,
                       chunk, metric)
        # padding rows (sentinel ids) write the all-sentinel trash row
        g.neighbors0[nid_p] = F.pad(final0,
                                    (0, g.neighbors0.shape[1] - cfg.m0),
                                    value=sent)

    link_level0(ci_p, cd_p)
    mark("link_l0")

    # NN-descent refinement: every row's candidates are read from the graph
    # before the round relinks it. The wider rows get their own rescore
    # chunk (a power of two no larger than ``chunk``, so it divides n_pad)
    rchunk = min(chunk, _rescore_rows(
        n_bucket, g.neighbors0.shape[1] * (1 + REFINE_R2), cfg.dim))
    for _ in range(refine_rounds):
        rci = torch.cat([_non_candidates(g, nid_p[s:s + rchunk], r2=REFINE_R2)
                         for s in range(0, n_pad, rchunk)])
        rcd = torch.cat([_rescore_chunk(g, nid_p[s:s + rchunk],
                                        rci[s:s + rchunk], metric=metric)
                         for s in range(0, n_pad, rchunk)])
        link_level0(rci, rcd)
    mark("nn_descent_refine")

    # ---- upper levels: exact subset top-k, then link. The reference pads
    # every small level to one 4096-row family so XLA compiles it once;
    # padded rows are inert, so the port pads a level to its own power of 2
    for lc in range(1, int(levels.max()) + 1):
        subset = np.where(levels >= lc)[0].astype(np.int32)
        if len(subset) <= 1:
            continue
        M = len(subset)
        bucket = B.next_pow2(M)
        chunk_u = min(8192, bucket)
        m_pad = -(-M // chunk_u) * chunk_u
        xblock = min(16384, bucket)
        sub = _pad_rows(torch.from_numpy(subset).to(dev), max(m_pad, bucket),
                        sent)
        k_up = int(min(cfg.ef_construction, bucket - 1))
        parts = [_subset_topk(g, sub[s:s + chunk_u], sub[:bucket], k=k_up,
                              metric=metric, xblock=xblock)
                 for s in range(0, m_pad, chunk_u)]
        dists = torch.cat([p[0] for p in parts])
        nbr = torch.cat([p[1] for p in parts])
        finalu = _link(g, sub[:m_pad], nbr, dists, m_pad, cfg.m, 0, chunk_u,
                       metric)
        slot_j = _pad_rows(torch.from_numpy(slots[subset]).to(dev), m_pad,
                           g.cap_upper)
        # padding rows write all-sentinel rows into the trash slot
        g.upper_nbrs[slot_j, lc - 1] = F.pad(
            finalu, (0, g.upper_nbrs.shape[2] - cfg.m), value=sent)
    mark("upper_levels")

    index.n = n
    top = int(levels.max())
    index.entry = int(np.where(levels == top)[0][0])
    index.entry_level = top
    index._touch()
    stages["total"] = round(sum(stages.values()), 3)
    stages["vectors_per_sec"] = round(n / max(stages["total"], 1e-9), 1)
    index.build_stats = {"mode": "bulk", "n": n, "cluster_size": cluster_size,
                         "overlap": overlap, "refine_rounds": refine_rounds,
                         "stages": stages}
