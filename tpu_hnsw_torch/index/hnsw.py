"""HnswIndex — the index access-method API (port of
``tpu_hnsw/index/hnsw.py``).

pgvector's callbacks map onto methods: ``hnswbuild`` -> :meth:`build`,
``hnswinsert`` -> :meth:`add`, ``hnswgettuple`` -> :meth:`search`,
``hnswbulkdelete`` -> :meth:`delete`, vacuum -> :meth:`compact` /
:meth:`vacuum_full`, the metapage -> the host scalars here. The graph's
tensors live in an :class:`~tpu_hnsw_torch.index.graph.HnswGraph` on
``device``: the card unless the caller names another.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from tpu_hnsw_torch.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw_torch.index import build as B
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index import search as SE
from tpu_hnsw_torch.index import select as SEL
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.utils.device import entry_device
from tpu_hnsw_torch.utils.profiling import annotate


def _tensor(a, device) -> torch.Tensor:
    """numpy array (ml_dtypes bfloat16 or its uint16 bits included) ->
    tensor on ``device`` that owns its memory (a CPU tensor would alias a
    caller's array, or a read-only view of another package's buffer)."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


class HnswIndex:
    # datasets at least this large take the bulk path by default
    BULK_THRESHOLD = 20_000
    # "auto" routing scans the level >= 1 subset densely from this many
    # upper elements; smaller graphs keep pgvector's greedy descent
    ROUTE_SCAN_MIN_UPPER = 4096

    def __init__(self, config: HnswConfig, capacity: int | None = None,
                 device=None):
        self.cfg = config
        self.capacity = int(capacity or config.max_elements or 0)
        self.device = entry_device(device)
        self.graph: G.HnswGraph | None = None
        self.n = 0
        self.n_upper = 0
        self.entry = -1
        self.entry_level = -1
        self._rng = np.random.default_rng(config.seed)
        self.build_stats: dict = {}
        # every mutation bumps the epoch, which keys the routing cache (the
        # reference keys it on the graph object, which its mutations replace)
        self._epoch = 0
        self._route_cache = None

    def _touch(self) -> None:
        self._epoch += 1

    # ------------------------------------------------------------------ util
    @property
    def size(self) -> int:
        return self.n

    def stats(self) -> dict:
        """Memory per component, bytes per element, degree and level
        statistics."""
        g = self.graph
        if g is None:
            return {"n": 0}
        comp = {f.name: getattr(g, f.name).numel()
                * getattr(g, f.name).element_size()
                for f in dataclasses.fields(g)}
        total = sum(comp.values())
        deg = (g.neighbors0[: self.n] != g.sentinel).sum(1).cpu().numpy()
        levels = g.levels[: self.n].cpu().numpy()
        return {
            "n": self.n,
            "capacity": self.capacity,
            "dim": self.cfg.dim,
            "dtype": self.cfg.dtype,
            "device": str(self.device),
            "entry": self.entry,
            "entry_level": self.entry_level,
            "n_deleted": int(g.deleted[: self.n].sum()),
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total / max(self.n, 1), 1),
            "degree_mean": float(deg.mean()) if self.n else 0.0,
            "degree_min": int(deg.min()) if self.n else 0,
            "level_counts": np.bincount(levels).tolist() if self.n else [],
        }

    def _ensure_graph(self, needed: int):
        if self.graph is None:
            if self.capacity == 0:
                self.capacity = max(needed, 1024)
            self.graph = G.init_graph(self.cfg, self.capacity, self.device)
        if self.n + needed > self.capacity:
            # INSERTs never fail on capacity upstream: the tables grow
            # geometrically; an explicit max_elements stays a hard cap
            hard = int(self.cfg.max_elements or 0)
            if hard and self.n + needed > hard:
                raise ValueError(f"index max_elements {hard} exceeded "
                                 f"(have {self.n}, adding {needed})")
            self.grow(max(2 * self.capacity, self.n + needed))

    def grow(self, new_capacity: int) -> None:
        """Larger tables, every row, edge and tombstone kept; sentinel ids
        (the old capacity) are re-pointed to the new one."""
        new_capacity = int(new_capacity)
        if self.graph is None:
            self.capacity = max(self.capacity, new_capacity)
            return
        g = self.graph
        old_cap, old_cap_u = g.cap, g.cap_upper
        if new_capacity <= old_cap:
            return
        fresh = G.init_graph(self.cfg, new_capacity, self.device)
        fresh.vectors[:old_cap] = g.vectors[:old_cap]
        fresh.vectors_sq[:old_cap] = g.vectors_sq[:old_cap]
        fresh.neighbors0[:old_cap] = torch.where(
            g.neighbors0[:old_cap] == old_cap, new_capacity,
            g.neighbors0[:old_cap])
        fresh.upper_nbrs[:old_cap_u] = torch.where(
            g.upper_nbrs[:old_cap_u] == old_cap, new_capacity,
            g.upper_nbrs[:old_cap_u])
        fresh.upper_slot[:old_cap] = torch.where(
            g.upper_slot[:old_cap] == old_cap_u, fresh.cap_upper,
            g.upper_slot[:old_cap])
        fresh.levels[:old_cap] = g.levels[:old_cap]
        fresh.deleted[:old_cap] = g.deleted[:old_cap]
        self.graph = fresh
        self.capacity = new_capacity
        self._touch()

    def _draw_levels(self, count: int) -> np.ndarray:
        """Geometric levels, pgvector's ``HnswInitElement``:
        floor(-ln(U) * ml), from the same numpy draws as the reference."""
        u = np.maximum(self._rng.random(count), 1e-12)
        lv = np.minimum((-np.log(u) * self.cfg.ml).astype(np.int64),
                        self.cfg.max_level)
        return lv.astype(np.int32)

    def _prep(self, data) -> np.ndarray:
        x = np.asarray(data, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        if x.shape[1] != self.cfg.dim:
            raise ValueError(
                f"expected {self.cfg.dim} dimensions, not {x.shape[1]}")
        if not np.isfinite(x).all():
            raise ValueError("NaN or infinity values are not allowed")
        if self.cfg.metric.needs_normalized:
            nrm = np.linalg.norm(x, axis=1, keepdims=True)
            x = x / np.maximum(nrm, 1e-12)
        return x

    # ----------------------------------------------------------------- build
    def build(self, data, mode: str = "auto") -> "HnswIndex":
        """CREATE INDEX analogue. ``mode``: "bulk" (clustered build,
        index/build_cluster.py), "wave" (batched inserts) or "auto" (bulk
        for an initial load of at least ``BULK_THRESHOLD`` rows). A 2-D
        tensor stays on the device through the bulk path; the wave path
        takes it to the host."""
        device_in = isinstance(data, torch.Tensor) and data.ndim == 2
        x = data if device_in else self._prep(data)
        if self.capacity == 0 and self.graph is None:
            self.capacity = max(self.cfg.max_elements, x.shape[0])
        if mode not in ("auto", "bulk", "wave"):
            raise ValueError("mode must be auto|bulk|wave")
        if mode == "bulk" and self.cfg.metric is Metric.L1:
            raise ValueError("bulk build does not support Metric.L1; "
                             "use mode='wave'")
        use_bulk = mode == "bulk" or (
            mode == "auto" and self.n == 0
            and x.shape[0] >= self.BULK_THRESHOLD
            and self.cfg.metric is not Metric.L1)
        if use_bulk:
            from tpu_hnsw_torch.index.build_cluster import build_bulk

            build_bulk(self, x)
        else:
            if device_in:
                x = self._prep(x.cpu().numpy())
            self.add(x, _pre=False)
        return self

    def add(self, data, _pre: bool = True, levels: np.ndarray | None = None,
            progress=None, checkpoint_every: int = 0,
            checkpoint_path: str | None = None) -> np.ndarray:
        """Insert vectors in waves (hnswinsert, batched). Returns their ids.
        ``levels`` overrides the level draw (tests). ``progress(done,
        total)`` runs after each wave; with ``checkpoint_every=K`` and a
        path the index is saved every K waves."""
        x = self._prep(data) if _pre else np.asarray(data, np.float32)
        count = x.shape[0]
        self._ensure_graph(count)
        if levels is None:
            levels = self._draw_levels(count)
        else:
            levels = np.asarray(levels, np.int32)
        ids_out = np.empty(count, dtype=np.int32)
        pos = 0
        # the first element becomes the entry point with no search
        if self.entry < 0 and count:
            ids_out[0] = self.n
            self._insert_first(x[0], int(levels[0]))
            pos = 1
        waves = 0
        while pos < count:
            # a wave never exceeds the current graph size
            wave = min(self.cfg.wave_size, max(1, self.n), count - pos)
            ids_out[pos:pos + wave] = self.n + np.arange(wave, dtype=np.int32)
            self._insert_wave(x[pos:pos + wave], levels[pos:pos + wave])
            pos += wave
            waves += 1
            if progress is not None:
                progress(pos, count)
            if checkpoint_every and checkpoint_path \
                    and waves % checkpoint_every == 0:
                self.save(checkpoint_path)
        return ids_out

    def _insert_first(self, vec: np.ndarray, level: int):
        g = self.graph
        nid = self.n
        slot = self.n_upper if level >= 1 else g.cap_upper
        if level >= 1:
            self.n_upper += 1
        dev = self.device
        B._set_wave(g, torch.tensor([nid], device=dev),
                    torch.from_numpy(np.asarray(vec, np.float32)[None]).to(dev),
                    torch.tensor([level], dtype=torch.int32, device=dev),
                    torch.tensor([slot], dtype=torch.int32, device=dev))
        self.entry, self.entry_level = nid, level
        self.n += 1
        self._touch()

    def _insert_wave(self, x: np.ndarray, levels: np.ndarray) -> None:
        bsz = x.shape[0]
        # the reference pads every wave to next_pow2(wave_size) so one XLA
        # program serves all; padded rows are inert, so the port pads only
        # to the wave's own power of two (ramp waves stay small)
        bpad = B.next_pow2(bsz)
        # the wave sorted by level, descending; each row keeps its natural
        # id (n + row)
        order = np.argsort(-levels, kind="stable")
        lv_sorted = levels[order]
        ids = np.full(bpad, self.graph.sentinel, np.int32)
        ids[:bsz] = self.n + order.astype(np.int32)
        lv = np.zeros(bpad, np.int32)
        lv[:bsz] = lv_sorted
        slots = np.full(bpad, self.graph.cap_upper, np.int32)
        n_up = int((lv_sorted >= 1).sum())
        if self.n_upper + n_up > self.graph.cap_upper:
            raise RuntimeError("upper-level table overflow; increase capacity")
        slots[:n_up] = self.n_upper + np.arange(n_up, dtype=np.int32)
        self.n_upper += n_up
        vecs = np.zeros((bpad, x.shape[1]), np.float32)
        vecs[:bsz] = x[order]
        upper = self._resolve_route("auto")
        self.graph = B.insert_wave(
            self.graph, self.cfg, torch.from_numpy(vecs).to(self.device),
            ids, lv, slots, bsz, self.entry, self.entry_level,
            upper_ids=None if upper is None else upper[0])
        self.n += bsz
        if int(lv_sorted[0]) > self.entry_level:
            self.entry = int(ids[0])
            self.entry_level = int(lv_sorted[0])
        self._touch()

    # ---------------------------------------------------------------- search
    def _route_table(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The dense route's table (``search.route_table``): ids of the
        level >= 1 elements, ascending, sentinel padded to a multiple of
        256, and their ``[1]`` int32 count, made on the device; cached per
        epoch, so a search reads nothing back for it."""
        cache = self._route_cache
        if cache is not None and cache[0] == self._epoch:
            return cache[1]
        g = self.graph
        upad = max(-(-self.n_upper // 256) * 256, 256)
        ids = torch.nonzero(g.levels[: g.cap] >= 1).reshape(-1)[:upad]
        ids = torch.nn.functional.pad(ids.to(torch.int32),
                                      (0, upad - ids.shape[0]), value=g.cap)
        table = SE.route_table(ids, g.sentinel)
        self._route_cache = (self._epoch, table)
        return table

    def _resolve_route(self, route: str):
        """None -> greedy descent; the route table (ids, live count) ->
        dense-scan routing."""
        if route not in ("auto", "scan", "descent"):
            raise ValueError("route must be auto, scan, or descent")
        if route == "descent" or self.cfg.metric is Metric.L1 \
                or self.n_upper == 0:
            return None
        if route == "auto" and self.n_upper < self.ROUTE_SCAN_MIN_UPPER:
            return None
        return self._route_table()

    def _filter_device(self, filter_mask) -> torch.Tensor:
        """``[cap+1]`` bool mask from a per-id filter (True = allowed): a
        bool mask of length >= n, an id list, or a tensor of that shape
        (used as it is)."""
        cap = self.graph.cap
        if isinstance(filter_mask, torch.Tensor) \
                and filter_mask.shape == (cap + 1,):
            return filter_mask.to(self.device, torch.bool)
        m = np.asarray(filter_mask.cpu() if isinstance(
            filter_mask, torch.Tensor) else filter_mask).reshape(-1)
        full = np.zeros(cap + 1, bool)
        if m.dtype == bool:
            ln = min(len(m), cap)
            full[:ln] = m[:ln]
        else:
            ids = m.astype(np.int64)
            full[ids[(ids >= 0) & (ids < cap)]] = True
        return torch.from_numpy(full).to(self.device)

    def _queries(self, queries) -> torch.Tensor:
        """Queries -> f32 ``[Q, d]`` on the device, normalised for cosine. A
        tensor is not validated (finite values are the caller's job)."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
            if q.ndim == 1:
                q = q[None]
            if q.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not {q.shape[1]}")
            if self.cfg.metric.needs_normalized:
                q = D.l2_normalize(q)
            return q
        return torch.from_numpy(self._prep(queries)).to(self.device)

    def _search(self, queries, k, ef_search, expand, descent_ef, max_steps,
                route, filter_mask, with_counters):
        validate_ef_search(ef_search)
        if self.graph is None or self.n == 0:
            raise ValueError("index is empty")
        with annotate("queries") as qspan:
            q = self._queries(queries)
            qspan.work = q.shape[0]
        upper_ids, upper_live = self._resolve_route(route) or (None, None)
        return SE.search(
            self.graph, q, entry=max(self.entry, 0),
            entry_level=max(self.entry_level, 0), k=k,
            ef_search=max(ef_search, k), metric=self.cfg.metric,
            expand=self.cfg.expand_per_step if expand is None else expand,
            descent_ef=(self.cfg.descent_ef if descent_ef is None
                        else descent_ef),
            max_steps=max_steps, with_counters=with_counters,
            upper_ids=upper_ids, upper_live=upper_live,
            allowed=(None if filter_mask is None
                     else self._filter_device(filter_mask)))

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      expand: int | None = None,
                      descent_ef: int | None = None, max_steps: int = 0,
                      route: str = "auto", filter_mask=None):
        """Search without a host copy: (distances, ids) tensors, distances
        in operator units, the sentinel id (capacity) where a result is
        missing.

        ``filter_mask`` (bool mask or id list of allowed rows) is fused into
        the beam like a tombstone; selective filters want a wider
        ``ef_search`` (see :meth:`search_iterative`). ``expand`` /
        ``descent_ef`` override the config's per call. ``route``: "descent"
        (greedy upper levels), "scan" (dense scan of the level >= 1
        subset), or "auto" (scan from ``ROUTE_SCAN_MIN_UPPER`` upper
        elements; descent always for L1)."""
        with annotate("search") as span:
            scores, ids = self._search(queries, k, ef_search, expand,
                                       descent_ef, max_steps, route,
                                       filter_mask, False)
            span.work = ids.shape[0]
            return D.score_to_distance(scores, self.cfg.metric), ids

    def search(self, queries, k: int = 10, ef_search: int = 40,
               return_distances: bool = True, expand: int | None = None,
               descent_ef: int | None = None, max_steps: int = 0,
               route: str = "auto", filter_mask=None):
        """ORDER BY distance LIMIT k: numpy (distances ``[Q, k]`` in operator
        units, ids ``[Q, k]``); a missing result has id -1 and distance
        +inf."""
        d, ids = self.search_device(queries, k=k, ef_search=ef_search,
                                    expand=expand, descent_ef=descent_ef,
                                    max_steps=max_steps, route=route,
                                    filter_mask=filter_mask)
        ids = ids.cpu().numpy()
        ids = np.where(ids == self.graph.sentinel, -1, ids)
        if not return_distances:
            return ids
        return d.cpu().numpy(), ids

    def search_with_stats(self, queries, k: int = 10, ef_search: int = 40,
                          route: str = "auto", expand: int | None = None,
                          descent_ef: int | None = None, max_steps: int = 0):
        """Search plus per-query counters: hops (steps that expanded a
        candidate) and distance evaluations. Returns (distances, ids,
        stats). ``expand`` / ``descent_ef`` / ``max_steps`` default to the
        config's, as in the reference (which does not take them)."""
        scores, ids, hops, evals = self._search(queries, k, ef_search,
                                                expand, descent_ef,
                                                max_steps, route, None, True)
        d = D.score_to_distance(scores, self.cfg.metric).cpu().numpy()
        ids = ids.cpu().numpy()
        hops, evals = hops.cpu().numpy(), evals.cpu().numpy()
        stats = {
            "hops_per_query_mean": float(np.mean(hops)),
            "hops_per_query_max": int(np.max(hops)),
            "dist_evals_per_query_mean": float(np.mean(evals)),
            "dist_evals_per_query_max": int(np.max(evals)),
        }
        return d, np.where(ids == self.graph.sentinel, -1, ids), stats

    # ---------------------------------------------------------------- delete
    def delete(self, ids) -> None:
        """Tombstone elements (hnswbulkdelete; repaired by :meth:`compact`).
        Ids outside ``[0, n)`` are ignored."""
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < self.n)]
        if ids.size:
            self.graph.deleted[torch.from_numpy(ids).to(self.device)] = True
            self._touch()

    def compact(self) -> int:
        """Graph repair after deletes (pgvector's ``hnswvacuum.c``): restore
        the entry point if it died, then find neighbours again for every
        list that points at a deleted element, as batched repair waves (the
        searches skip tombstones). Tombstoned rows stay allocated;
        :meth:`vacuum_full` reclaims them. Returns the number of repaired
        lists over all levels."""
        g = self.graph
        sent = g.sentinel
        dev = self.device
        deleted = g.deleted[: self.n].cpu().numpy()
        if not deleted.any():
            return 0
        levels = g.levels[: self.n].cpu().numpy()
        live = np.where(~deleted)[0]
        if live.size == 0:
            raise ValueError(
                "cannot compact an index with every element deleted")
        if deleted[self.entry]:  # pgvector's RepairGraphEntryPoint
            j = live[levels[live].argmax()]
            self.entry, self.entry_level = int(j), int(levels[j])
        del_ext = np.append(deleted, False)  # the sentinel is never deleted
        repaired = 0
        E = self.cfg.build_expand_per_step
        metric = self.cfg.metric
        for lc in range(self.entry_level, -1, -1):
            if lc == 0:
                adj = g.neighbors0[: self.n].cpu().numpy()
                nodes = np.arange(self.n)
            else:
                slots_all = g.upper_slot[: self.n].cpu().numpy()
                nodes = np.where((levels >= lc) & ~deleted)[0]
                adj = g.upper_nbrs[:, lc - 1].cpu().numpy()[slots_all[nodes]]
            safe = np.where(adj == sent, self.n, adj)
            affected = del_ext[safe].any(axis=1)
            if lc == 0:
                affected &= ~deleted[nodes]
            targets = nodes[affected]
            if targets.size == 0:
                continue
            repaired += int(targets.size)
            bpad = B.next_pow2(len(targets))
            ids_pad = np.full(bpad, sent, np.int32)
            ids_pad[: len(targets)] = targets
            idsj = torch.from_numpy(ids_pad).to(dev)
            qj = torch.zeros((bpad, self.cfg.dim), dtype=g.vectors.dtype,
                             device=dev)
            qj[: len(targets)] = g.vectors[idsj[: len(targets)]]
            # route through the upper levels first, as pgvector's repair
            # re-runs HnswFindElementNeighbors from the entry; level 0 of a
            # big graph takes the dense-scan seeds, as inserts do
            # (build.py::insert_wave)
            upper = self._resolve_route("auto") if lc == 0 else None
            if upper is not None:
                seeds = B._live_scan_seeds(g, qj, upper[0],
                                           self.cfg.ef_construction, metric)
            else:
                seeds = SE.descend_seeds(g, qj, self.entry, self.entry_level,
                                         lc, metric=metric,
                                         descent_ef=self.cfg.descent_ef)
            pool_d, pool_i = SE.search_layer(
                g, qj, seeds, lc, level0=(lc == 0),
                ef=self.cfg.ef_construction, expand=E, metric=metric)
            # drop self hits and padding rows
            pool_i = torch.where(pool_i == idsj[:, None], sent, pool_i)
            pool_d = torch.where(pool_i == sent, torch.inf, pool_d)
            pool_d, pool_i = B._mask_pool(pool_d, pool_i, len(targets), sent)
            # the surviving old neighbours join the candidates, so the
            # pruning can keep the navigable edges construction collected
            old_nbrs = np.full((bpad, adj.shape[1]), sent, np.int32)
            old_rows = adj[affected]
            old_nbrs[: len(targets)] = np.where(
                del_ext[np.where(old_rows == sent, self.n, old_rows)], sent,
                old_rows)
            oj = torch.from_numpy(old_nbrs).to(dev)
            oj = torch.where(oj == idsj[:, None], sent, oj)
            ov, _ = G.gather_vectors(g, oj)
            od = torch.where(oj == sent, torch.inf,
                             D.batched_scores(qj, ov, metric))
            lm = self.cfg.layer_m(lc)
            sel_ids, sel_dists = SEL.select_neighbors(
                g, torch.cat([pool_i, oj], 1), torch.cat([pool_d, od], 1),
                lm=lm, metric=metric)
            slots_pad = np.full(bpad, g.cap_upper, np.int32)
            if lc > 0:
                slots_pad[: len(targets)] = slots_all[targets]
            g = B._write_own_lists(g, idsj, torch.from_numpy(slots_pad).to(
                dev), sel_ids, lc, level0=(lc == 0))
            t, u, d = B._sorted_updates(sel_ids, sel_dists, idsj)
            g = B._reciprocal_update(g, t, u, d, lc, level0=(lc == 0), lm=lm,
                                     metric=metric)
        self.graph = g
        self._touch()
        return repaired

    def vacuum_full(self) -> np.ndarray:
        """Reclaim tombstoned rows: :meth:`compact`, then squash the live
        rows into fresh tables so :meth:`add` can use the space again. Ids
        are renumbered; returns the old -> new map (int64 ``[old n]``, -1
        for deleted rows)."""
        self.compact()
        g = self.graph
        n_old = self.n
        deleted = g.deleted[:n_old].cpu().numpy()
        live = np.where(~deleted)[0]
        if live.size == 0:
            raise ValueError(
                "cannot vacuum an index with every element deleted")
        n_new = int(live.size)
        idmap = np.full(n_old, -1, np.int64)
        idmap[live] = np.arange(n_new)
        fresh = G.init_graph(self.cfg, self.capacity, self.device)
        # old id -> new id over the sentinel row too; a repaired list points
        # at no deleted row, but one maps to the sentinel if it did
        remap = np.full(g.sentinel + 1, fresh.sentinel, np.int32)
        remap[live] = np.arange(n_new, dtype=np.int32)
        levels = g.levels[:n_old].cpu().numpy()[live]
        has_upper = levels >= 1
        n_up = int(has_upper.sum())
        new_slots = np.full(n_new, fresh.cap_upper, np.int32)
        new_slots[has_upper] = np.arange(n_up, dtype=np.int32)
        old_slots = g.upper_slot[:n_old].cpu().numpy()[live][has_upper]
        dev = self.device
        live_t = torch.from_numpy(live).to(dev)
        remap_t = torch.from_numpy(remap).to(dev)
        fresh.vectors[:n_new] = g.vectors[live_t]
        fresh.vectors_sq[:n_new] = D.squared_norms(fresh.vectors[:n_new])
        fresh.neighbors0[:n_new] = remap_t[g.neighbors0[live_t].long()]
        fresh.upper_nbrs[:n_up] = remap_t[g.upper_nbrs[torch.from_numpy(
            old_slots).to(dev)].long()]
        fresh.upper_slot[:n_new] = torch.from_numpy(new_slots).to(dev)
        fresh.levels[:n_new] = torch.from_numpy(levels).to(dev)
        self.graph = fresh
        self.n = n_new
        self.n_upper = n_up
        self.entry = int(idmap[self.entry])
        self._touch()
        return idmap

    # ------------------------------------------------------- iterative scan
    def search_iterative(self, queries, k: int = 10, ef_search: int = 40,
                         predicate=None, max_scan_tuples: int = 20000):
        """Iterative scan (``hnsw.iterative_scan`` with
        ``hnsw.max_scan_tuples``): when the filter rejects results, resume
        the search with a doubled pool until k results pass or the query's
        scan budget (distance evaluations) is spent. The pool and the dedup
        history carry over; each widening re-opens the frontier, bounding
        the rework to ~2x a single search at the final width.

        ``predicate(ids) -> bool mask`` runs on the host over an
        ``[nq, ef]`` id array (-1 where the pool is empty). Returns numpy
        (distances, ids), +inf / -1 padded, ascending (strict order).
        The finalisation is array code; the reference loops over queries
        in Python (hnsw.py:768-782). Only the queries still short of k
        resume, where the reference widens the whole batch: each query's
        beam is independent of the others', so its results are the same,
        and the few queries that widen to the cap no longer drag a
        ``[Q, 2m * expand, ef]`` dedup compare for the whole batch."""
        validate_ef_search(ef_search)
        if self.graph is None or self.n == 0:
            raise ValueError("index is empty")
        q = self._queries(queries)
        nq = q.shape[0]
        g = self.graph
        sent = g.sentinel
        metric = self.cfg.metric
        ef = max(ef_search, k)
        # the pool never needs to outgrow the scan budget or the corpus
        ef_cap = int(max(min(max_scan_tuples, self.n), ef))
        pool_d, pool_i, state = SE.search_resumable_start(
            g, q, max(self.entry, 0), max(self.entry_level, 0), ef=ef,
            expand=self.cfg.expand_per_step, metric=metric,
            descent_ef=self.cfg.descent_ef)
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        rows = np.arange(nq)  # the query of each row still searching
        while True:
            d_host = D.score_to_distance(pool_d, metric).cpu().numpy()
            ids = pool_i.cpu().numpy().astype(np.int64)
            ids = np.where(ids == sent, -1, ids)
            mask = np.asarray(predicate(ids), bool) if predicate is not None \
                else ids >= 0
            mask &= ids >= 0
            exhausted = state[5].cpu().numpy() >= max_scan_tuples
            rank = np.cumsum(mask, axis=1) - 1
            final = (mask.sum(1) >= k) | exhausted | (ef >= ef_cap)
            r, c = np.nonzero(mask & (rank < k) & final[:, None])
            out_d[rows[r], rank[r, c]] = d_host[r, c]
            out_i[rows[r], rank[r, c]] = ids[r, c]
            if final.all():
                break
            rows = rows[~final]
            keep = torch.from_numpy(np.nonzero(~final)[0]).to(self.device)
            q = q[keep]
            state = tuple(t[keep] for t in state)
            ef = min(2 * ef, ef_cap)
            pool_d, pool_i, state = SE.search_resume(
                g, q, state, ef=ef, expand=self.cfg.expand_per_step,
                metric=metric)
        return out_d, out_i

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """The reference's layout: ``graph.npz`` (bf16 vectors as their
        uint16 bits) and ``meta.json``; a directory written by either
        package loads in the other."""
        os.makedirs(path, exist_ok=True)
        g = self.graph
        if g.vectors.dtype == torch.bfloat16:
            vectors = g.vectors.view(torch.int16).cpu().numpy().view(
                np.uint16)
        else:
            vectors = g.vectors.cpu().numpy()
        np.savez(os.path.join(path, "graph.npz"), vectors=vectors,
                 neighbors0=g.neighbors0.cpu().numpy(),
                 upper_nbrs=g.upper_nbrs.cpu().numpy(),
                 upper_slot=g.upper_slot.cpu().numpy(),
                 levels=g.levels.cpu().numpy(),
                 deleted=g.deleted.cpu().numpy())
        meta = {
            "config": {**dataclasses.asdict(self.cfg),
                       "metric": self.cfg.metric.value},
            "n": self.n,
            "n_upper": self.n_upper,
            "entry": self.entry,
            "entry_level": self.entry_level,
            "capacity": self.capacity,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)

    @classmethod
    def load(cls, path: str, device=None) -> "HnswIndex":
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        c = dict(meta["config"])
        c["metric"] = Metric(c["metric"])
        z = np.load(os.path.join(path, "graph.npz"))
        state = {name: z[name] for name in z.files}
        state.update(n=meta["n"], n_upper=meta["n_upper"],
                     entry=meta["entry"], entry_level=meta["entry_level"])
        return cls.from_state(HnswConfig(**c), state, device=device,
                              capacity=meta["capacity"])

    @classmethod
    def from_state(cls, cfg: HnswConfig, state: dict, device=None,
                   capacity: int | None = None) -> "HnswIndex":
        """An index over a graph carried across from ``tpu_hnsw``: numpy
        arrays under :class:`HnswGraph`'s field names (``vectors_sq`` may be
        left out: it is the vectors' squared norms), plus ``n``,
        ``n_upper``, ``entry`` and ``entry_level``."""
        idx = cls(cfg, capacity=capacity, device=device)
        dev = idx.device
        vectors = _tensor(state["vectors"], dev).to(G.storage_dtype(cfg))
        vsq = state.get("vectors_sq")
        idx.graph = G.HnswGraph(
            vectors=vectors,
            vectors_sq=(D.squared_norms(vectors) if vsq is None
                        else _tensor(vsq, dev)),
            **{name: _tensor(state[name], dev)
               for name in ("neighbors0", "upper_nbrs", "upper_slot",
                            "levels", "deleted")})
        # a graph bulk-built by the reference holds picks in its upper
        # table's trash slot (build_cluster.py:558); the searches here rely
        # on every trash row reading as nothing
        G.restore_trash(idx.graph)
        idx.capacity = idx.capacity or idx.graph.cap
        idx.n = int(state["n"])
        idx.n_upper = int(state["n_upper"])
        idx.entry = int(state["entry"])
        idx.entry_level = int(state["entry_level"])
        return idx
