"""Partitioned HNSW, host-loop mode (port of the first half of
``tpu_hnsw/parallel/partition.py``): one logical index over P sub-indexes,
with routed queries and a global top-k merge.

- **hash partitioning** (config D): a row lives in partition ``id % P``,
  and queries fan out to every partition;
- **centroid partitioning** (config E): k-means centroids
  (:mod:`.kmeans`) own the rows nearest them, queries visit their
  ``route_k`` nearest partitions, and a budget of border rows may be
  stored in their second partition too (multi-assign replicas, removed
  again by the merge).

Sub-indexes are ``HnswIndex`` (``engine="graph"``) or ``BlockHnswIndex``
(``engine="block"``) on the index's device. :meth:`search` loops over the
partitions and merges on the host with the reference's ``np.argsort``;
:meth:`search_device` searches every partition and merges on the device
(:func:`~tpu_hnsw_torch.ops.topk.mask_duplicate_ids`, then a keyed top-k).
The stacked mesh searchers and the mesh build are not ported yet
(ROADMAP.md queue 1, items 3b and 3c).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpu_hnsw_torch.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw_torch.index.block import BlockHnswIndex
from tpu_hnsw_torch.index.hnsw import HnswIndex
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import kmeans as KM
from tpu_hnsw_torch.utils.device import entry_device

_MESH_NOT_PORTED = ("the mesh modes of PartitionedHnswIndex are not ported "
                    "yet (ROADMAP.md queue 1, items 3b and 3c); build "
                    "without a mesh and serve through search/search_device")


def _dup_mask_np(ids: np.ndarray) -> np.ndarray:
    """``[Q, w]`` bool: True where an id (>= 0) repeats an earlier column;
    the host twin of :func:`~tpu_hnsw_torch.ops.topk.mask_duplicate_ids`."""
    w = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]
    earlier = np.tril(np.ones((w, w), bool), -1)
    return (eq & earlier[None] & (ids[:, :, None] >= 0)).any(-1)


def _rows_tensor(data, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(data, np.float32)).to(device)


class HashRouter:
    """Rows by id modulo P; queries go to every partition."""

    kind = "hash"

    def __init__(self, n_partitions: int):
        self.p = n_partitions

    def assign(self, data, ids: np.ndarray) -> np.ndarray:
        return (ids % self.p).astype(np.int32)

    def route(self, queries, route_k: int) -> np.ndarray:
        return np.tile(np.arange(self.p, dtype=np.int32),
                       (queries.shape[0], 1))


class CentroidRouter:
    """k-means centroids own the rows nearest them (L2); queries visit the
    ``route_k`` nearest partitions (IVFFlat's ``probes``). The products run
    on ``device``; centroids and results are numpy."""

    kind = "centroid"

    def __init__(self, n_partitions: int, centroids: np.ndarray | None = None,
                 device=None):
        self.p = n_partitions
        self.centroids = centroids
        self.device = entry_device(device)

    def _scores(self, x) -> torch.Tensor:
        c = torch.from_numpy(np.asarray(self.centroids, np.float32)).to(
            self.device)
        return D.pairwise_scores(_rows_tensor(x, self.device), c, Metric.L2)

    def fit(self, data, seed: int = 0, iters: int = 10) -> np.ndarray:
        cents, assign = KM.kmeans(_rows_tensor(data, self.device), self.p,
                                  iters=iters, seed=seed)
        self.centroids = cents.cpu().numpy()
        return assign.cpu().numpy().astype(np.int32)

    def assign(self, data, ids: np.ndarray) -> np.ndarray:
        if self.centroids is None:
            return self.fit(data)
        # torch.argmin, like jnp.argmin, takes the first of equal minima
        return self._scores(data).argmin(dim=1).cpu().numpy().astype(
            np.int32)

    def route(self, queries, route_k: int) -> np.ndarray:
        k = min(route_k or self.p, self.p)
        idx = T.topk_smallest_by_index(self._scores(queries), k)[1]
        return idx.cpu().numpy().astype(np.int32)


class PartitionedHnswIndex:
    """P sub-indexes behind one logical index, on ``device`` (default: the
    card; raises without one).

    ``multi_assign_frac`` (centroid router only): that fraction of rows,
    those with the smallest gap between their nearest and second-nearest
    centroid, is also stored in the second partition; merges drop the
    replica, which arrives with an identical distance."""

    #: rows per chunk of the multi-assign scoring (partition.py:194)
    ASSIGN_CHUNK = 262144

    def __init__(self, config: HnswConfig, n_partitions: int,
                 router: str = "hash", capacity: int | None = None,
                 route_k: int = 0, engine: str = "graph",
                 block_size: int = 256, multi_assign_frac: float = 0.0,
                 device=None):
        if engine not in ("graph", "block"):
            raise ValueError("engine must be graph|block")
        self.cfg = config
        self.p = n_partitions
        self.route_k = route_k
        self.engine = engine
        self.block_size = block_size
        self.device = entry_device(device)
        self.router = (HashRouter(n_partitions) if router == "hash"
                       else CentroidRouter(n_partitions, device=self.device))
        self.parts: list = []
        self.capacity = capacity
        self.multi_assign_frac = float(multi_assign_frac)
        # global id -> (secondary partition, local id there), -1 = none
        self._replica_part = np.zeros(0, np.int32)
        self._replica_local = np.zeros(0, np.int32)
        self.has_replicas = False
        # global id -> (partition, local id)
        self._part_of = np.zeros(0, np.int32)
        self._local_of = np.zeros(0, np.int32)
        self.n = 0

    def _part_rows(self, p: int) -> int:
        """Searchable rows in partition p (block engine: packed + tail)."""
        sub = self.parts[p]
        return sub.n + (sub.tail_live if self.engine == "block" else 0)

    def _sub(self, rows: int):
        if self.engine == "block":
            return BlockHnswIndex(self.cfg, block_size=self.block_size,
                                  device=self.device)
        # each shard sized for its own load (+20% insert headroom): centroid
        # partitions can be heavily skewed
        return HnswIndex(self.cfg, capacity=max(64, int(1.2 * rows) + 64),
                         device=self.device)

    # ----------------------------------------------------------------- build
    def build(self, data, mesh=None) -> "PartitionedHnswIndex":
        """Build every partition in turn on the index's device. A mesh is
        not ported yet and raises."""
        if mesh is not None:
            raise NotImplementedError(_MESH_NOT_PORTED)
        data = np.asarray(data, np.float32)
        n = data.shape[0]
        ids = np.arange(n)
        if (isinstance(self.router, CentroidRouter)
                and self.router.centroids is None):
            assign = self.router.fit(data, seed=self.cfg.seed)
        else:
            assign = self.router.assign(data, ids)
        self._part_of = assign.copy()
        self._local_of = np.zeros(n, np.int32)
        replica = np.full(n, -1, np.int32)
        if (self.multi_assign_frac > 0
                and isinstance(self.router, CentroidRouter) and self.p > 1):
            replica = self._replicas(data, assign)
        self._replica_part = replica
        self._replica_local = np.full(n, -1, np.int32)
        self.has_replicas = bool((replica >= 0).any())
        self.parts = []
        for p in range(self.p):
            rows = np.where(assign == p)[0]
            self._local_of[rows] = np.arange(len(rows), dtype=np.int32)
            rep_rows = np.where(replica == p)[0]
            if rep_rows.size:
                self._replica_local[rep_rows] = (
                    len(rows) + np.arange(len(rep_rows))).astype(np.int32)
                rows = np.concatenate([rows, rep_rows])
            sub = self._sub(len(rows))
            sub._global_ids = rows.astype(np.int32)  # local -> global
            if len(rows):
                sub.build(data[rows])
            elif self.engine == "graph":
                sub._ensure_graph(0)  # an empty partition has a graph
            self.parts.append(sub)
        self.n = n
        return self

    def _replicas(self, data, assign: np.ndarray) -> np.ndarray:
        """Second partition of the ``multi_assign_frac`` share of rows with
        the smallest gap between their two nearest centroids
        (partition.py:196-214); -1 elsewhere."""
        n = data.shape[0]
        second = np.zeros(n, np.int32)
        gap = np.zeros(n, np.float32)
        for s0 in range(0, n, self.ASSIGN_CHUNK):
            sc = self.router._scores(data[s0:s0 + self.ASSIGN_CHUNK])
            rows = torch.arange(sc.shape[0], device=sc.device)
            a = torch.from_numpy(
                assign[s0:s0 + self.ASSIGN_CHUNK].astype(np.int64)).to(
                    sc.device)
            d1 = sc[rows, a].clone()
            sc[rows, a] = torch.inf
            s2 = sc.argmin(dim=1)
            second[s0:s0 + sc.shape[0]] = s2.cpu().numpy()
            gap[s0:s0 + sc.shape[0]] = (sc[rows, s2] - d1).cpu().numpy()
        replica = np.full(n, -1, np.int32)
        budget = int(min(self.multi_assign_frac, 1.0) * n)
        if budget:
            border = np.argpartition(gap, budget - 1)[:budget]
            replica[border] = second[border]
        return replica

    # ---------------------------------------------------------------- search
    def _fetch(self, p: int, queries: np.ndarray, k: int, ef_search: int,
               **kw):
        """Partition p's top-k as (distances, global ids) numpy; +inf / -1
        where it returned fewer."""
        sub = self.parts[p]
        d, ids = sub.search(queries, k=k, ef_search=ef_search, **kw)
        glob = np.where(ids >= 0, sub._global_ids[np.clip(ids, 0, None)], -1)
        return np.where(ids >= 0, d, np.inf), glob

    def search(self, queries, k: int = 10, ef_search: int = 40,
               route_k: int | None = None, descent_ef: int | None = None):
        """Routed per-partition search and a global top-k merge on the host
        (partition.py:268-307). ``descent_ef`` (graph engine) widens each
        shard's upper-level descent."""
        validate_ef_search(max(ef_search, k))
        queries = np.asarray(queries, np.float32)
        route_k = self.route_k if route_k is None else route_k
        routes = self.router.route(queries, route_k)  # [Q, R]
        nq = queries.shape[0]
        sub_kw = {} if self.engine == "block" else {"descent_ef": descent_ef}
        all_d = np.full((nq, self.p, k), np.inf, np.float32)
        all_i = np.full((nq, self.p, k), -1, np.int64)
        for p in range(self.p):
            mask = (routes == p).any(axis=1)
            if not mask.any() or self._part_rows(p) == 0:
                continue
            all_d[mask, p, :], all_i[mask, p, :] = self._fetch(
                p, queries[mask], k, ef_search, **sub_kw)
        flat_d = all_d.reshape(nq, -1)
        flat_i = all_i.reshape(nq, -1)
        if self.has_replicas:
            flat_d = np.where(_dup_mask_np(flat_i), np.inf, flat_d)
        order = np.argsort(flat_d, axis=1)[:, :k]
        d_out = np.take_along_axis(flat_d, order, axis=1)
        i_out = np.take_along_axis(flat_i, order, axis=1)
        if self.has_replicas:
            i_out = np.where(np.isfinite(d_out), i_out, -1)
        return d_out, i_out

    def _global_ids_device(self, sub) -> torch.Tensor:
        """The shard's local -> global id map on the device, made once and
        dropped whenever the map or the shard changes."""
        gid = getattr(sub, "_global_ids_dev", None)
        if gid is None:
            gid = torch.from_numpy(
                np.asarray(sub._global_ids, np.int64)).to(self.device)
            sub._global_ids_dev = gid
        return gid

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None,
                      descent_ef: int | None = None):
        """Every partition searched on the device and one merge there, with
        no host copy (partition.py:309-351): the queries go up once, each
        shard's ids map to global ids on the device, replicas are masked,
        and a keyed top-k keeps the best k (ties to the earlier partition).
        Searches all partitions: exact for hash routing, the exhaustive
        bound for centroid routing (use :meth:`search` for routed subsets).
        Returns (distances in operator units, ids) tensors."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = np.asarray(queries, np.float32)
            if not np.isfinite(q).all():
                raise ValueError("NaN or infinity values are not allowed")
            q = torch.from_numpy(q).to(self.device)
        ds, gs = [], []
        for p, sub in enumerate(self.parts):
            if self._part_rows(p) == 0:
                continue
            kw = ({"probes": probes} if self.engine == "block"
                  else {"descent_ef": descent_ef})
            d, i = sub.search_device(q, k=k, ef_search=ef_search, **kw)
            gid = self._global_ids_device(sub)
            # the graph engine's sentinel (its capacity) lies past the map:
            # clamp it (JAX's mode="clip"); its distance is +inf
            gi = torch.where(i >= 0, gid[torch.clamp(i.long(), 0,
                                                      gid.numel() - 1)], -1)
            ds.append(d)
            gs.append(gi)
        alld = torch.cat(ds, dim=1)
        alli = torch.cat(gs, dim=1)
        if self.has_replicas:
            alld = T.mask_duplicate_ids(alld, alli)
        vals, sel = T.topk_smallest_by_index(alld, k)
        ids = torch.gather(alli, 1, sel)
        return vals, torch.where(torch.isfinite(vals), ids, -1)

    def search_iterative(self, queries, k: int = 10, ef_search: int = 40,
                         predicate=None, route_k: int | None = None,
                         max_route_k: int = 0):
        """Iterative scan across partitions (partition.py:353-441): while a
        filter leaves queries short of k passing results, widen both the
        route set (``route_k`` doubles along the router's ranking) and the
        per-partition fetch (doubles), re-searching only pending queries.
        A filtered query is final once its k passing results survive one
        further widening. ``predicate(ids) -> bool mask`` runs on the host
        over global ids. Returns (distances, ids), +inf / -1 padded."""
        validate_ef_search(max(ef_search, k))
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        max_route_k = min(max_route_k or self.p, self.p)
        r = route_k if route_k is not None else (self.route_k or 1)
        r = max(1, min(r, max_route_k))
        routes_full = self.router.route(queries, self.p)  # [Q, <=P]
        fetch = k if predicate is None else min(max(4 * k, 2 * k), 1000)
        max_fetch = min(1000, max(fetch, max(self._part_rows(p)
                                             for p in range(self.p))))
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        confirmed = np.zeros(nq, bool)
        while True:
            acc_d = np.full((nq, self.p, fetch), np.inf, np.float32)
            acc_i = np.full((nq, self.p, fetch), -1, np.int64)
            cur_routes = routes_full[:, :r]
            for p in range(self.p):
                mask = (cur_routes == p).any(axis=1) & ~done
                if not mask.any() or self._part_rows(p) == 0:
                    continue
                kk = min(fetch, self._part_rows(p))
                acc_d[mask, p, :kk], acc_i[mask, p, :kk] = self._fetch(
                    p, queries[mask], kk, max(ef_search, kk))
            flat_d = acc_d.reshape(nq, -1)
            flat_i = acc_i.reshape(nq, -1)
            order = np.argsort(flat_d, axis=1)
            sd = np.take_along_axis(flat_d, order, axis=1)
            si = np.take_along_axis(flat_i, order, axis=1)
            mask = predicate(si) if predicate is not None else si >= 0
            mask &= si >= 0
            if self.has_replicas:
                mask &= ~_dup_mask_np(si)
            exhausted = (r >= min(max_route_k, routes_full.shape[1])
                         and fetch >= max_fetch)
            for qi in range(nq):
                if done[qi]:
                    continue
                good = np.where(mask[qi])[0][:k]
                if len(good) >= k and not exhausted and not confirmed[qi] \
                        and predicate is not None:
                    confirmed[qi] = True  # widen once more, then finalize
                    continue
                if len(good) >= k or exhausted:
                    out_d[qi, : len(good)] = sd[qi, good]
                    out_i[qi, : len(good)] = si[qi, good]
                    done[qi] = True
            if done.all() or exhausted:
                break
            r = min(2 * r, max_route_k)
            if predicate is not None:
                fetch = min(2 * fetch, max_fetch)
        return out_d, out_i

    # ------------------------------------------------------------------- dml
    def add(self, data) -> np.ndarray:
        """INSERT: each row goes to its owning partition (hash: by global
        id; centroid: nearest centroid) and into that sub-index (graph: wave
        insert; block: spill tail). Returns the global ids."""
        if not self.parts:
            raise ValueError("build() the partitioned index before add()")
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[None, :]
        count = data.shape[0]
        gids = self.n + np.arange(count, dtype=np.int32)
        assign = np.asarray(self.router.assign(data, gids), np.int32)
        self._part_of = np.concatenate([self._part_of, assign])
        self._local_of = np.concatenate(
            [self._local_of, np.zeros(count, np.int32)])
        for p in range(self.p):
            rows = np.where(assign == p)[0]
            if not rows.size:
                continue
            sub = self.parts[p]
            loc = np.asarray(sub.add(data[rows]), np.int64)
            # local ids may reuse the high-water mark after delete and
            # compact: the map grows and is assigned, not only appended
            gmap = np.asarray(sub._global_ids, np.int32)
            need = int(loc.max()) + 1
            if need > len(gmap):
                gmap = np.concatenate(
                    [gmap, np.full(need - len(gmap), -1, np.int32)])
            gmap[loc] = gids[rows]
            sub._global_ids = gmap
            sub.__dict__.pop("_global_ids_dev", None)
            self._local_of[gids[rows]] = loc.astype(np.int32)
        self.n += count
        return gids

    def delete(self, ids) -> None:
        """DELETE: tombstone global ids, and their replicas, in their
        partitions (reclaimed by :meth:`compact`)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        ids = ids[(ids >= 0) & (ids < len(self._part_of))]
        if not ids.size:
            return
        owners = self._part_of[ids]
        for p in np.unique(owners):
            self.parts[p].delete(self._local_of[ids[owners == p]])
            self.parts[p].__dict__.pop("_global_ids_dev", None)
        if self.has_replicas and len(self._replica_part):
            rid = ids[ids < len(self._replica_part)]
            rown = self._replica_part[rid]
            for p in np.unique(rown[rown >= 0]):
                self.parts[p].delete(self._replica_local[rid[rown == p]])
                self.parts[p].__dict__.pop("_global_ids_dev", None)

    def compact(self) -> None:
        """VACUUM: repair (graph) or re-pack (block) every partition with
        tombstones or spill-tail rows. Local ids survive, so the global maps
        stay valid; a partition with no live row is left as it is."""
        for sub in self.parts:
            if self.engine == "block":
                live = sub.n + sub.tail_live
                dead = (sub.n_total - sub.n) + (sub.tail_n - sub.tail_live)
                if live > 0 and (dead > 0 or sub.tail_n > 0):
                    sub.compact()
            elif sub.n and sub.graph is not None:
                deleted = sub.graph.deleted[: sub.n].cpu().numpy()
                if deleted.any() and not deleted.all():
                    sub.compact()
            sub.__dict__.pop("_global_ids_dev", None)

    def sharded(self, mesh=None):
        """The stacked mesh searchers: not ported yet."""
        raise NotImplementedError(_MESH_NOT_PORTED)

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """``partitioned.json``, ``router.npz`` and ``part{p}/`` with each
        sub-index and its ``global_ids.npy``: the reference's layout."""
        os.makedirs(path, exist_ok=True)
        for p, sub in enumerate(self.parts):
            sub.save(os.path.join(path, f"part{p}"))
            np.save(os.path.join(path, f"part{p}", "global_ids.npy"),
                    sub._global_ids)
        meta = {
            "p": self.p,
            "router": self.router.kind,
            "route_k": self.route_k,
            "n": self.n,
            "engine": self.engine,
            "block_size": self.block_size,
            "multi_assign_frac": self.multi_assign_frac,
            "has_replicas": self.has_replicas,
        }
        with open(os.path.join(path, "partitioned.json"), "w") as f:
            json.dump(meta, f)
        np.savez(
            os.path.join(path, "router.npz"),
            centroids=(self.router.centroids
                       if isinstance(self.router, CentroidRouter)
                       else np.zeros(0)),
            part_of=self._part_of,
            local_of=self._local_of,
            replica_part=self._replica_part,
            replica_local=self._replica_local,
        )

    @classmethod
    def load(cls, path: str, device=None) -> "PartitionedHnswIndex":
        with open(os.path.join(path, "partitioned.json")) as f:
            meta = json.load(f)
        engine = meta.get("engine", "graph")
        sub_cls = BlockHnswIndex if engine == "block" else HnswIndex
        parts = []
        for p in range(meta["p"]):
            sub = sub_cls.load(os.path.join(path, f"part{p}"), device=device)
            sub._global_ids = np.load(
                os.path.join(path, f"part{p}", "global_ids.npy"))
            parts.append(sub)
        idx = cls(parts[0].cfg, meta["p"], router=meta["router"],
                  route_k=meta["route_k"], engine=engine,
                  block_size=meta.get("block_size", 256), device=device)
        z = np.load(os.path.join(path, "router.npz"))
        if meta["router"] == "centroid":
            idx.router.centroids = z["centroids"]
        idx._part_of, idx._local_of = z["part_of"], z["local_of"]
        if "replica_part" in z:
            idx._replica_part = z["replica_part"]
            idx._replica_local = z["replica_local"]
        idx.multi_assign_frac = float(meta.get("multi_assign_frac", 0.0))
        idx.has_replicas = bool(meta.get("has_replicas", False))
        idx.n = meta["n"]
        idx.parts = parts
        return idx
