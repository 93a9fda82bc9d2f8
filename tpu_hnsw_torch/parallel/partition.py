"""Partitioned HNSW (port of ``tpu_hnsw/parallel/partition.py``): one
logical index over P sub-indexes, with routed queries and a global top-k
merge.

- **hash partitioning** (config D): a row lives in partition ``id % P``,
  and queries fan out to every partition;
- **centroid partitioning** (config E): k-means centroids
  (:mod:`.kmeans`) own the rows nearest them, queries visit their
  ``route_k`` nearest partitions, and a budget of border rows may be
  stored in their second partition too (multi-assign replicas, removed
  again by the merge).

Sub-indexes are ``HnswIndex`` (``engine="graph"``) or ``BlockHnswIndex``
(``engine="block"``) on the index's device. Two ways to serve:

- *host loop*: :meth:`PartitionedHnswIndex.search` loops over the
  partitions and merges on the host with the reference's ``np.argsort``;
  :meth:`~PartitionedHnswIndex.search_device` searches every partition in
  turn and merges on the device;
- *stacked* (:meth:`PartitionedHnswIndex.sharded`): the partitions' state
  stacked along a leading partition axis. :class:`ShardedBlockSearcher`
  serves every partition in one batch over that axis (one route GEMM, one
  stage-1 kernel launch, one rerank), config D's one-card mode;
  :class:`ShardedHnswSearcher` loops the graph beam over its partitions.
  With a ``torch.distributed`` process group of R ranks each rank holds
  P / R partitions and the lists merge through :mod:`.collectives`.

``build(data, mesh=...)`` builds the graph engine's partitions in
lockstep (:mod:`.mesh_build`): every wave step advances every partition on
one device, or P / R partitions on each of R ranks.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from tpu_hnsw_torch.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw_torch.index import graph as G
from tpu_hnsw_torch.index.block import (BlockHnswIndex, Stored,
                                        _check_score_dtype, _expand_step,
                                        _score_width, probes_for_ef)
from tpu_hnsw_torch.index.hnsw import HnswIndex
from tpu_hnsw_torch.index.search import _descend_body, _search_layer_body
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import route as R
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import collectives as C
from tpu_hnsw_torch.parallel import kmeans as KM
from tpu_hnsw_torch.parallel import mesh_build
from tpu_hnsw_torch.utils.device import entry_device
from tpu_hnsw_torch.utils.profiling import annotate


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
        # set by ShardedBlockSearcher.release_parts_device_state: the
        # partitions' device tensors are gone, so per-partition search and
        # DML must refuse
        self._released = False

    def _check_live(self, op: str) -> None:
        if self._released:
            raise RuntimeError(
                f"PartitionedHnswIndex.{op}: the partitions' device state "
                "was released (release_parts_device_state) in favour of the "
                "stacked ShardedBlockSearcher; serve through the searcher, "
                "or build or load the index again for per-partition search "
                "and DML")

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
        """Build every partition on the index's device. ``mesh``: None
        builds them in turn; ``"auto"`` or a device builds the graph
        engine's partitions in lockstep (:mod:`.mesh_build`; in turn for a
        single partition, as the reference's ``"auto"`` does); a
        ``torch.distributed`` group or 1-D DeviceMesh of R ranks builds P / R
        partitions a rank in lockstep and hands every rank all P. The block
        engine ignores ``mesh``."""
        if isinstance(mesh, str) and mesh != "auto":
            torch.device(mesh)  # a device's name, or this raises
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
        part_rows = []
        for p in range(self.p):
            rows = np.where(assign == p)[0]
            self._local_of[rows] = np.arange(len(rows), dtype=np.int32)
            rep_rows = np.where(replica == p)[0]
            if rep_rows.size:
                self._replica_local[rep_rows] = (
                    len(rows) + np.arange(len(rep_rows))).astype(np.int32)
                rows = np.concatenate([rows, rep_rows])
            part_rows.append(rows)
        self.parts = []
        if self.engine == "graph" and mesh is not None and (
                self.p > 1 or mesh_build.is_group(mesh)):
            prepped = HnswIndex(self.cfg, capacity=1,
                                device=self.device)._prep(data)
            self.parts = mesh_build.build_partitions_mesh(
                self.cfg, [prepped[r] for r in part_rows],
                mesh=mesh,
                device=self.device)
            for sub, rows in zip(self.parts, part_rows):
                sub._global_ids = rows.astype(np.int32)
        else:
            for rows in part_rows:
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
        self._check_live("search")
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
        self._check_live("search_device")
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
        self._check_live("search_iterative")
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
        self._check_live("add")
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
        self._check_live("delete")
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
        self._check_live("compact")
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
        """The stacked searcher (partition.py:526-534): a
        :class:`ShardedBlockSearcher` for the block engine, a
        :class:`ShardedHnswSearcher` for the graph engine. ``mesh``: None
        (this process serves all P partitions on the index's device), or a
        ``torch.distributed`` process group or 1-D ``DeviceMesh`` of R
        ranks, each serving P / R of them."""
        self._check_live("sharded")
        if self.engine == "block":
            return ShardedBlockSearcher(self, mesh)
        return ShardedHnswSearcher(self, mesh)

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """``partitioned.json``, ``router.npz`` and ``part{p}/`` with each
        sub-index and its ``global_ids.npy``: the reference's layout."""
        self._check_live("save")
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
    def load(cls, path: str, device=None,
             score_dtype: str | None = None) -> "PartitionedHnswIndex":
        """Read a directory written by :meth:`save` (either package's).
        ``score_dtype`` is passed to each block-engine part's
        :meth:`BlockHnswIndex.load`: None keeps the directory's scoring
        copy; a graph-engine index, which has none, refuses it."""
        with open(os.path.join(path, "partitioned.json")) as f:
            meta = json.load(f)
        engine = meta.get("engine", "graph")
        if engine == "block":
            sub_cls, kw = BlockHnswIndex, {"score_dtype": score_dtype}
        elif score_dtype is not None:
            raise ValueError("score_dtype applies to block-engine partitions")
        else:
            sub_cls, kw = HnswIndex, {}
        parts = []
        for p in range(meta["p"]):
            sub = sub_cls.load(os.path.join(path, f"part{p}"), device=device,
                               **kw)
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


# ---------------------------------------------------------------------------
# stacked searchers
# ---------------------------------------------------------------------------


def _local_partitions(p: int, mesh) -> tuple:
    """(process group or None, ranks R, this rank's first partition, P / R)
    for ``mesh``: None, a process group or a 1-D DeviceMesh."""
    group, ranks = C.resolve_group(mesh)
    if p % ranks:
        raise ValueError(f"n_partitions={p} must be a multiple of the mesh "
                         f"size {ranks}")
    local_p = p // ranks
    me = 0 if group is None else dist.get_rank(group)
    return group, ranks, me * local_p, local_p


def _merge(merge: str):
    if merge not in ("all_gather", "ring"):
        raise ValueError("merge must be all_gather|ring")
    return C.ring_merge_topk if merge == "ring" else C.gather_merge_topk


class ShardedHnswSearcher:
    """Stacked graph-engine partitions (partition.py:598-781): every
    partition's graph padded to the largest capacity and stacked along a
    leading partition axis. :meth:`search` runs the descent and the level-0
    beam on each of this rank's partitions in turn, maps their ids to
    global ids, masks the partitions a query was not routed to and merges
    the lists through :mod:`.collectives`."""

    def __init__(self, parent: PartitionedHnswIndex, mesh=None):
        self.parent = parent
        self.device = parent.device
        (self.group, self.ranks, self.first,
         self.local_p) = _local_partitions(parent.p, mesh)
        self._assemble()

    def _assemble(self):
        parts = self.parent.parts
        mine = parts[self.first:self.first + self.local_p]
        cap = max(s.graph.cap for s in parts)
        cap_u = max(s.graph.cap_upper for s in parts)
        g0, L, dev = parts[0].graph, self.local_p, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        self.cap = cap
        self.vectors = torch.zeros((L, cap + 1, g0.dim),
                                   dtype=g0.vectors.dtype, device=dev)
        self.vectors_sq = torch.zeros((L, cap + 1), dtype=torch.float32,
                                      device=dev)
        self.nbr0 = torch.full((L, cap + 1, g0.neighbors0.shape[1]), cap,
                               **i32)
        self.upn = torch.full((L, cap_u + 1, *g0.upper_nbrs.shape[1:]), cap,
                              **i32)
        self.ups = torch.full((L, cap + 1), cap_u, **i32)
        self.levels = torch.zeros((L, cap + 1), **i32)
        self.deleted = torch.zeros((L, cap + 1), dtype=torch.bool,
                                   device=dev)
        self.gids = torch.full((L, cap + 1), -1, dtype=torch.int64,
                               device=dev)
        for lp, sub in enumerate(mine):
            g = sub.graph
            c, cu = g.cap, g.cap_upper
            # sentinels move from the partition's capacity to the common one
            # (partition.py:645-648); its old trash rows become unreachable
            self.vectors[lp, :c + 1] = g.vectors
            self.vectors_sq[lp, :c + 1] = g.vectors_sq
            self.nbr0[lp, :c + 1] = torch.where(g.neighbors0 == c, cap,
                                                g.neighbors0)
            self.upn[lp, :cu + 1] = torch.where(g.upper_nbrs == c, cap,
                                                g.upper_nbrs)
            self.ups[lp, :c + 1] = torch.where(g.upper_slot == cu, cap_u,
                                               g.upper_slot)
            self.levels[lp, :c + 1] = g.levels
            self.deleted[lp, :c + 1] = g.deleted
            gid = torch.from_numpy(np.asarray(sub._global_ids, np.int64))
            self.gids[lp, :len(gid)] = gid.to(dev)
        # an empty partition's entry (-1) is clamped to 0: its results map
        # to -1 through the padded id table (partition.py:675-683)
        self.entries = [max(s.entry, 0) for s in mine]
        self.entry_levels = [max(s.entry_level, 0) for s in mine]

    def _graph(self, lp: int) -> G.HnswGraph:
        return G.HnswGraph(
            vectors=self.vectors[lp], vectors_sq=self.vectors_sq[lp],
            neighbors0=self.nbr0[lp], upper_nbrs=self.upn[lp],
            upper_slot=self.ups[lp], levels=self.levels[lp],
            deleted=self.deleted[lp])

    def search(self, queries, k: int = 10, ef_search: int = 40,
               route_k: int | None = None, expand: int = 1,
               merge: str = "all_gather", descent_ef: int = 1):
        """Routed search of every local partition (the descent, then the
        level-0 beam with ``max_steps = 2 ef + 16``) and the merge. Returns
        (distances in operator units, global ids) numpy, every rank the
        same."""
        merge_fn = _merge(merge)
        cfg = self.parent.cfg
        queries = np.asarray(queries, np.float32)
        route_k = self.parent.route_k if route_k is None else route_k
        # route with the raw queries: the router's centroids are raw
        routes = self.parent.router.route(queries, route_k)
        if cfg.metric.needs_normalized:
            nrm = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(nrm, 1e-12)
        ef = max(ef_search, k)
        q = torch.from_numpy(queries).to(self.device, self.vectors.dtype)
        pids = self.first + np.arange(self.local_p)
        selected = torch.from_numpy(
            (routes[:, :, None] == pids[None, None, :]).any(1)).to(
                self.device)
        outs_d, outs_i = [], []
        for lp in range(self.local_p):
            g = self._graph(lp)
            seeds = _descend_body(g, q, self.entries[lp],
                                  self.entry_levels[lp], 0, cfg.metric,
                                  descent_ef=descent_ef)
            pool_d, pool_i = _search_layer_body(
                g, q, seeds, 0, level0=True, ef=ef, expand=expand,
                max_steps=2 * ef + 16, metric=cfg.metric, skip_deleted=True,
                mask_deleted_results=True)
            d, i = pool_d[:, :k], pool_i[:, :k].long()
            glob = self.gids[lp][torch.clamp(i, 0, self.cap)]
            sel = selected[:, lp:lp + 1]
            glob = torch.where(sel & (i != self.cap), glob, -1)
            d = torch.where(sel & (glob >= 0), d, torch.inf)
            outs_d.append(d)
            outs_i.append(glob)
        nq = q.shape[0]
        d = torch.stack(outs_d, 1).reshape(nq, -1)
        i = torch.stack(outs_i, 1).reshape(nq, -1)
        with annotate("ici_merge"):
            d, i = merge_fn(d, i, k, self.group,
                            dedup=self.parent.has_replicas)
        return (D.score_to_distance(d, cfg.metric).cpu().numpy(),
                i.cpu().numpy())


class ShardedBlockSearcher:
    """Stacked block-engine partitions (partition.py:783-1483): every
    partition's blocks padded to the largest block count ``b`` and stacked
    along a leading partition axis, block ids stored as global ids.

    One search batches the partition axis: one GEMM of the queries against
    the ``[P*b, d]`` centroids, viewed as ``[Q, P, b]`` with the padded
    columns of each partition at +inf and the block engine's route top-k
    (top-``probes``) per (query, partition); then ONE stage-1
    ``expand_topr`` launch over the stacked scoring copy ``[P*b, S, dp]``
    with ``Q*P`` virtual queries (query-major), whose top-r per virtual
    query is the reference's per-partition stage 1; one gather and f32
    rerank giving ``[Q, P*k]`` in partition order; the routed mask; the
    merge through :mod:`.collectives` (local with one process, a
    collective across ranks).

    Partitions must have empty spill tails (``compact()`` folds them in).
    The reference's "unstacked" mode, for XLA's 2^31-element buffer limit,
    is not carried: torch has no such limit.
    """

    def __init__(self, parent: PartitionedHnswIndex, mesh=None):
        self.parent = parent
        self.device = parent.device
        (self.group, self.ranks, self.first,
         self.local_p) = _local_partitions(parent.p, mesh)
        self._assemble()

    def _assemble(self):
        """Copy this rank's partitions into stacked tensors allocated once
        (partition.py:822-917): an empty partition is all dead blocks, and
        a bf16 scoring copy that aliases its blocks stays one tensor."""
        parts = self.parent.parts
        for p, sub in enumerate(parts):
            if sub.tail_n:
                raise ValueError(
                    f"partition {p} has {sub.tail_n} uncompacted tail rows; "
                    "run compact() before sharding")
        ref = next((s for s in parts if s.n_blocks), None)
        if ref is None:
            raise ValueError("every partition is empty")
        mine = parts[self.first:self.first + self.local_p]
        b = max(s.n_blocks for s in parts)
        alias = all(s.blocks_score is s.blocks for s in parts if s.n_blocks)
        self._alloc(ref.block_size, b, ref.blocks.dtype,
                    None if alias else ref.blocks_score.dtype,
                    ref.blocks_score.shape[2], ref.score_scale is not None)
        for lp, sub in enumerate(mine):
            B = sub.n_blocks
            if B == 0:
                continue
            self.blocks[lp, :B] = sub.blocks
            if not alias:
                self.blocks_score[lp, :B] = sub.blocks_score
            self.blocks_sq[lp, :B] = sub.blocks_sq
            self.centroids[lp, :B] = sub.centroids
            self.centroids_sq[lp, :B] = sub.centroids_sq
            if sub.score_scale is not None:
                self.score_scales[lp, :B] = sub.score_scale
            gmap = torch.from_numpy(
                np.asarray(sub._global_ids, np.int32)).to(self.device)
            bi = sub.block_ids.long()
            self.block_gids[lp, :B] = torch.where(
                bi >= 0, gmap[torch.clamp(bi, 0, gmap.numel() - 1)], -1)
        self._finish([s.n_blocks for s in mine],
                     max(s.n_blocks for s in parts), ref.two_stage,
                     ref.rerank_width)

    def _alloc(self, S: int, b: int, dtype, score_dtype, dp: int,
               has_scale: bool) -> None:
        """Zeroed stacked tensors for this rank's partitions; block ids -1
        (dead) and scales 1. ``score_dtype`` None aliases the blocks."""
        L, d, dev = self.local_p, self.parent.cfg.dim, self.device
        self.blocks = torch.zeros((L, b, S, d), dtype=dtype, device=dev)
        self.blocks_score = (self.blocks if score_dtype is None else
                             torch.zeros((L, b, S, dp), dtype=score_dtype,
                                         device=dev))
        self.blocks_sq = torch.zeros((L, b, S), dtype=torch.float32,
                                     device=dev)
        self.block_gids = torch.full((L, b, S), -1, dtype=torch.int32,
                                     device=dev)
        self.centroids = torch.zeros((L, b, d), dtype=dtype, device=dev)
        self.centroids_sq = torch.zeros((L, b), dtype=torch.float32,
                                        device=dev)
        self.score_scales = (torch.ones((L, b), dtype=torch.float32,
                                        device=dev) if has_scale else None)

    def _finish(self, n_blocks: list, max_blocks: int, two_stage: bool,
                rerank_width: int) -> None:
        """Each partition's live centroid count and the serving options."""
        b = self.blocks.shape[1]
        dev = self.device
        self._max_blocks = max(max_blocks, 1)
        # each partition's live centroids: the columns past them are never
        # routed to (block.py:303-304); None when no partition has padding
        self._live = (torch.tensor(n_blocks, dtype=torch.int32, device=dev)
                      if min(n_blocks) < b else None)
        self.two_stage = bool(two_stage)
        self.rerank_width = int(rerank_width)
        self._router_centroids = None

    # --------------------------------------------------------------- loading
    @classmethod
    def from_saved(cls, path: str, mesh=None, chunk_bytes: int = 1 << 27,
                   device=None,
                   score_dtype: str | None = None) -> "ShardedBlockSearcher":
        """The stacked state straight from a saved directory (either
        package's layout; partition.py:919-1213), with bounded device
        memory: the stacked tensors are allocated once, and each part's
        ``blocks.bin`` is streamed through ``np.memmap`` one slab of
        ``chunk_bytes`` (as f32) at a time; each slab's squared norms,
        centroids and scoring copy (int8 with per-block scales, or bf16) are
        derived on the device in the same pass. Peak device memory is the
        serving bytes plus two slabs (the slab in f32 and one temporary).
        The B axis is padded to whole slabs, so every slab has one shape.
        ``score_dtype`` ("int8" | "bf16") names the scoring copy; None takes
        the first part's ``meta.json``, else "int8" (the reference's
        directories hold none: it reads ``TPU_HNSW_SCORE_DTYPE`` when it
        loads, partition.py:962). A bf16 copy of bf16 rows aliases them.

        The searcher's parent is a skeleton of metadata (its partitions
        hold counts and id maps, no tensors) and is released from the start:
        serving, ``probes_for_ef`` and ``stats`` work, per-partition search
        and DML raise."""
        score_dtype = _check_score_dtype(score_dtype)
        with open(os.path.join(path, "partitioned.json")) as f:
            meta = json.load(f)
        if meta.get("engine", "graph") != "block":
            raise ValueError("from_saved serves block-engine partitions only")
        p = int(meta["p"])
        part_meta = []
        for i in range(p):
            with open(os.path.join(path, f"part{i}", "meta.json")) as f:
                part_meta.append(json.load(f))
        c = dict(part_meta[0]["config"])
        c["metric"] = Metric(c["metric"])
        cfg = HnswConfig(**c)
        S, d = int(part_meta[0]["block_size"]), cfg.dim
        parent = PartitionedHnswIndex(
            cfg, p, router=meta["router"], route_k=meta.get("route_k", 0),
            engine="block", block_size=S, device=device)
        if meta["router"] == "centroid":
            parent.router.centroids = np.load(
                os.path.join(path, "router.npz"))["centroids"]
        parent.n = int(meta["n"])
        parent.multi_assign_frac = float(meta.get("multi_assign_frac", 0.0))
        parent.has_replicas = bool(meta.get("has_replicas", False))
        for i, m in enumerate(part_meta):
            stub = BlockHnswIndex(cfg, block_size=S,
                                  block_slack=m.get("block_slack", 1.05),
                                  device=parent.device)
            stub.n, stub.n_total = int(m["n"]), int(m["n_total"])
            stub.n_blocks = int(m["n_blocks"])
            stub.score_dtype = score_dtype or m.get("score_dtype", "int8")
            gp = os.path.join(path, f"part{i}", "global_ids.npy")
            stub._global_ids = (np.load(gp) if os.path.exists(gp) else
                                np.arange(stub.n_total, dtype=np.int32))
            parent.parts.append(stub)
        parent._released = True

        self = cls.__new__(cls)
        self.parent, self.device = parent, parent.device
        (self.group, self.ranks, self.first,
         self.local_p) = _local_partitions(p, mesh)
        b_max = max(max(s.n_blocks for s in parent.parts), 1)
        slab = max(1, min(chunk_bytes // max(S * d * 4, 1), b_max))
        b_pad = -(-b_max // slab) * slab
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        score = parent.parts[0].score_dtype
        score_t = torch.int8 if score == "int8" else torch.bfloat16
        dp = _score_width(d, score_t)
        alias = score_t == torch.bfloat16 == dtype and dp == d
        self._alloc(S, b_pad, dtype, None if alias else score_t, dp,
                    score == "int8")
        for lp in range(self.local_p):
            i = self.first + lp
            part = os.path.join(path, f"part{i}")
            z = np.load(os.path.join(part, "blocks.npz"))
            bb = part_meta[i].get("blocks_bin")
            if bb is not None:  # raw blob: read one slab at a time
                raw = np.memmap(os.path.join(part, "blocks.bin"),
                                dtype=np.dtype(bb["dtype"]), mode="r",
                                shape=tuple(bb["shape"]))
            else:  # the reference's older layout: blocks inside the npz
                raw = z["blocks"]
            bids = z["block_ids"]
            gmap = np.asarray(parent.parts[i]._global_ids, np.int32)
            B = raw.shape[0]
            if B:
                self.block_gids[lp, :B] = torch.from_numpy(np.where(
                    bids >= 0, gmap[np.clip(bids, 0, len(gmap) - 1)],
                    -1).astype(np.int32)).to(self.device)
            for s0 in range(0, B, slab):
                self._install_slab(lp, s0, raw[s0:s0 + slab],
                                   bids[s0:s0 + slab] >= 0, slab)
        ref = parent.parts[0]
        self._finish([parent.parts[self.first + lp].n_blocks
                      for lp in range(self.local_p)], b_max, ref.two_stage,
                     ref.rerank_width)
        return self

    def _install_slab(self, lp: int, s0: int, raw: np.ndarray,
                      live: np.ndarray, slab: int) -> None:
        """One slab of saved blocks into partition ``lp`` from block ``s0``:
        the rows (dead rows zero), their squared norms, the centroids (the
        mean of the live rows in f32, stored in the rows' dtype, with the
        f32 squared norm) and the scoring copy, as ``_set_blocks`` and
        ``_make_score_copy`` derive them. A short last slab is zero-padded
        to ``slab`` blocks. Device memory: the slab in f32 and one
        slab-sized temporary."""
        nb = raw.shape[0]
        raw = np.array(raw)  # the slab read into host memory, writable
        if raw.dtype == np.uint16:  # bf16 saved as its bits
            host = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        else:
            host = torch.from_numpy(raw)
        alive = torch.from_numpy(np.ascontiguousarray(live))
        if nb < slab:
            host = torch.cat([host, host.new_zeros((slab - nb,
                                                    *host.shape[1:]))])
            alive = torch.cat([alive, alive.new_zeros((slab - nb,
                                                       alive.shape[1]))])
        sl = slice(s0, s0 + slab)
        alive = alive.to(self.device)
        sf = host.to(self.device).float()
        sf.masked_fill_(~alive[:, :, None], 0.0)
        self.blocks[lp, sl] = sf
        self.blocks_sq[lp, sl] = (sf * sf).sum(-1)
        counts = torch.clamp_min(alive.float().sum(1), 1.0)
        cents = sf.sum(1) / counts[:, None]
        self.centroids[lp, sl] = cents
        self.centroids_sq[lp, sl] = (cents * cents).sum(-1)
        d = sf.shape[2]
        if self.score_scales is not None:
            # quantised in place: the slab and one temporary at most
            scl = torch.clamp_min(sf.abs().amax(dim=(1, 2)), 1e-30) / 127.0
            sf.div_(scl[:, None, None]).round_().clamp_(-127, 127)
            self.blocks_score[lp, sl, :, :d] = sf  # integral: cast exact
            self.score_scales[lp, sl] = scl
        elif self.blocks_score is not self.blocks:
            self.blocks_score[lp, sl, :, :d] = sf

    def release_parts_device_state(self) -> None:
        """Drop the partitions' own device tensors once the stacked state
        exists: they are the same bytes twice (partition.py:1215-1230). The
        parent keeps its host metadata; its per-partition search, DML and
        save raise afterwards."""
        for sub in self.parent.parts:
            for name in ("blocks", "blocks_score", "blocks_sq", "block_ids",
                         "centroids", "centroids_sq", "score_scale", "tail",
                         "tail_sq", "tail_ids", "centroid_index",
                         "_filter_cache", "_global_ids_dev"):
                if hasattr(sub, name):
                    setattr(sub, name, None)
        self.parent._released = True

    # ---------------------------------------------------------------- search
    def probes_for_ef(self, ef_search: int) -> int:
        """Blocks a partition probes for an ef (the block engine's
        :func:`~tpu_hnsw_torch.index.block.probes_for_ef`), at most the
        largest partition's block count; partitions with fewer blocks probe
        padded ones, which hold nothing."""
        ref = next(s for s in self.parent.parts if s.n_blocks)
        return probes_for_ef(ef_search, ref.block_size, ref.block_slack,
                             self._max_blocks)

    def _queries(self, queries) -> torch.Tensor:
        """Raw f32 queries on the device (a tensor is not validated)."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
            q = q[None] if q.ndim == 1 else q
        else:
            q = np.asarray(queries, np.float32)
            q = q[None] if q.ndim == 1 else q
            if not np.isfinite(q).all():
                raise ValueError("NaN or infinity values are not allowed")
            q = torch.from_numpy(q).to(self.device)
        if q.shape[1] != self.parent.cfg.dim:
            raise ValueError(f"expected {self.parent.cfg.dim} dimensions, "
                             f"not {q.shape[1]}")
        return q.contiguous()

    def _selected(self, qraw, route_k: int):
        """``[Q, P/R]`` bool: the local partitions each query is routed to,
        computed on the device (partition.py:1232-1264); None when every
        query visits every partition (hash routing, or route_k >= P)."""
        router, p = self.parent.router, self.parent.p
        r = min(route_k or p, p)
        if not isinstance(router, CentroidRouter) or r >= p:
            return None
        if self._router_centroids is None:
            self._router_centroids = torch.from_numpy(
                np.asarray(router.centroids, np.float32)).to(self.device)
        sc = D.pairwise_scores(qraw, self._router_centroids, Metric.L2)
        routes = T.topk_smallest_by_index(sc, r)[1]
        hit = torch.zeros(sc.shape, dtype=torch.bool, device=self.device)
        hit.scatter_(1, routes, True)
        return hit[:, self.first:self.first + self.local_p]

    def _route(self, q, q_sq, selected, probes: int) -> torch.Tensor:
        """``[Q*(P/R), probes]`` stacked block ids, query-major: the probes
        nearest blocks of each (query, local partition) pair from one
        ``route_topk`` over the ``[P/R, b, d]`` centroids, offset into the
        stacked table; -1 where the query is not routed to the partition."""
        L = self.blocks.shape[0]
        nq = q.shape[0]
        with annotate("route", nq):
            # the block engine's own route (block.py:305), each
            # partition's ids offset into the stacked table
            bids = R.route_topk(self.centroids, self.centroids_sq, q, q_sq,
                                probes, self.parent.cfg.metric,
                                live=self._live, offset=True)
            if selected is not None:  # an unrouted partition scans no block
                bids = torch.where(selected[:, :, None], bids, -1)
            return bids.view(nq * L, probes)

    @property
    def _stored(self) -> Stored:
        """The stacked state as ``[L*b, ...]`` views, with the serving
        options, for the block engine's expansion step."""
        L, b, S = self.blocks.shape[:3]
        return Stored(self.blocks.view(L * b, S, -1),
                      self.blocks_score.view(L * b, S, -1),
                      self.blocks_sq.view(L * b, S),
                      self.block_gids.view(L * b, S),
                      (None if self.score_scales is None
                       else self.score_scales.view(-1)),
                      self.two_stage, self.rerank_width)

    def _fan_out(self, q, selected, *, k: int, probes: int):
        """Every local partition's top-k for every query in one batch:
        ``[Q, (P/R)*k]`` raw scores and global ids, partition-major."""
        metric = self.parent.cfg.metric
        L = self.blocks.shape[0]
        nq = q.shape[0]
        q_sq = D.squared_norms(q)
        bids = self._route(q, q_sq, selected, probes)
        with annotate("expand", nq):
            qv = q.repeat_interleave(L, 0)
            qv_sq = q_sq.repeat_interleave(L, 0)
            vals, ids = _expand_step(self._stored, qv, qv_sq, bids, k=k,
                                     metric=metric)
            vals = vals.reshape(nq, L * k)
            ids = ids.reshape(nq, L * k).long()
            if selected is not None:
                vals = torch.where(selected.repeat_interleave(k, 1), vals,
                                   torch.inf)
                ids = torch.where(torch.isfinite(vals), ids, -1)
            return vals, ids

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None, route_k: int | None = None,
                      merge: str = "all_gather"):
        """Routed stacked search and the merge (partition.py:1396-1433):
        (raw scores ``[Q, k]`` ascending, global ids, -1 where missing)
        tensors on the device, every rank the same. Routing uses the raw
        queries; scoring normalises them where the metric needs it."""
        with annotate("search") as span:
            validate_ef_search(max(ef_search, 1))
            merge_fn = _merge(merge)
            metric = self.parent.cfg.metric
            if probes is None:
                probes = self.probes_for_ef(max(ef_search, k))
            probes = max(1, min(int(probes), self.blocks.shape[1]))
            route_k = self.parent.route_k if route_k is None else route_k
            with annotate("queries") as qspan:
                qraw = self._queries(queries)
                span.work = qspan.work = qraw.shape[0]
            selected = self._selected(qraw, route_k)
            q = D.l2_normalize(qraw) if metric.needs_normalized else qraw
            sc, ids = self._fan_out(q, selected, k=k, probes=probes)
            with annotate("ici_merge", qraw.shape[0]):
                return merge_fn(sc, ids, k, self.group,
                                dedup=self.parent.has_replicas)

    def search(self, queries, k: int = 10, ef_search: int = 40,
               probes: int | None = None, route_k: int | None = None,
               merge: str = "all_gather"):
        """:meth:`search_device` as numpy: (distances in operator units,
        global ids)."""
        sc, ids = self.search_device(queries, k=k, ef_search=ef_search,
                                     probes=probes, route_k=route_k,
                                     merge=merge)
        return (D.score_to_distance(sc, self.parent.cfg.metric).cpu().numpy(),
                ids.cpu().numpy())

    def stats(self) -> dict:
        """Bytes of the stacked state on this rank (partition.py:
        1450-1483); an aliased bf16 scoring copy counts once."""
        comp = {name: getattr(self, name).numel()
                * getattr(self, name).element_size()
                for name in ("blocks", "blocks_score", "blocks_sq",
                             "block_gids", "centroids", "centroids_sq")}
        if self.blocks_score is self.blocks:
            comp["blocks_score"] = 0
        total = sum(comp.values())
        n, p = self.parent.n, self.parent.p
        return {
            "n": n,
            "partitions": p,
            "mesh_devices": self.ranks,
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total * self.ranks / max(n, 1), 1),
            "bytes_per_element_per_device": round(total / max(n / p, 1), 1),
        }
