"""ANN over sparse vectors: the ``sparsevec`` HNSW opclasses (port of
``tpu_hnsw/index/sparse_ann.py``).

pgvector indexes ``sparsevec`` columns through ``sparsevec_l2_ops``,
``sparsevec_ip_ops`` and ``sparsevec_cosine_ops``. As in the reference, the
index splits the work into a dense candidate stage and an exact sparse
rerank:

1. **Candidates in a dense sketch space.** A sparse row becomes
   ``p(x) = sum_k v_k * R[rank(i_k)]``, a Johnson-Lindenstrauss projection
   onto ``proj_dim`` dense coordinates through a Gaussian table ``R`` with
   one row per observed vocabulary rank. The sketches feed an ordinary
   dense engine, :class:`~tpu_hnsw_torch.index.block.BlockHnswIndex`
   (default, bf16 storage) or :class:`~tpu_hnsw_torch.index.hnsw.HnswIndex`,
   which returns ``rerank_k`` candidates.
2. **Exact rerank.** Each candidate's stored coordinates ``[Q, C, K]`` are
   binary-searched in the query's own sorted coordinate list ``[Q, Kq]``
   (``torch.searchsorted``), and matches are multiplied and summed in f32.
   The vocabulary axis never materialises.

``R`` row ``r`` is ``jax.random.normal(fold_in(key(seed), r), (proj_dim,))
/ sqrt(proj_dim)`` in the reference; :mod:`~tpu_hnsw_torch.utils.threefry`
draws the same rows from the same counter-based generator (bits equal,
values within 1e-7). The table is drawn once onto the device and grows by
the new ranks only when :meth:`SparseHnswIndex.add` brings unseen
coordinates, so every stored sketch stays valid (the rank space is
append-only).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index.block import BlockHnswIndex, _sync
from tpu_hnsw_torch.index.hnsw import HnswIndex
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.ops.sparse import LUT_MAX, SparseVecs, unique_indices
from tpu_hnsw_torch.utils import threefry as TF
from tpu_hnsw_torch.utils.device import entry_device

# R is [V, proj_dim] f32 on the device: the observed vocabulary is capped so
# the table stays near 1 GB. SPLADE vocabularies are about 30k.
PROJ_VOCAB_MAX = 1 << 20
#: f32 elements of one gathered ``[rows, K, proj_dim]`` sketch chunk
PROJECT_CHUNK_ELEMS = 1 << 28
#: elements of one ``[queries, C, K]`` rerank chunk
RERANK_CHUNK_ELEMS = 1 << 25


def proj_rows(seed: int, ranks: torch.Tensor, proj_dim: int) -> torch.Tensor:
    """Rows of the Gaussian projection table for ``ranks``, on their
    device: row r depends only on (seed, r), never on the table's size."""
    scale = torch.tensor(np.sqrt(proj_dim).astype(np.float32),
                         device=ranks.device)
    return TF.normal_rows(seed, ranks, proj_dim) / scale


class SparseHnswIndex:
    """HNSW ANN over sparse vectors (``sparsevec_l2_ops`` /
    ``sparsevec_ip_ops`` / ``sparsevec_cosine_ops``), on ``device`` (default:
    the card; raises without one). ``engine``: "block" (default) or "graph";
    ``proj_dim``: the sketch width. Stage times of :meth:`build` land in
    ``build_stats``."""

    def __init__(self, metric: str | Metric = Metric.L2, m: int = 16,
                 ef_construction: int = 64, engine: str = "block",
                 block_size: int = 256, proj_dim: int = 256, seed: int = 0,
                 max_elements: int = 0, device=None):
        metric = Metric(metric) if isinstance(metric, str) else metric
        if metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            # upstream has exactly three sparsevec HNSW opclasses; L1 is a
            # function only
            raise ValueError(
                f"sparse HNSW supports l2/ip/cosine, got {metric}")
        if engine not in ("graph", "block"):
            raise ValueError("engine must be graph or block")
        self.metric = metric
        self.engine = engine
        self.proj_dim = int(proj_dim)
        self.seed = int(seed)
        self.device = entry_device(device)
        # the engine ranks sketches in the index's own metric; cosine rides
        # its normalised-IP path, and the rerank restores exact order
        self.cfg = HnswConfig(dim=self.proj_dim, metric=metric, m=m,
                              ef_construction=ef_construction,
                              dtype="bfloat16", seed=seed,
                              max_elements=max_elements)
        if engine == "graph":
            self.inner = HnswIndex(self.cfg, device=self.device)
        else:
            self.inner = BlockHnswIndex(self.cfg, block_size=block_size,
                                        device=self.device)
        self.dim = 0              # nominal sparsevec dim (set at build)
        self.nnz_max = 0          # stored coordinates per row
        self._vocab = np.zeros(0, np.int64)    # rank -> original index
        self._vsorted = np.zeros(0, np.int64)  # sorted copy for lookup
        self._vperm = np.zeros(0, np.int64)    # sorted position -> rank
        self._lut = None          # original index -> rank, when bounded
        self._R = None            # [ranks drawn, proj_dim] f32 on device
        # rerank store on the device, indexed by engine id: rank-space
        # coordinates, values and squared norms
        self._idx = None          # [cap, K] int32, -1 padding
        self._val = None          # [cap, K] f32
        self._sq = None           # [cap] f32
        self.build_stats: dict = {}

    # -- vocabulary -------------------------------------------------------

    def _lookup(self, flat: np.ndarray) -> np.ndarray:
        """Ranks of original indices ``flat`` (>= 0), -1 where unseen."""
        if len(self._vocab) == 0:
            return np.full(flat.shape, -1, np.int64)
        size = max(self.dim, int(self._vsorted[-1]) + 1)
        if size <= LUT_MAX:
            if self._lut is None or len(self._lut) != size:
                self._lut = np.full(size, -1, np.int64)
                self._lut[self._vocab] = np.arange(len(self._vocab))
            return np.where(flat < size, self._lut[np.clip(flat, 0, size - 1)],
                            -1)
        pos = np.searchsorted(self._vsorted, flat)
        pos = np.clip(pos, 0, len(self._vsorted) - 1)
        return np.where(self._vsorted[pos] == flat, self._vperm[pos], -1)

    def _rank_of(self, indices: np.ndarray, *, extend: bool) -> np.ndarray:
        """Original indices -> rank space. ``extend`` (build/add) appends
        unseen coordinates in ascending order; otherwise (queries) they map
        to -1: out-of-vocabulary mass matches nothing in the corpus."""
        flat = indices.ravel()
        live = flat >= 0
        if extend:
            seen = unique_indices(flat[live], max(self.dim, 1))
            unseen = seen[self._lookup(seen) < 0]
            if len(unseen):
                if len(self._vocab) + len(unseen) > PROJ_VOCAB_MAX:
                    raise ValueError(
                        f"observed vocabulary exceeds {PROJ_VOCAB_MAX}; "
                        "use SparseFlatIndex (exact merge path) instead")
                self._set_vocab(np.concatenate([self._vocab, unseen]))
        out = np.where(live, self._lookup(np.clip(flat, 0, None)), -1)
        return out.reshape(indices.shape)

    def _set_vocab(self, vocab: np.ndarray) -> None:
        self._vocab = vocab.astype(np.int64)
        order = np.argsort(self._vocab, kind="stable")
        self._vsorted = self._vocab[order]
        self._vperm = order
        self._lut = None

    # -- sketching --------------------------------------------------------

    def _table(self) -> torch.Tensor:
        """R on the device, extended to every rank of the vocabulary by the
        new rows only."""
        V = len(self._vocab)
        have = 0 if self._R is None else self._R.shape[0]
        if V > have or self._R is None:
            new = proj_rows(self.seed, torch.arange(
                have, max(V, 1), dtype=torch.int64, device=self.device),
                self.proj_dim)
            self._R = new if self._R is None else torch.cat([self._R, new])
        return self._R

    def _project(self, ranks: torch.Tensor, vals: torch.Tensor
                 ) -> torch.Tensor:
        """JL sketch of rank-space rows on the device: ``[N, K]`` ->
        ``[N, proj_dim]`` f32, a gather of R rows and a weighted sum (exact
        f32: the package keeps TF32 off)."""
        R = self._table()
        N, K = ranks.shape
        out = torch.empty((N, self.proj_dim), dtype=torch.float32,
                          device=self.device)
        step = max(1, PROJECT_CHUNK_ELEMS // max(K * self.proj_dim, 1))
        for s in range(0, N, step):
            r = ranks[s:s + step]
            w = torch.where(r >= 0, vals[s:s + step], 0.0)
            rows = R[r.clamp_min(0).long()]                # [c, K, D]
            out[s:s + step] = torch.bmm(w[:, None, :], rows)[:, 0]
        return out

    # -- rerank store -----------------------------------------------------

    def _store_rows(self, ids: np.ndarray, ranks: torch.Tensor,
                    vals: torch.Tensor, sq: np.ndarray) -> None:
        K = ranks.shape[1]
        if self.nnz_max and K != self.nnz_max:
            if K > self.nnz_max:
                raise ValueError(
                    f"rows with {K} nonzeros exceed this index's "
                    f"nnz budget {self.nnz_max} (fixed at build)")
            pad = self.nnz_max - K
            ranks = torch.nn.functional.pad(ranks, (0, pad), value=-1)
            vals = torch.nn.functional.pad(vals, (0, pad))
            K = self.nnz_max
        hi = int(ids.max()) + 1
        dev = self.device
        if self._idx is None:
            cap = max(hi, 1024)
            self._idx = torch.full((cap, K), -1, dtype=torch.int32,
                                   device=dev)
            self._val = torch.zeros((cap, K), dtype=torch.float32,
                                    device=dev)
            self._sq = torch.zeros(cap, dtype=torch.float32, device=dev)
        elif self._idx.shape[0] < hi:
            cap = max(hi, self._idx.shape[0] * 2)
            for name, fill in (("_idx", -1), ("_val", 0.0), ("_sq", 0.0)):
                a = getattr(self, name)
                grown = torch.full((cap, *a.shape[1:]), fill, dtype=a.dtype,
                                   device=dev)
                grown[: a.shape[0]] = a
                setattr(self, name, grown)
        ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
        self._idx[ids_t] = ranks.to(torch.int32)
        self._val[ids_t] = vals
        self._sq[ids_t] = torch.from_numpy(sq).to(dev)

    def _upload_rows(self, data: SparseVecs, ranks: np.ndarray):
        """(ranks int32, values f32, squared norms numpy) of host rows: the
        norms as the reference sums them, on the host."""
        dev = self.device
        r = torch.from_numpy(ranks.astype(np.int32))
        v = torch.from_numpy(data.values)
        if dev.type == "cuda":
            r, v = r.pin_memory(), v.pin_memory()
        sq = (data.values * data.values).sum(1)
        return (r.to(dev, non_blocking=True), v.to(dev, non_blocking=True),
                sq)

    # -- lifecycle --------------------------------------------------------

    @property
    def n(self) -> int:
        return self.inner.n

    def build(self, data: SparseVecs, **kw) -> "SparseHnswIndex":
        """CREATE INDEX: rank map (host), projection (device), the dense
        engine's build over the sketches, and the rerank store."""
        dev = self.device
        t0 = time.perf_counter()
        self.dim = data.dim
        self.nnz_max = data.nnz_max
        ranks = self._rank_of(data.indices, extend=True)
        t1 = time.perf_counter()
        r, v, sq = self._upload_rows(data, ranks)
        proj = self._project(r, v)
        _sync(dev)
        t2 = time.perf_counter()
        self.inner.build(proj, **kw)
        del proj
        _sync(dev)
        t3 = time.perf_counter()
        self._store_rows(np.arange(data.n), r, v, sq)
        _sync(dev)
        t4 = time.perf_counter()
        self.build_stats = {
            "rank_map_s": round(t1 - t0, 3),
            "projection_s": round(t2 - t1, 3),
            "inner_build_s": round(t3 - t2, 3),
            "store_upload_s": round(t4 - t3, 3),
            "total_s": round(t4 - t0, 3),
            "rows_per_sec": round(data.n / max(t4 - t0, 1e-9), 1),
        }
        return self

    def add(self, data: SparseVecs) -> np.ndarray:
        """INSERT: unseen coordinates extend the vocabulary (and R by their
        rows only); returns the new rows' ids."""
        if data.dim != self.dim:
            raise ValueError(
                f"different sparsevec dimensions {data.dim} and {self.dim}")
        ranks = self._rank_of(data.indices, extend=True)
        r, v, sq = self._upload_rows(data, ranks)
        proj = self._project(r, v).cpu().numpy()
        n0 = self.inner.n
        out = self.inner.add(proj)
        ids = (np.asarray(out) if isinstance(out, np.ndarray)
               else np.arange(n0, n0 + data.n))
        self._store_rows(ids, r, v, sq)
        return ids

    def delete(self, ids) -> None:
        self.inner.delete(ids)

    def compact(self) -> None:
        # both engines keep ids through compaction, so the id-indexed
        # rerank store stays valid
        self.inner.compact()

    # -- search -----------------------------------------------------------

    @staticmethod
    def _query_lists(r: torch.Tensor, v: torch.Tensor):
        """Each uploaded query's coordinates sorted by rank on the device,
        out-of-vocabulary and padding entries pushed past every valid rank
        by a sentinel, with their values."""
        if r.shape[1] == 0:
            r = torch.nn.functional.pad(r, (0, 1), value=-1)
            v = torch.nn.functional.pad(v, (0, 1))
        live = r >= 0
        qr, order = torch.sort(torch.where(live, r, PROJ_VOCAB_MAX + 1),
                               dim=1, stable=True)
        qv = torch.gather(torch.where(live, v, 0.0), 1, order)
        return qr, qv

    def _rerank(self, q_ranks, q_vals, q_sq, cids, k: int):
        """Exact sparse scores of candidates ``cids [Q, C]`` (-1 = none) and
        the top k by (score, candidate position): distances in operator
        units and ids, -1 where fewer than k candidates exist."""
        Q, C = cids.shape
        K = self._idx.shape[1]
        Kq = q_ranks.shape[1]
        safe = cids.clamp_min(0).long()
        out_d, out_i = [], []
        step = max(1, RERANK_CHUNK_ELEMS // max(C * K, 1))
        for s in range(0, Q, step):
            e = min(Q, s + step)
            ci = self._idx[safe[s:e]]                     # [q, C, K]
            cv = self._val[safe[s:e]]
            csq = self._sq[safe[s:e]]
            flat = ci.clamp_min(0).reshape(e - s, C * K)
            qr = q_ranks[s:e]
            pos = torch.searchsorted(qr, flat, out_int32=True)
            pos = pos.clamp(0, Kq - 1).long()
            hit = torch.gather(qr, 1, pos) == flat
            g = torch.where(hit, torch.gather(q_vals[s:e], 1, pos), 0.0)
            g = torch.where(ci >= 0, g.reshape(e - s, C, K), 0.0)
            dot = (g * cv).sum(-1)                        # [q, C] exact f32
            qs = q_sq[s:e, None]
            if self.metric is Metric.L2:
                sc = torch.clamp_min(qs + csq - 2.0 * dot, 0.0)
            elif self.metric is Metric.IP:
                sc = -dot
            else:  # cosine with the true norms
                denom = torch.sqrt(qs) * torch.sqrt(csq)
                sc = 1.0 - dot / torch.clamp_min(denom, 1e-30)
            sc = torch.where(cids[s:e] >= 0, sc, torch.inf)
            d, sel = T.topk_smallest_by_index(sc, k)
            ids = torch.gather(cids[s:e], 1, sel)
            if self.metric is Metric.L2:
                d = torch.sqrt(torch.clamp_min(d, 0.0))
            out_d.append(d)
            out_i.append(torch.where(torch.isfinite(d), ids, -1))
        return torch.cat(out_d), torch.cat(out_i)

    def search(self, queries: SparseVecs, k: int = 10, rerank_k: int = 0,
               **kw):
        """Top-k by exact sparse distance, as numpy (distances in operator
        units: ``<->`` L2, ``<#>`` negative inner product, ``<=>`` cosine;
        ids, -1 where missing). ``kw`` goes to the engine (``ef_search``;
        ``probes`` for the block engine); ``rerank_k`` (default
        ``max(4k, 50)``) is the candidate pool the rerank orders."""
        if queries.dim != self.dim:
            raise ValueError(
                f"different sparsevec dimensions {queries.dim} and "
                f"{self.dim}")
        n = self.inner.n
        k = max(1, min(k, max(n, 1)))
        cand = int(rerank_k) if rerank_k else max(4 * k, 50)
        cand = max(k, min(cand, max(n, k)))
        if self.engine == "graph":
            cand = min(cand, 1000)  # the ef_search range
            kw["ef_search"] = max(kw.get("ef_search", 40), cand)
        ranks = self._rank_of(queries.indices, extend=False)
        r, v, sq = self._upload_rows(queries, ranks)
        proj = self._project(r, v)
        _, cids = self.inner.search_device(proj, k=cand, **kw)
        if self.engine == "graph":
            cids = torch.where(cids == self.inner.graph.sentinel, -1, cids)
        # the full squared norms: out-of-vocabulary mass included
        q_sq = torch.from_numpy(sq).to(self.device)
        qr, qv = self._query_lists(r, v)
        d, ids = self._rerank(qr, qv, q_sq, cids.to(torch.int64), k)
        return d.cpu().numpy(), ids.cpu().numpy().astype(np.int64)

    # -- persistence ------------------------------------------------------

    def save(self, path: str) -> None:
        """The reference's layout: ``inner/`` (the engine's own),
        ``sparse_meta.json`` and ``sparse_store.npz``; either package loads
        what the other saved."""
        os.makedirs(path, exist_ok=True)
        self.inner.save(os.path.join(path, "inner"))
        meta = {
            "metric": self.metric.value, "engine": self.engine,
            "proj_dim": self.proj_dim, "seed": self.seed,
            "dim": self.dim, "nnz_max": self.nnz_max,
            "block_size": getattr(self.inner, "block_size", 0),
        }
        with open(os.path.join(path, "sparse_meta.json"), "w") as f:
            json.dump(meta, f)
        # uncompressed: np.load reads either form, and compressing 1 GB of
        # values costs tens of seconds
        np.savez(
            os.path.join(path, "sparse_store.npz"), vocab=self._vocab,
            idx=self._idx.cpu().numpy(), val=self._val.cpu().numpy(),
            sq=self._sq.cpu().numpy())

    @classmethod
    def load(cls, path: str, device=None) -> "SparseHnswIndex":
        with open(os.path.join(path, "sparse_meta.json")) as f:
            meta = json.load(f)
        sub = os.path.join(path, "inner")
        if meta["engine"] == "graph":
            inner = HnswIndex.load(sub, device=device)
        else:
            inner = BlockHnswIndex.load(sub, device=device)
        idx = cls(metric=meta["metric"], engine=meta["engine"],
                  proj_dim=meta["proj_dim"], seed=meta["seed"],
                  m=inner.cfg.m, ef_construction=inner.cfg.ef_construction,
                  block_size=meta.get("block_size") or 256, device=device)
        idx.inner = inner
        idx.cfg = inner.cfg
        idx.dim = meta["dim"]
        idx.nnz_max = meta["nnz_max"]
        z = np.load(os.path.join(path, "sparse_store.npz"))
        idx._set_vocab(z["vocab"])
        dev = idx.device
        idx._idx = torch.from_numpy(z["idx"].astype(np.int32)).to(dev)
        idx._val = torch.from_numpy(z["val"].astype(np.float32)).to(dev)
        idx._sq = torch.from_numpy(z["sq"].astype(np.float32)).to(dev)
        return idx

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["sparse_vocab"] = int(len(self._vocab))
        s["sparse_nnz_max"] = int(self.nnz_max)
        s["sparse_proj_dim"] = self.proj_dim
        if self._idx is not None:
            s["sparse_store_bytes"] = int(
                sum(t.numel() * t.element_size()
                    for t in (self._idx, self._val, self._sq)))
        if self._R is not None:
            s["sparse_proj_table_bytes"] = int(
                self._R.numel() * self._R.element_size())
        return s
