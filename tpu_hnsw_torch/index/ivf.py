"""IVFFlat (port of ``tpu_hnsw/index/ivf.py``): k-means list centroids
(``ivfflat.lists``), vectors stored per list, and a probe scan with exact
distances inside the probed lists (``ivfflat.probes``).

The storage is the reference's padded ``[lists, maxlen, d]`` tensor with a
``[lists, maxlen]`` int32 id table (-1 for padding and tombstones), padded
to a multiple of 128 slots as the reference pads it, so the saved files are
the same in both packages. A probe is one ``[Q, maxlen, d]`` gather per
query batch, elementwise f32 scores and a running top-k; every top-k keeps
``lax.top_k``'s order (ties to the lower position), so the ids equal the
reference's. No kernel: the products are torch ops.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import kmeans as KM
from tpu_hnsw_torch.utils.device import entry_device

IVF_DEFAULT_LISTS = 100  # upstream ivfflat default
IVF_DEFAULT_PROBES = 1


def _high_water(ids_np: np.ndarray) -> np.ndarray:
    """Per-list append cursor: the highest live slot + 1 (every slot above
    it is dead or unused, so reusing it cannot clobber a live row)."""
    live = ids_np >= 0
    rev_first = live[:, ::-1].argmax(axis=1)  # 0 when no live in the list
    return np.where(
        live.any(axis=1), ids_np.shape[1] - rev_first, 0
    ).astype(np.int64)


def _probe_search(vecs_by_list, ids_by_list, centroids, q, k: int,
                  probes: int, metric: Metric):
    """The ``probes`` nearest lists of each query (L2 to the centroids),
    then per probe a ``[Q, M, d]`` gather, f32 scores and a running top-k
    (ivf.py:43-71). Returns (scores ``[Q, k]``, ids ``[Q, k]`` int64)."""
    nq = q.shape[0]
    c_sc = D.pairwise_scores(q, centroids, Metric.L2)
    top_lists = T.topk_smallest_by_index(c_sc, probes)[1]  # [Q, probes]
    best_d = torch.full((nq, k), torch.inf, device=q.device)
    best_i = torch.full((nq, k), -1, dtype=torch.int64, device=q.device)
    for p in range(probes):
        lists_p = top_lists[:, p]
        ids = ids_by_list[lists_p].long()  # [Q, M]
        sc = D.batched_scores(q, vecs_by_list[lists_p], metric)
        sc = torch.where(ids < 0, torch.inf, sc)
        vals, sel = T.topk_smallest_by_index(torch.cat([best_d, sc], 1), k)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, sel)
        best_d = vals
    return best_d, best_i


class IvfFlatIndex:
    """CREATE INDEX ... USING ivfflat analogue. ``device`` holds the lists
    (default: the card; raises without one)."""

    #: elements of one probe's ``[Q, maxlen, d]`` gather: queries go
    #: through in slices that keep it near 1 GB of f32
    GATHER_ELEMS = 1 << 28

    def __init__(self, dim: int, metric: Metric = Metric.L2,
                 lists: int = IVF_DEFAULT_LISTS, seed: int = 0,
                 dtype: str = "float32", device=None):
        if lists < 1 or lists > 32768:
            raise ValueError("lists must be in [1, 32768]")  # upstream range
        if dtype not in ("float32", "bfloat16"):
            raise ValueError("dtype must be float32 or bfloat16")
        self.dim = dim
        self.metric = metric
        self.lists = lists
        self.seed = seed
        self.dtype = dtype
        self.device = entry_device(device)
        self._tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.centroids: np.ndarray | None = None
        self.vecs_by_list: torch.Tensor | None = None  # [L, M, d]
        self.ids_by_list: torch.Tensor | None = None   # [L, M] int32
        self.n = 0        # live rows
        self.n_total = 0  # ids ever issued (monotone id space)
        # per-list append cursor (high-water mark): delete() tombstones
        # slots without moving it back, so an add never reuses a slot
        # below a live row
        self._cursor: np.ndarray | None = None  # set by build and load
        self._cdev = None  # centroids on the device, dropped on rebuild

    def _centroids_device(self) -> torch.Tensor:
        if self._cdev is None:
            self._cdev = torch.from_numpy(self.centroids).to(self.device)
        return self._cdev

    def _prep(self, data) -> np.ndarray:
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[None]
        if data.shape[1] != self.dim:
            raise ValueError(
                f"expected {self.dim} dimensions, not {data.shape[1]}")
        if self.metric.needs_normalized:
            data = data / np.maximum(
                np.linalg.norm(data, axis=1, keepdims=True), 1e-12)
        return data

    def build(self, data) -> "IvfFlatIndex":
        """k-means over a sample of ``max(10000, 50 * lists)`` rows (the
        reference's rule), every row assigned, then the lists packed in row
        order on the device."""
        x = torch.from_numpy(self._prep(data)).to(self.device)
        n = x.shape[0]
        cents, assign = KM.kmeans(x, self.lists, iters=10, seed=self.seed,
                                  sample=max(10000, 50 * self.lists))
        self.centroids = cents.cpu().numpy()
        self._cdev = None
        counts = torch.bincount(assign, minlength=self.lists)
        maxlen = max(8, int(counts.max()))
        maxlen = ((maxlen + 127) // 128) * 128
        vecs = torch.zeros((self.lists, maxlen, self.dim), dtype=self._tdt,
                           device=self.device)
        ids = torch.full((self.lists, maxlen), -1, dtype=torch.int32,
                         device=self.device)
        # stable sort by list; a row's slot is its rank in its list's run
        order = torch.sort(assign, stable=True).indices
        a_s = assign[order]
        slot = (torch.arange(n, device=self.device)
                - torch.searchsorted(a_s, a_s))
        vecs[a_s, slot] = x[order].to(self._tdt)
        ids[a_s, slot] = order.to(torch.int32)
        self.vecs_by_list, self.ids_by_list = vecs, ids
        self.n = self.n_total = n
        self._cursor = counts.cpu().numpy().astype(np.int64)
        return self

    def add(self, data) -> np.ndarray:
        """Append rows to their nearest lists (``ivfinsert``), growing the
        lists by multiples of 128 slots as needed. Returns the new ids."""
        if self.centroids is None:
            raise ValueError("build the index before add()")
        x = torch.from_numpy(self._prep(data)).to(self.device)
        count = x.shape[0]
        # torch.argmin, like jnp.argmin, takes the first of equal minima
        assign = D.pairwise_scores(x, self._centroids_device(),
                                   Metric.L2).argmin(dim=1)
        counts = torch.from_numpy(self._cursor).to(self.device)
        add_counts = torch.bincount(assign, minlength=self.lists)
        need = int((counts + add_counts).max())
        maxlen = self.ids_by_list.shape[1]
        if need > maxlen:
            grow = ((need + 127) // 128) * 128 - maxlen
            self.vecs_by_list = torch.nn.functional.pad(
                self.vecs_by_list, (0, 0, 0, grow))
            self.ids_by_list = torch.nn.functional.pad(
                self.ids_by_list, (0, grow), value=-1)
        new_ids = np.arange(self.n_total, self.n_total + count,
                            dtype=np.int32)
        order = torch.sort(assign, stable=True).indices
        a_s = assign[order]
        slot = counts[a_s] + (torch.arange(count, device=self.device)
                              - torch.searchsorted(a_s, a_s))
        self.vecs_by_list[a_s, slot] = x[order].to(self._tdt)
        self.ids_by_list[a_s, slot] = (order + self.n_total).to(torch.int32)
        self._cursor = (counts + add_counts).cpu().numpy()
        self.n += count
        self.n_total += count
        return new_ids

    def delete(self, ids) -> None:
        """Tombstone rows (``ivfbulkdelete``): their slots stop scoring; the
        storage is reclaimed by the next build()."""
        ids = torch.from_numpy(
            np.asarray(ids, np.int64).reshape(-1)).to(self.device)
        kill = torch.isin(self.ids_by_list.long(), ids) & (
            self.ids_by_list >= 0)
        self.n -= int(kill.sum())
        self.ids_by_list = torch.where(kill, -1, self.ids_by_list)

    def _search(self, q: torch.Tensor, k: int, probes: int):
        """Raw (scores, ids) over query slices that bound the gather."""
        if self.centroids is None:
            raise ValueError("index is empty")
        probes = max(1, min(probes, self.lists))
        m = self.ids_by_list.shape[1]
        step = max(1, self.GATHER_ELEMS // (m * self.dim))
        parts = [_probe_search(self.vecs_by_list, self.ids_by_list,
                               self._centroids_device(), q[s:s + step], k,
                               probes, self.metric)
                 for s in range(0, max(q.shape[0], 1), step)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def search(self, queries, k: int = 10, probes: int = IVF_DEFAULT_PROBES):
        """ORDER BY distance LIMIT k: numpy (distances in operator units,
        ids; -1 / +inf where fewer than k rows were probed)."""
        q = torch.from_numpy(self._prep(queries)).to(self.device)
        d, i = self._search(q, k, probes)
        return (D.score_to_distance(d, self.metric).cpu().numpy(),
                i.cpu().numpy())

    def search_device(self, queries, k: int = 10, ef_search: int = 0,
                      probes: int = IVF_DEFAULT_PROBES):
        """The probe scan on a tensor of queries, without a host copy:
        (distances, ids) tensors. ``ef_search`` is accepted and ignored
        (the scan width is ``probes``, upstream ``ivfflat.probes``)."""
        del ef_search
        q = queries.to(self.device, torch.float32)
        if q.ndim == 1:
            q = q[None]
        if self.metric.needs_normalized:
            q = q / torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True),
                                    1e-12)
        d, i = self._search(q, k, probes)
        return D.score_to_distance(d, self.metric), i

    def search_iterative(self, queries, k: int = 10,
                         probes: int = IVF_DEFAULT_PROBES, predicate=None,
                         max_probes: int = 0):
        """Iterative probes (``ivfflat.iterative_scan``): while a filter
        leaves a query short of k results, scan again with doubled probes,
        up to ``max_probes`` (default: every list). ``predicate(ids) ->
        bool mask`` runs on the host."""
        max_probes = max_probes or self.lists
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None]
        nq = q.shape[0]
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        p = max(1, probes)
        while True:
            # the fetch widens with the probes, so a selective filter can
            # still find k passing rows among the fetched ones
            fetch = k if predicate is None else min(max(4 * k, 8 * p), 1000)
            d, ids = self.search(q, k=fetch, probes=p)
            mask = predicate(ids) if predicate is not None else ids >= 0
            mask &= ids >= 0
            for qi in range(nq):
                if done[qi]:
                    continue
                good = np.where(mask[qi])[0][:k]
                if len(good) >= k or p >= max_probes:
                    out_d[qi, : len(good)] = d[qi, good]
                    out_i[qi, : len(good)] = ids[qi, good]
                    done[qi] = True
            if done.all() or p >= max_probes:
                break
            p = min(2 * p, max_probes, self.lists)
        return out_d, out_i

    def save(self, path: str) -> None:
        """``ivf.npz`` (centroids, vecs, ids; bf16 lists as their uint16
        bits) and ``ivf.json``: the reference's files."""
        os.makedirs(path, exist_ok=True)
        if self.dtype == "bfloat16":
            vecs = self.vecs_by_list.view(torch.int16).cpu().numpy().view(
                np.uint16)
        else:
            vecs = self.vecs_by_list.cpu().numpy()
        np.savez(os.path.join(path, "ivf.npz"), centroids=self.centroids,
                 vecs=vecs, ids=self.ids_by_list.cpu().numpy())
        with open(os.path.join(path, "ivf.json"), "w") as f:
            json.dump({"dim": self.dim, "metric": self.metric.value,
                       "lists": self.lists, "seed": self.seed, "n": self.n,
                       "n_total": self.n_total, "dtype": self.dtype}, f)

    @classmethod
    def load(cls, path: str, device=None) -> "IvfFlatIndex":
        with open(os.path.join(path, "ivf.json")) as f:
            m = json.load(f)
        idx = cls(m["dim"], Metric(m["metric"]), m["lists"], m["seed"],
                  dtype=m.get("dtype", "float32"), device=device)
        z = np.load(os.path.join(path, "ivf.npz"))
        idx.centroids = np.asarray(z["centroids"], np.float32)
        raw = z["vecs"]
        if raw.dtype == np.uint16:  # bf16 bits
            vecs = torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
        else:
            vecs = torch.from_numpy(raw).to(idx._tdt)
        idx.vecs_by_list = vecs.to(idx.device)
        idx.ids_by_list = torch.from_numpy(z["ids"].astype(np.int32)).to(
            idx.device)
        idx.n = m["n"]
        idx.n_total = m.get("n_total", m["n"])
        idx._cursor = _high_water(z["ids"])
        return idx
