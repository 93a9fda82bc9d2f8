"""Sparse vectors: the ``sparsevec`` type (port of ``tpu_hnsw/ops/sparse.py``).

pgvector's ``sparsevec`` stores (index, value) pairs under a nominal
dimension of up to 1e9 with at most 16,000 nonzeros, with L2, inner
product, cosine and L1 distances and the ``{i1:v1,i2:v2}/dim`` text
format. :class:`SparseVecs` is the host container (numpy, as in the
reference): a batch is padded COO, ``indices [N, K]`` ascending per row
with -1 padding and ``values [N, K]``.

Distances run on a torch device in two lanes:

- the **dense lane**: rows densify onto their joint observed vocabulary
  (the indices that occur, about 3e4 for SPLADE-style vectors whatever the
  nominal dimension) and every distance is one f32 matrix product, when
  that vocabulary has at most 65,536 entries and the metric is not L1;
- the **merge lane**: an index-equality mask per pair ``[Q, B, Kq, Kc]``,
  blocked over the corpus, for any vocabulary and for L1 (which has no
  product form: ``L1(q) + L1(c) + sum over matches of |q_i - c_i| - |q_i|
  - |c_i|``).

:class:`SparseFlatIndex` is the exact oracle. The reference densifies the
whole corpus onto its vocabulary at construction (122 GB at 1M rows x
30,518 coordinates); here the corpus stays padded COO on the device, in
vocabulary-rank space, and each search densifies one row chunk at a time
(a bounded ``[rows, V]`` block, one GEMM) and keeps a running top-k in
the order of a stable argsort: by distance, ties to the lower id.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.utils.device import entry_device

SPARSEVEC_MAX_NNZ = 16000  # upstream bound (sparsevec.c)
SPARSEVEC_MAX_DIM = 1_000_000_000
_DENSE_VOCAB_MAX = 65536  # dense-lane bound on the joint vocabulary
#: index spaces up to this size take a lookup table instead of a binary
#: search (the same answers; 128M coordinates at once take seconds less)
LUT_MAX = 1 << 26
#: f32 elements of one densified corpus chunk ``[rows, V]``
ROW_CHUNK_ELEMS = 1 << 26


def _pad_pow2(n: int, lo: int = 8) -> int:
    p = lo
    while p < n:
        p <<= 1
    return p


def _sorted_rows(a: np.ndarray) -> bool:
    return a.shape[1] < 2 or bool((a[:, 1:] >= a[:, :-1]).all())


def unique_indices(flat: np.ndarray, size: int) -> np.ndarray:
    """``np.unique`` of non-negative ints below ``size`` (int64): a bitmap
    when ``size <= LUT_MAX``."""
    if size <= LUT_MAX:
        seen = np.zeros(max(size, 1), bool)
        seen[flat] = True
        return np.flatnonzero(seen).astype(np.int64)
    return np.unique(flat).astype(np.int64)


class SparseVecs:
    """A batch of sparse vectors (the ``sparsevec[]`` analogue).

    ``indices``, ``values``: ``[N, K]`` padded COO (-1 padding, any order;
    duplicate indices are summed and zero values dropped, as upstream
    stores only nonzeros). ``dim``: the nominal dimension, 1..1e9.
    """

    def __init__(self, indices, values, dim: int):
        if not (0 < dim <= SPARSEVEC_MAX_DIM):
            raise ValueError(
                f"sparsevec cannot have more than {SPARSEVEC_MAX_DIM} "
                "dimensions")
        idx = np.asarray(indices, np.int64)
        val = np.asarray(values, np.float32)
        if idx.shape != val.shape or idx.ndim != 2:
            raise ValueError("indices/values must be matching [N, K] arrays")
        if idx.shape[1] > SPARSEVEC_MAX_NNZ:
            raise ValueError(
                f"sparsevec cannot have more than {SPARSEVEC_MAX_NNZ} "
                "nonzero elements")
        live = idx >= 0
        if (idx[live] >= dim).any():
            raise ValueError("sparsevec index out of bounds")
        if not np.isfinite(val[live]).all():
            raise ValueError("NaN or infinity values are not allowed")
        # canonical form: zeros dropped, rows ascending, duplicates summed
        # into their first entry, -1 padding at the end. A stable sort of a
        # row that is already in order is the identity, so sorted rows skip
        # it (SPLADE corpora arrive sorted).
        val = np.where(live, val, np.float32(0.0))
        idx = np.where(live & (val != 0.0), idx, np.int64(SPARSEVEC_MAX_DIM))
        if not _sorted_rows(idx):
            order = np.argsort(idx, axis=1, kind="stable")
            idx = np.take_along_axis(idx, order, axis=1)
            val = np.take_along_axis(val, order, axis=1)
        dup = idx[:, 1:] == idx[:, :-1]
        if dup.any():
            for k in range(idx.shape[1] - 2, -1, -1):  # right to left
                val[:, k] += np.where(dup[:, k], val[:, k + 1], 0.0)
        keep = np.ones_like(idx, bool)
        keep[:, 1:] = ~dup
        keep &= idx < SPARSEVEC_MAX_DIM
        idx = np.where(keep, idx, -1)
        val = np.where(keep, val, np.float32(0.0))
        # dropped duplicates sink to the padding tail
        key = np.where(idx < 0, SPARSEVEC_MAX_DIM, idx)
        if not _sorted_rows(key):
            order = np.argsort(key, axis=1, kind="stable")
            idx = np.take_along_axis(idx, order, axis=1)
            val = np.take_along_axis(val, order, axis=1)
        self.indices = idx
        self.values = val
        self.dim = int(dim)
        self.n = idx.shape[0]
        self.nnz_max = idx.shape[1]
        # observed vocabulary: vocab[rank] = original index
        self.vocab = unique_indices(self.indices[self.indices >= 0], self.dim)

    # -------------------------------------------------------------- I/O
    @classmethod
    def from_text(cls, lines: list[str] | str) -> "SparseVecs":
        """Parse the upstream text format ``{i1:v1,i2:v2,...}/dim``
        (1-based indices, as in sparsevec_in)."""
        if isinstance(lines, str):
            lines = [lines]
        rows, dims = [], set()
        for s in lines:
            s = s.strip()
            if "/" not in s or not s.startswith("{"):
                raise ValueError(
                    f'invalid input syntax for type sparsevec: "{s}"')
            body, dim_s = s.rsplit("/", 1)
            dims.add(int(dim_s))
            body = body.strip()[1:-1].strip()
            pairs = []
            if body:
                for part in body.split(","):
                    i_s, v_s = part.split(":")
                    pairs.append((int(i_s) - 1, float(v_s)))
            rows.append(pairs)
        if len(dims) != 1:
            raise ValueError("different sparsevec dimensions")
        dim = dims.pop()
        K = _pad_pow2(max((len(r) for r in rows), default=1), lo=1)
        idx = np.full((len(rows), K), -1, np.int64)
        val = np.zeros((len(rows), K), np.float32)
        for r, pairs in enumerate(rows):
            for c, (i, v) in enumerate(pairs):
                idx[r, c], val[r, c] = i, v
        return cls(idx, val, dim)

    def to_text(self) -> list[str]:
        """The upstream text format (1-based indices)."""
        out = []
        for r in range(self.n):
            live = self.indices[r] >= 0
            pairs = ",".join(
                f"{int(i) + 1}:{v:g}"
                for i, v in zip(self.indices[r][live], self.values[r][live]))
            out.append("{" + pairs + "}/" + str(self.dim))
        return out

    @classmethod
    def from_dense(cls, x, dim: int | None = None,
                   nnz_max: int | None = None) -> "SparseVecs":
        """vector -> sparsevec cast (nonzeros become entries)."""
        x = np.asarray(x, np.float32)
        n, d = x.shape
        dim = dim or d
        nz = x != 0.0
        K = nnz_max or max(int(nz.sum(1).max(initial=1)), 1)
        idx = np.full((n, K), -1, np.int64)
        val = np.zeros((n, K), np.float32)
        for r in range(n):
            cols = np.where(nz[r])[0][:K]
            idx[r, : len(cols)] = cols
            val[r, : len(cols)] = x[r, cols]
        return cls(idx, val, dim)

    def to_dense(self) -> np.ndarray:
        """sparsevec -> vector cast; the nominal dimension must be small
        enough to materialise."""
        if self.dim > 4 * _DENSE_VOCAB_MAX:
            raise ValueError(f"dim={self.dim} too large to densify")
        out = np.zeros((self.n, self.dim), np.float32)
        rows = np.repeat(np.arange(self.n), self.nnz_max)
        idx = self.indices.ravel()
        ok = idx >= 0
        out[rows[ok], idx[ok]] = self.values.ravel()[ok]
        return out

    def to_dense_vocab(self) -> np.ndarray:
        """Densify onto the observed vocabulary ``[N, V]`` (rank space):
        exact for every distance within the container."""
        V = len(self.vocab)
        out = np.zeros((self.n, max(V, 1)), np.float32)
        rank = np.searchsorted(self.vocab, np.clip(self.indices, 0, None))
        rows = np.repeat(np.arange(self.n), self.nnz_max)
        ok = self.indices.ravel() >= 0
        out[rows[ok], rank.ravel()[ok]] = self.values.ravel()[ok]
        return out

    def rank_indices(self, other_idx: np.ndarray) -> np.ndarray:
        """Original indices -> this container's vocabulary rank, or -1."""
        other_idx = np.asarray(other_idx, np.int64)
        V = len(self.vocab)
        if V and int(self.vocab[-1]) < LUT_MAX:
            vmax = int(self.vocab[-1])
            lut = np.full(vmax + 1, -1, np.int64)
            lut[self.vocab] = np.arange(V)
            inside = (other_idx >= 0) & (other_idx <= vmax)
            return np.where(inside, lut[np.clip(other_idx, 0, vmax)], -1)
        pos = np.searchsorted(self.vocab, np.clip(other_idx, 0, None))
        pos = np.clip(pos, 0, max(V - 1, 0))
        hit = (other_idx >= 0) & (self.vocab[pos] == other_idx if V
                                  else False)
        return np.where(hit, pos, -1)

    # ------------------------------------------------------------ stats
    def norms(self) -> np.ndarray:
        return np.sqrt((self.values**2).sum(1))

    def l1_norms(self) -> np.ndarray:
        return np.abs(self.values).sum(1)

    def memory_bytes(self) -> int:
        return self.indices.nbytes + self.values.nbytes


# ---------------------------------------------------------------- scoring


def _pairwise_merge(qi, qv, ci, cv, metric: Metric) -> torch.Tensor:
    """Exact distances through per-pair index-equality masks: ``qi/qv
    [Q, Kq]``, ``ci/cv [B, Kc]`` -> ``[Q, B]``. The ``[Q, B, Kq, Kc]`` mask
    is the cost; callers block over B. Indices below 0 never match."""
    eq = ((qi[:, None, :, None] == ci[None, :, None, :])
          & (qi[:, None, :, None] >= 0))
    prod = qv[:, None, :, None] * cv[None, :, None, :]
    ip = torch.where(eq, prod, 0.0).sum((2, 3))
    if metric is Metric.IP:
        return -ip
    q_sq = (qv * qv).sum(1)
    c_sq = (cv * cv).sum(1)
    if metric is Metric.L2:
        return torch.clamp_min(q_sq[:, None] + c_sq[None, :] - 2.0 * ip, 0.0)
    if metric is Metric.COSINE:
        denom = torch.sqrt(q_sq)[:, None] * torch.sqrt(c_sq)[None, :]
        return 1.0 - ip / torch.clamp_min(denom, 1e-30)
    # L1: the disjoint-support sum, corrected on matches
    diff = (qv[:, None, :, None] - cv[None, :, None, :]).abs()
    mag = qv.abs()[:, None, :, None] + cv.abs()[None, :, None, :]
    corr = torch.where(eq, diff - mag, 0.0).sum((2, 3))
    return qv.abs().sum(1)[:, None] + cv.abs().sum(1)[None, :] + corr


def _dense_pairwise(qd, cd, metric: Metric) -> torch.Tensor:
    """Distances of densified rows: one f32 product (TF32 is off)."""
    ip = qd @ cd.T
    if metric is Metric.IP:
        return -ip
    q_sq = (qd * qd).sum(1)
    c_sq = (cd * cd).sum(1)
    if metric is Metric.L2:
        return torch.clamp_min(q_sq[:, None] + c_sq[None, :] - 2.0 * ip, 0.0)
    if metric is Metric.COSINE:
        denom = torch.sqrt(q_sq)[:, None] * torch.sqrt(c_sq)[None, :]
        return 1.0 - ip / torch.clamp_min(denom, 1e-30)
    raise ValueError("L1 takes the merge lane (see sparse_distance)")


def _merge_block(q_n: int, q_k: int, c_k: int, block: int) -> int:
    """Corpus rows per merge-lane block: the ``[Q, B, Kq, Kc]`` mask stays
    near 2^27 elements."""
    pair = max(q_n * q_k * c_k, 1)
    return max(8, min(block, (1 << 27) // pair))


def _densify_onto(s: SparseVecs, vocab: np.ndarray) -> np.ndarray:
    V = max(len(vocab), 1)
    rank = np.searchsorted(vocab, np.clip(s.indices, 0, None))
    rank = np.clip(rank, 0, V - 1)
    ok = (s.indices >= 0).ravel()
    out = np.zeros((s.n, V), np.float32)
    rows = np.repeat(np.arange(s.n), s.nnz_max)
    out[rows[ok], rank.ravel()[ok]] = s.values.ravel()[ok]
    return out


def sparse_distance(q: SparseVecs, c: SparseVecs, metric: Metric = Metric.L2,
                    block: int = 2048, device=None) -> np.ndarray:
    """All-pairs distances ``[q.n, c.n]`` between two sparse batches, on
    ``device`` (default: the card): the dense lane when the joint observed
    vocabulary is bounded and the metric is not L1, else the merge lane
    blocked over ``c``."""
    if q.dim != c.dim:
        raise ValueError(f"different sparsevec dimensions {q.dim} and {c.dim}")
    dev = entry_device(device)
    vocab = np.union1d(q.vocab, c.vocab)
    if metric is not Metric.L1 and len(vocab) <= _DENSE_VOCAB_MAX:
        qd = torch.from_numpy(_densify_onto(q, vocab)).to(dev)
        cd = torch.from_numpy(_densify_onto(c, vocab)).to(dev)
        return _dense_pairwise(qd, cd, metric).cpu().numpy()
    qi = torch.from_numpy(q.indices).to(dev)
    qv = torch.from_numpy(q.values).to(dev)
    block = _merge_block(q.n, q.nnz_max, c.nnz_max, block)
    out = []
    for s in range(0, c.n, block):
        ci = torch.from_numpy(c.indices[s:s + block]).to(dev)
        cv = torch.from_numpy(c.values[s:s + block]).to(dev)
        out.append(_pairwise_merge(qi, qv, ci, cv, metric).cpu().numpy())
    if not out:
        return np.zeros((q.n, 0), np.float32)
    return np.concatenate(out, axis=1)


# ------------------------------------------------------- distance surface


def sparsevec_l2_distance(q: SparseVecs, c: SparseVecs,
                          device=None) -> np.ndarray:
    return np.sqrt(sparse_distance(q, c, Metric.L2, device=device))


def sparsevec_inner_product(q: SparseVecs, c: SparseVecs,
                            device=None) -> np.ndarray:
    return -sparse_distance(q, c, Metric.IP, device=device)


def sparsevec_cosine_distance(q: SparseVecs, c: SparseVecs,
                              device=None) -> np.ndarray:
    return sparse_distance(q, c, Metric.COSINE, device=device)


def sparsevec_l1_distance(q: SparseVecs, c: SparseVecs,
                          device=None) -> np.ndarray:
    return sparse_distance(q, c, Metric.L1, device=device)


class SparseFlatIndex:
    """Exact KNN over sparse vectors: the sparse seqscan, and the oracle of
    :class:`~tpu_hnsw_torch.index.sparse_ann.SparseHnswIndex`.

    The corpus is held on ``device`` (default: the card) as padded COO in
    the rank space of its observed vocabulary. A query coordinate outside
    that vocabulary matches no row: it adds to the query's own norm, which
    the L2 and cosine scores correct for exactly, as the reference does.
    Results are ordered as a stable argsort orders them: by distance, ties
    to the lower id."""

    def __init__(self, data: SparseVecs, metric: Metric = Metric.L2,
                 device=None):
        if metric not in (Metric.L2, Metric.IP, Metric.COSINE, Metric.L1):
            raise ValueError(f"unsupported metric {metric}")
        self.data = data
        self.metric = metric
        self.n = data.n
        self.device = entry_device(device)
        self.V = len(data.vocab)
        self._dense = (self.V <= _DENSE_VOCAB_MAX
                       and metric is not Metric.L1)
        dev = self.device
        self._ranks = torch.from_numpy(
            data.rank_indices(data.indices).astype(np.int32)).to(dev)
        self._vals = torch.from_numpy(data.values).to(dev)
        v = self._vals
        self._c_sq = (v * v).sum(1)
        # the reference's cosine denominator takes the container's norms
        self._c_norm = torch.from_numpy(data.norms()).to(dev)

    def _dense_chunk(self, s: int, e: int) -> torch.Tensor:
        """Rows [s, e) densified onto the vocabulary: ``[e - s, V]``."""
        r = self._ranks[s:e]
        out = torch.zeros((e - s, max(self.V, 1)), dtype=torch.float32,
                          device=self.device)
        # padding adds an exact 0.0 to column 0
        return out.scatter_add_(1, r.clamp_min(0).long(),
                                torch.where(r >= 0, self._vals[s:e], 0.0))

    def _chunk_scores(self, qd, q_sq, oov_sq, q_norm, tq, s: int, e: int
                      ) -> torch.Tensor:
        """Dense-lane scores of the query batch against rows [s, e)."""
        cd = self._dense_chunk(s, e)
        ip = qd @ cd.T
        c_sq = self._c_sq[s:e]
        if self.metric is Metric.IP:
            return -ip  # out-of-vocabulary coordinates never match
        if self.metric is Metric.L2:
            sc = torch.clamp_min(q_sq[:, None] + c_sq[None, :] - 2.0 * ip,
                                 0.0)
            return sc + oov_sq[:, None]
        # cosine, computed as the reference does: against the truncated
        # query norm, then rescaled onto the true one
        cn = torch.sqrt(c_sq)
        trunc = 1.0 - ip / torch.clamp_min(tq[:, None] * cn[None, :], 1e-30)
        ip2 = (1.0 - trunc) * tq[:, None] * cn[None, :]
        denom = q_norm[:, None] * self._c_norm[s:e][None, :]
        return 1.0 - ip2 / torch.clamp_min(denom, 1e-30)

    def search(self, queries: SparseVecs, k: int = 10):
        """Returns (distances ``[Q, k]`` in operator units, ids ``[Q, k]``)
        as numpy."""
        if queries.dim != self.data.dim:
            raise ValueError(
                f"different sparsevec dimensions {queries.dim} and "
                f"{self.data.dim}")
        k = min(k, self.n)
        dev = self.device
        rank = self.data.rank_indices(queries.indices)
        Q = queries.n
        best_d = torch.full((Q, k), torch.inf, device=dev)
        best_i = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
        if self._dense:
            V = max(self.V, 1)
            qd = np.zeros((Q, V), np.float32)
            rows = np.repeat(np.arange(Q), queries.nnz_max)
            ok = (rank >= 0).ravel()
            qd[rows[ok], rank.ravel()[ok]] = queries.values.ravel()[ok]
            oov = np.where(rank < 0, queries.values, np.float32(0.0))
            qd_t = torch.from_numpy(qd).to(dev)
            q_sq = (qd_t * qd_t).sum(1)
            oov_sq = torch.from_numpy((oov**2).sum(1)).to(dev)
            tq = torch.from_numpy(np.sqrt((qd**2).sum(1))).to(dev)
            q_norm = torch.from_numpy(queries.norms()).to(dev)
            step = max(1, ROW_CHUNK_ELEMS // V)
        else:
            qi = torch.from_numpy(rank.astype(np.int32)).to(dev)
            qv = torch.from_numpy(queries.values).to(dev)
            step = _merge_block(Q, queries.nnz_max, self.data.nnz_max, 2048)
        for s in range(0, self.n, step):
            e = min(self.n, s + step)
            if self._dense:
                sc = self._chunk_scores(qd_t, q_sq, oov_sq, q_norm, tq, s, e)
            else:
                sc = _pairwise_merge(qi, qv, self._ranks[s:e],
                                     self._vals[s:e], self.metric)
            ids = torch.arange(s, e, device=dev)[None, :].expand(Q, -1)
            # the running best holds lower ids and comes first: ties keep
            # the lower id, as a stable argsort of the whole row does
            best_d, sel = T.topk_smallest_by_index(
                torch.cat([best_d, sc], 1), k)
            best_i = torch.gather(torch.cat([best_i, ids], 1), 1, sel)
        d = best_d
        if self.metric is Metric.L2:
            d = torch.sqrt(torch.clamp_min(d, 0.0))
        return d.cpu().numpy(), best_i.cpu().numpy()
