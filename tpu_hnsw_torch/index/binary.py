"""ANN indexing of binary (``bit``) vectors — hamming and jaccard (port of
``tpu_hnsw/index/binary.py``).

pgvector indexes the ``bit`` type through the ``bit_hamming_ops`` /
``bit_jaccard_ops`` operator classes. As in the reference, bits ride a
dense engine as 0/1 bf16 lanes: the graph engine (``engine="graph"``, the
default: :class:`~tpu_hnsw_torch.index.hnsw.HnswIndex`) or the block engine
(``engine="block"``).

- **Hamming** over bits is squared L2 over their 0/1 encodings, so the
  L2 engines (the graph's exact f32 scores; the block engine's int8 stage
  1 in the ``expand_score`` kernel and exact f32 rerank) return exact
  integer counts while the f32 sums stay below 2^24.
- **Jaccard** has no dense-metric equivalent: the cosine engine over the
  same encoding proposes ``rerank_k`` candidates and an exact packed
  AND/OR popcount rerank orders them.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpu_hnsw_torch.config import HnswConfig, Metric
from tpu_hnsw_torch.index.block import BlockHnswIndex
from tpu_hnsw_torch.index.hnsw import HnswIndex
from tpu_hnsw_torch.ops import bitops
from tpu_hnsw_torch.ops import topk as T


def unpack_bits(packed: np.ndarray, nbits: int) -> np.ndarray:
    """[..., W] uint32 lanes -> [..., nbits] of {0,1} uint8 (inverse of
    :func:`tpu_hnsw_torch.ops.bitops.pack_bits`)."""
    p = np.asarray(packed, dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    bits = (p[..., :, None] >> shifts) & np.uint32(1)
    return bits.reshape(*p.shape[:-1], p.shape[-1] * 32)[..., :nbits].astype(
        np.uint8
    )


class BinaryHnswIndex:
    """ANN over binary vectors (``bit_hamming_ops`` / ``bit_jaccard_ops``).

    Parameters mirror the reference's; ``engine`` picks the graph
    (``"graph"``) or the block engine; ``device`` holds the index. Inputs
    to :meth:`build` / :meth:`add` / :meth:`search` are bit arrays
    ``[N, nbits]`` of {0,1} (any int dtype or bool; :meth:`build` also
    takes a tensor), or packed 32-bit lanes with ``packed=True``.
    """

    def __init__(self, nbits: int, metric: str = "hamming", m: int = 16,
                 ef_construction: int = 64, engine: str = "graph",
                 block_size: int = 256, seed: int = 0,
                 max_elements: int = 0, device=None):
        if metric not in ("hamming", "jaccard"):
            raise ValueError("metric must be hamming or jaccard")
        if engine not in ("graph", "block"):
            raise ValueError("engine must be graph or block")
        self.nbits = int(nbits)
        self.metric = metric
        self.engine = engine
        self.cfg = HnswConfig(
            dim=self.nbits,
            metric=Metric.L2 if metric == "hamming" else Metric.COSINE,
            m=m, ef_construction=ef_construction,
            dtype="bfloat16",  # 0/1 is exact in bf16
            seed=seed, max_elements=max_elements)
        if engine == "graph":
            self.inner = HnswIndex(self.cfg, device=device)
        else:
            self.inner = BlockHnswIndex(self.cfg, block_size=block_size,
                                        device=device)
        # packed rows in id order (int32 words), for the exact jaccard rerank
        self._packed: torch.Tensor | None = None

    # -- encoding ---------------------------------------------------------

    def _bits(self, x, packed: bool):
        """{0,1} uint8 bits: a numpy array, or a tensor where one is given."""
        if packed:
            if isinstance(x, torch.Tensor):
                x = bitops.words(x).cpu().numpy().view(np.uint32)
            return unpack_bits(x, self.nbits)
        if not isinstance(x, torch.Tensor):
            x = np.asarray(x)
        if x.shape[-1] != self.nbits:
            raise ValueError(f"expected {self.nbits} bits, got {x.shape[-1]}")
        if isinstance(x, torch.Tensor):
            return (x != 0).to(torch.uint8)
        return (x != 0).astype(np.uint8)

    def _store_packed(self, ids: np.ndarray, bits) -> None:
        if self.metric != "jaccard" or len(ids) == 0:
            return
        if not isinstance(bits, torch.Tensor):
            bits = torch.from_numpy(bits)
        rows = bitops.pack_bits(bits.to(self.inner.device))
        hi = int(np.max(ids)) + 1
        if self._packed is None or self._packed.shape[0] < hi:
            grown = torch.zeros((hi, rows.shape[1]), dtype=torch.int32,
                                device=rows.device)
            if self._packed is not None:
                grown[:self._packed.shape[0]] = self._packed
            self._packed = grown
        self._packed[torch.from_numpy(np.asarray(ids, np.int64)).to(
            rows.device)] = rows

    # -- index lifecycle --------------------------------------------------

    @property
    def n(self) -> int:
        return self.inner.n

    def build(self, data, packed: bool = False, **kw) -> "BinaryHnswIndex":
        """Index the bits. They reach the device as uint8 and become bf16
        0/1 lanes there (the same values as the reference's host f32 copy,
        without that copy)."""
        bits = self._bits(data, packed)
        if not isinstance(bits, torch.Tensor):
            bits = torch.from_numpy(np.ascontiguousarray(bits))
        self.inner.build(bits.to(self.inner.device), **kw)
        self._store_packed(np.arange(bits.shape[0]), bits)
        return self

    def add(self, data, packed: bool = False) -> np.ndarray:
        bits = self._bits(data, packed)
        if isinstance(bits, torch.Tensor):
            bits = bits.cpu().numpy()
        ids = self.inner.add(bits.astype(np.float32))
        self._store_packed(ids, bits)
        return ids

    def delete(self, ids) -> None:
        self.inner.delete(ids)

    def save(self, path: str) -> None:
        """Inner index + ``binary_meta.json`` + ``packed.npz`` (uint32), the
        reference's layout."""
        os.makedirs(path, exist_ok=True)
        self.inner.save(os.path.join(path, "inner"))
        meta = {"nbits": self.nbits, "metric": self.metric,
                "engine": self.engine,
                "block_size": getattr(self.inner, "block_size", 0)}
        with open(os.path.join(path, "binary_meta.json"), "w") as f:
            json.dump(meta, f)
        if self._packed is not None:
            np.savez(os.path.join(path, "packed.npz"),
                     packed=self._packed.cpu().numpy().view(np.uint32))

    @classmethod
    def load(cls, path: str, device=None) -> "BinaryHnswIndex":
        with open(os.path.join(path, "binary_meta.json")) as f:
            meta = json.load(f)
        idx = cls(meta["nbits"], meta["metric"], engine=meta["engine"],
                  block_size=meta["block_size"] or 256, device=device)
        engine = HnswIndex if meta["engine"] == "graph" else BlockHnswIndex
        idx.inner = engine.load(os.path.join(path, "inner"), device=device)
        idx.cfg = idx.inner.cfg
        pk = os.path.join(path, "packed.npz")
        if os.path.exists(pk):
            idx._packed = bitops.as_words(np.load(pk)["packed"],
                                          idx.inner.device)
        return idx

    @classmethod
    def from_state(cls, nbits: int, metric: str, state: dict,
                   packed=None, block_size: int = 256, seed: int = 0,
                   device=None) -> "BinaryHnswIndex":
        """Serve arrays exported from ``tpu_hnsw``'s block-engine
        BinaryHnswIndex: ``state`` as for :meth:`BlockHnswIndex.from_state`
        of its inner index, ``packed`` its uint32 rerank rows (jaccard)."""
        idx = cls(nbits, metric, engine="block", block_size=block_size,
                  seed=seed, device=device)
        idx.inner = BlockHnswIndex.from_state(idx.cfg, state,
                                              block_size=block_size,
                                              device=device)
        if packed is not None:
            idx._packed = bitops.as_words(packed, idx.inner.device)
        return idx

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["binary_nbits"] = self.nbits
        s["binary_encoding"] = ("0/1 bf16 (2 bytes/bit; the packed flat "
                                "scan is 1/8 byte/bit)")
        return s

    # -- search -----------------------------------------------------------

    def search(self, queries, k: int = 10, packed: bool = False,
               rerank_k: int = 0, **kw):
        """Top-k by exact hamming / exact jaccard distance.

        ``kw`` passes engine knobs through (``ef_search``, ``descent_ef``,
        ``expand`` for the graph engine; ``probes``, ``ef_search`` for the
        block engine).
        For jaccard, ``rerank_k`` (default ``max(4k, 50)``) is the cosine
        candidate pool that the exact popcount rerank re-orders.

        Returns numpy ``(distances [Q, k], ids [Q, k])`` — integer hamming
        counts (as floats) or jaccard in [0, 1]; missing ids are -1 with
        +inf distance.
        """
        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        if packed and np.asarray(queries).dtype == np.int32:
            queries = np.asarray(queries).view(np.uint32)
        qbits = self._bits(np.atleast_2d(queries), packed)
        # uint8 bits to the device, as build sends them; the engine widens
        # them to f32 there
        q = torch.from_numpy(np.ascontiguousarray(qbits)).to(
            self.inner.device)
        graph = self.engine == "graph"
        if self.metric == "hamming":
            if graph:
                kw.setdefault("ef_search", max(40, k))
            d, ids = self.inner.search(q, k=k, **kw)
            # the engine took sqrt of the squared L2 (= hamming)
            return np.where(np.isfinite(d), np.rint(np.square(d)),
                            np.inf), ids
        cand = int(rerank_k) if rerank_k else max(4 * k, 50)
        cand = min(cand, max(self.inner.n, k))
        if graph:
            cand = min(cand, 1000)  # the ef_search range (config.py)
            kw["ef_search"] = max(kw.get("ef_search", 40), cand)
        _, cids = self.inner.search_device(q, k=cand, **kw)
        if graph:  # the graph marks a missing result with its sentinel
            cids = torch.where(cids == self.inner.graph.sentinel, -1, cids)
        qp = bitops.pack_bits(q)
        rows = self._packed[torch.clamp_min(cids, 0).long()]   # [Q, C, W]
        inter = bitops.popcount(qp[:, None, :] & rows).sum(
            -1, dtype=torch.int32)
        union = bitops.popcount(qp[:, None, :] | rows).sum(
            -1, dtype=torch.int32)
        jd = 1.0 - inter.float() / torch.clamp_min(union, 1).float()
        jd = torch.where(cids < 0, torch.inf, jd)
        # lax.top_k's order (binary.py:256): ties to the earlier candidate
        vals, pos = T.topk_smallest_by_index(jd, k)
        ids = torch.where(torch.isfinite(vals), torch.gather(cids, 1, pos), -1)
        return vals.cpu().numpy(), ids.cpu().numpy()
