"""Binary-vector support: packing, hamming and jaccard distance (port of
``tpu_hnsw/ops/bitops.py``).

The reference's ``bit`` type distances (upstream ``pgvector:src/bitvec.c``
``hamming_distance``/``jaccard_distance``) over bit-packed 32-bit words.
:class:`BinaryFlatIndex` is the exact scan: on the card its top-k comes
from the fused ``hamming_topk`` kernel (``ops/hamming.py``), hamming and
jaccard, ordered by (distance, id) as the reference's ``lax.top_k``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_hnsw_torch.ops import hamming as H
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.ops.hamming import popcount, words  # noqa: F401
from tpu_hnsw_torch.utils.device import entry_device

# [chunk, N] entries of the distance matrix per query chunk of the
# all-pairs scan (k above the fused top-k's limit): 2^28 int32 is 1 GB
# (268 queries at N = 1M)
_SCAN_CHUNK_ELEMS = 1 << 28
# queries per fused top-k call: its [Q, ranges * k] int64 candidates stay
# within 64 MB (many queries leave one row range per CTA)
_TOPK_CHUNK_Q = 1 << 16
_PACK_CHUNK_ROWS = 1 << 16


def pack_bits(bits):
    """[..., nbits] of {0,1} -> [..., ceil(nbits/32)] 32-bit lanes, bit j of
    word w holding bit 32w + j. A numpy input gives the reference's uint32
    array byte for byte; a tensor gives int32 words with the same bits, on
    its device."""
    if isinstance(bits, torch.Tensor):
        return _pack_bits_tensor(bits)
    bits = np.asarray(bits).astype(np.uint8)
    nbits = bits.shape[-1]
    pad = (-nbits) % 32
    if pad:
        bits = np.concatenate(
            [bits, np.zeros((*bits.shape[:-1], pad), np.uint8)], axis=-1
        )
    b = bits.reshape(*bits.shape[:-1], -1, 32)
    weights = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)
    return (b.astype(np.uint32) * weights).sum(-1).astype(np.uint32)


def _pack_bits_tensor(bits: torch.Tensor) -> torch.Tensor:
    lead, nbits = bits.shape[:-1], bits.shape[-1]
    flat = bits.reshape(-1, nbits)
    W = -(-nbits // 32)
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    out = torch.empty((flat.shape[0], W), dtype=torch.int32,
                      device=bits.device)
    for s in range(0, flat.shape[0], _PACK_CHUNK_ROWS):
        b = torch.nn.functional.pad((flat[s:s + _PACK_CHUNK_ROWS] != 0),
                                    (0, W * 32 - nbits))
        v = (b.reshape(-1, W, 32).to(torch.int64) << shifts).sum(-1)
        out[s:s + _PACK_CHUNK_ROWS] = v.to(torch.int32)  # wraps: same bits
    return out.reshape(*lead, W)


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``<~>`` over packed lanes (last axis)."""
    return popcount(words(a) ^ words(b)).sum(-1, dtype=torch.int32)


def jaccard_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``<%>`` = 1 - |a&b| / |a|b|; NaN when both are empty, as the
    reference's."""
    a, b = words(a), words(b)
    inter = popcount(a & b).sum(-1, dtype=torch.int32)
    union = popcount(a | b).sum(-1, dtype=torch.int32)
    return 1.0 - inter.float() / union.float()


def pairwise_hamming(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[Q, W] x [N, W] -> [Q, N] hamming distances, chunked over N (the
    plain version of the ``hamming_scan`` kernel)."""
    return H.hamming_scan_reference(q, x)


def as_words(a, device) -> torch.Tensor:
    """Packed words (numpy uint32 or an int32/uint32 tensor) -> int32
    tensor on ``device``, the same bits."""
    if isinstance(a, torch.Tensor):
        return words(a).to(device).contiguous()
    a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(device)


class BinaryFlatIndex:
    """Exact binary KNN over packed vectors — hamming (``bit_hamming_ops``)
    or jaccard (``bit_jaccard_ops``). ``packed`` is ``[N, W]`` words (numpy
    uint32 or an int32/uint32 tensor); ``device`` holds the table (default:
    the card; raises without one)."""

    def __init__(self, packed, metric: str = "hamming", device=None):
        if metric not in ("hamming", "jaccard"):
            raise ValueError("metric must be hamming or jaccard")
        self.metric = metric
        self.device = entry_device(device)
        self.packed = as_words(packed, self.device)
        # row popcounts: the kernel's |x| (hamming and jaccard)
        self.pop = H.row_popcount(self.packed)

    @classmethod
    def from_bits(cls, bits, metric: str = "hamming",
                  device=None) -> "BinaryFlatIndex":
        return cls(pack_bits(bits), metric=metric, device=device)

    def search_device(self, q_packed, k: int = 10):
        """(distances f32 ``[Q, k]``, ids int32 ``[Q, k]``) tensors,
        ascending by (distance, id). Up to ``hamming.TOPK_MAX_K`` the fused
        top-k serves; above it, the all-pairs scan."""
        q = as_words(q_packed, self.device)
        pq = H.row_popcount(q)
        if k <= H.TOPK_MAX_K:
            return self._search_fused(q, pq, k)
        return self._search_all_pairs(q, pq, k)

    def _search_fused(self, q, pq, k: int):
        ds, ids = [], []
        for s in range(0, q.shape[0], _TOPK_CHUNK_Q):
            e = s + _TOPK_CHUNK_Q
            d, i = H.hamming_topk(q[s:e], self.packed, pq[s:e], self.pop, k,
                                  self.metric)
            ds.append(d)
            ids.append(i)
        return torch.cat(ds), torch.cat(ids)

    def _search_all_pairs(self, q, pq, k: int):
        """``[chunk, N]`` distance matrices, queries chunked to keep each
        within ``_SCAN_CHUNK_ELEMS``, then the keyed top-k."""
        step = max(1, _SCAN_CHUNK_ELEMS // max(self.packed.shape[0], 1))
        ds, ids = [], []
        for s in range(0, q.shape[0], step):
            h = H.hamming_scan(q[s:s + step], self.packed)
            d, i = T.topk_smallest_by_index(
                H.distances(h, pq[s:s + step], self.pop, self.metric), k)
            ds.append(d)
            ids.append(i.to(torch.int32))
        return torch.cat(ds), torch.cat(ids)

    def search(self, q_packed, k: int = 10):
        """Returns numpy (distances f32 ``[Q, k]``, ids int32 ``[Q, k]``)."""
        d, i = self.search_device(q_packed, k)
        return d.cpu().numpy(), i.cpu().numpy()
