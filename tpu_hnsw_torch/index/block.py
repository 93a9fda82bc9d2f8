"""BlockHnswIndex — cluster-blocked level 0 (port of
``tpu_hnsw/index/block.py``: exact or graph routing, build and serve).

Vectors are k-means clustered and packed into ``[B, S, d]`` blocks of S
spatially close rows. A query scores the B block centroids (one ``[Q, B]``
GEMM), keeps its ``probes`` nearest blocks, and expands them: every row of
each selected block is scored from a reduced-precision scoring copy (int8
with per-block scales by default, or bf16) by the expand kernel
(``ops/expand.py``), whose fused entry keeps each query's best
``rerank_width`` rows; those are re-scored exactly in f32 from the stored
blocks and the top-k returned.
``two_stage=False`` scores the stored blocks directly.

Above ``EXACT_ROUTING_MAX`` blocks (or with ``routing="graph"``) a query
finds its blocks through an :class:`~tpu_hnsw_torch.index.hnsw.HnswIndex`
over the block centroids instead of scanning them all.

Deletes tombstone rows in place; inserts go to a flat-scanned spill tail
and are folded into blocks by ``compact()``. A filter mask over element
ids is applied on the device, in the kernel, like a dead row. ``save`` /
``load`` use the reference's on-disk layout, so an index saved by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_hnsw_torch.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw_torch.index import flat as FL
from tpu_hnsw_torch.index.hnsw import HnswIndex, _tensor
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import expand as X
from tpu_hnsw_torch.ops import route as R
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import kmeans as KM
from tpu_hnsw_torch.utils.device import entry_device
from tpu_hnsw_torch.utils.profiling import annotate

#: the kernel loads 16 bytes at a time; scoring-copy rows are padded to it
ROW_ALIGN_BYTES = 16
#: stage-1 candidate rows per unit of ef_search (block.py:810-815)
ROWS_PER_EF = 64
# elements of a corpus-sized f32 temporary per step of the install-time
# passes (norms, centroid sums, normalisation): 2^28 f32 is 1 GB
_CHUNK_ELEMS = 1 << 28


def _pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _sync(device: torch.device) -> None:
    """Wait for the device, so a host-clock stage time covers its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pad_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    return x if x.shape[-1] == width else F.pad(x, (0, width - x.shape[-1]))


def _score_width(d: int, dtype: torch.dtype) -> int:
    per = ROW_ALIGN_BYTES // torch.empty(0, dtype=dtype).element_size()
    return -(-d // per) * per


def _quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantisation (block.py:184-188)."""
    scl = torch.clamp_min(x.abs().amax(dim=1), 1e-30) / 127.0
    q8 = torch.clamp(torch.round(x / scl[:, None]), -127, 127).to(torch.int8)
    return q8, scl


def _slots_of(bids, sel, S: int):
    """Positions in the ``[Q, p*S]`` expansion -> flat slots (block*S + s).
    A block id -1 (a probe that scans nothing) reads block 0: its rows
    scored +inf in stage 1, and the caller masks what they give."""
    blk = torch.gather(bids, 1, torch.div(sel, S, rounding_mode="floor"))
    return torch.clamp_min(blk, 0) * S + sel % S


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _stage1(blocks, blocks_sq, block_ids, q, q_sq, bids, metric: Metric,
            r: int, **kw):
    """Each query's ``min(r, p * S)`` best rows of its selected blocks
    (block.py:141, 210-212): (scores ascending, positions in the
    ``[Q, p*S]`` expansion), ordered by (score, position). The fused
    top-r entry where it takes r; else every score and a keyed top-r."""
    if X.fused_topr(r, blocks.shape[1]):
        return X.expand_topr(blocks, blocks_sq, block_ids, q, q_sq, bids,
                             metric, r, **kw)
    return X.topr_of_scores(X.expand_score(
        blocks, blocks_sq, block_ids, q, q_sq, bids, metric, **kw), r)


class Stored(NamedTuple):
    """What one expansion step reads (:func:`_expand_step`): the exact
    blocks ``[B, S, d]``, the scoring copy ``[B, S, dp]`` (int8 with its
    per-block ``scale [B]`` f32, or bf16 with scale None), the rows'
    squared norms ``[B, S]`` f32 and ids ``[B, S]`` int32 (-1 dead/pad),
    whether stage 1 scores the copy and an f32 rerank follows
    (``two_stage``), and the rerank width (at least k is kept)."""
    blocks: torch.Tensor
    score: torch.Tensor
    sq: torch.Tensor
    ids: torch.Tensor
    scale: torch.Tensor | None
    two_stage: bool
    rerank: int


def _expand_step(st: Stored, q, q_sq, bids, *, k: int, metric: Metric,
                 allowed=None):
    """Expand each query's selected blocks ``bids [Q, p]`` (block.py:
    106-237): (raw scores ``[Q, k]`` ascending, ids ``[Q, k]``, -1 padded).
    ``allowed`` ``[B, S]`` bool masks filtered-out rows like dead ones.

    Two-stage: the kernel scores the selected blocks from the scoring copy
    and keeps the best ``r = max(rerank, k)`` rows per query, which are
    re-scored exactly in f32 from the stored blocks, and the top-k is
    returned; ``allowed`` masks stage 1 in the kernel and the rerank
    again, since when fewer than r allowed rows exist top-r still hands
    back disallowed positions. Single-stage: the kernel scores the stored
    blocks and keeps the top-k.

    Stage 1 (the kernel) and the rerank (gather, exact scores, top-k) are
    regions of their own; the query's padding and quantisation before them
    and the id gather after them stay in the caller's: a traced range gets
    its device extent from the kernels launched directly in it, so these
    keep the caller's ``expand`` range around both regions' kernels."""
    nq, p = bids.shape
    S = st.ids.shape[1]
    if not st.two_stage:
        vals, sel = _stage1(st.blocks, st.sq, st.ids, q, q_sq, bids, metric,
                            k, allowed=allowed)
        ids = st.ids.reshape(-1)[_slots_of(bids, sel, S)]
        return vals, torch.where(torch.isfinite(vals), ids, -1)
    r = min(max(st.rerank, k), p * S)
    qp = _pad_cols(q, st.score.shape[2])  # zero columns: the same dots
    kw = {"allowed": allowed}
    if st.scale is not None:
        q8, q_scl = _quantize_rows(qp)
        kw.update(q8=q8, q_scale=q_scl, score_scale=st.scale)
    with annotate("stage1", nq * p):
        _, sel = _stage1(st.score, st.sq, st.ids, qp, q_sq, bids, metric, r,
                         **kw)
    with annotate("rerank", nq * r):
        slots = _slots_of(bids, sel, S)
        cand_ids = st.ids.reshape(-1)[slots]
        v = st.blocks.reshape(-1, st.blocks.shape[-1])[slots].float()
        dots2 = (v @ q[:, :, None])[..., 0]
        if metric is Metric.L2:
            vsq = (v * v).sum(-1)
            sc2 = torch.clamp_min(q_sq[:, None] + vsq - 2.0 * dots2, 0.0)
        else:
            sc2 = -dots2
        dead = cand_ids < 0
        if allowed is not None:
            dead |= ~allowed.reshape(-1)[slots]
        sc2 = torch.where(dead, torch.inf, sc2)
        # lax.top_k's order (block.py:232): ties to the earlier candidate
        vals, sel2 = T.topk_smallest_by_index(sc2, k)
    ids = torch.gather(cand_ids, 1, sel2)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def probes_for_ef(ef_search: int, block_size: int, block_slack: float,
                  most: int) -> int:
    """Map the ef_search GUC onto a block-probe count (block.py:810-815,
    partition.py:1266-1277): ``ROWS_PER_EF`` scanned rows per unit of ef,
    compensated for block slack, clamped to ``[1, most]``."""
    p = math.ceil(ROWS_PER_EF * ef_search / block_size)
    p += int((block_slack - 1) * p + 0.5)
    return max(1, min(p, most))


def _route_exact_sorted(centroids, c_sq, q, q_sq, *, p: int, metric: Metric):
    """Fully sorted top-p block ranking (block.py:314-333): prefix-consistent,
    so iterative scans expand column slices ``[p_prev, p)`` of one ranking.
    ``lax.top_k``'s order: ties to the lower block."""
    return T.topk_smallest_by_index(
        R.centroid_scores(centroids, c_sq, q, q_sq, metric), p)[1]


def _scan_tail(tail, tail_sq, tail_ids, q, q_sq, allowed_tail=None, *,
               k: int, metric: Metric):
    """Exact scan of the spill tail ``[T, d]`` (block.py:337-357): raw scores
    ``[Q, k]`` ascending and ids, +inf / -1 padded past the live rows."""
    dots = q.to(tail.dtype).float() @ tail.float().T
    if metric is Metric.L2:
        sc = torch.clamp_min(q_sq[:, None] + tail_sq[None, :] - 2.0 * dots,
                             0.0)
    else:
        sc = -dots
    dead = tail_ids < 0
    if allowed_tail is not None:
        dead |= ~allowed_tail
    sc = torch.where(dead[None, :], torch.inf, sc)
    kk = min(k, tail.shape[0])
    vals, sel = T.topk_smallest_by_index(sc, kk)
    ids = torch.where(torch.isfinite(vals), tail_ids[sel], -1)
    if kk < k:
        vals = F.pad(vals, (0, k - kk), value=torch.inf)
        ids = F.pad(ids, (0, k - kk), value=-1)
    return vals, ids


# ---------------------------------------------------------------------------
# balanced block assignment
# ---------------------------------------------------------------------------


def _top_blocks_chunk(x, x_sq, cents, c_sq, *, t: int, full=None):
    """Top-t nearest block centroids per row (L2), skipping blocks marked
    ``full`` (block.py:365-386). Returns (distances, block ids) ``[chunk, t]``."""
    sc = x_sq[:, None] + c_sq[None, :] - 2.0 * (x @ cents.T)
    if full is not None:
        sc = torch.where(full[None, :], torch.inf, sc)
    return T.topk_smallest_fast(sc, t)


def _assign_rounds_device(cand_i, cand_d, assign, free, *, B: int):
    """Capacity-greedy rounds (block.py:389-421): round r ranks each block's
    round-r proposals by distance (a stable sort by block, then distance)
    and accepts up to the block's remaining capacity. Updates ``assign``
    and ``free`` in place (their only owner is the caller's loop)."""
    n, t = cand_i.shape
    iota = torch.arange(n, device=assign.device)
    blocks = torch.arange(B, device=assign.device)
    for r in range(t):
        ok = (assign < 0) & torch.isfinite(cand_d[:, r])
        blk = torch.where(ok, cand_i[:, r], B)
        dist = torch.where(ok, cand_d[:, r], torch.inf)
        by_dist = torch.argsort(dist, stable=True)
        rows = by_dist[torch.argsort(blk[by_dist], stable=True)]
        sb = blk[rows]
        starts = torch.searchsorted(sb, blocks)
        sbc = torch.clamp(sb, 0, B - 1)
        rank = iota - starts[sbc]
        acc = (sb < B) & (rank < free[sbc])
        # each row appears once, so this never regresses an assigned row
        assign[rows] = torch.maximum(assign[rows], torch.where(acc, sb, -1))
        free -= torch.zeros_like(free).index_add_(0, sbc, acc.to(free.dtype))


def _leftover_fill_device(assign, free, *, B: int):
    """Distance-agnostic fill of rows whose every candidate block filled
    (block.py:424-434): the i-th pending row goes to the first block whose
    cumulative free capacity covers i."""
    unas = assign < 0
    pr = torch.cumsum(unas.to(torch.int64), 0) - 1
    cumfree = torch.cumsum(free, 0)
    blk = torch.searchsorted(cumfree, pr, right=True)
    can = unas & (pr < cumfree[B - 1])
    return torch.where(can, torch.clamp(blk, 0, B - 1), assign)


def _pack_block_ids_device(assign, *, S: int, B: int):
    """``[n]`` block assignment -> ``[B, S]`` int32 member ids, -1 padded
    (block.py:437-452)."""
    n = assign.shape[0]
    order = torch.argsort(assign, stable=True)
    a_sorted = assign[order]
    starts = torch.searchsorted(a_sorted, torch.arange(B, device=assign.device))
    pos = torch.arange(n, device=assign.device) - starts[
        torch.clamp(a_sorted, 0, B - 1)]
    ok = (a_sorted >= 0) & (pos >= 0) & (pos < S)
    idx = torch.where(ok, a_sorted * S + pos, B * S)
    flat = torch.full((B * S + 1,), -1, dtype=torch.int32,
                      device=assign.device)           # last slot = dump
    flat[idx] = order.to(torch.int32)
    return flat[: B * S].reshape(B, S)


def _balanced_assign_device(xt, centroids, S: int,
                            B: int) -> tuple[torch.Tensor, dict]:
    """Assign every row to a block of capacity S, preferring near blocks
    (block.py:455-519): top-8 centroid candidates per row, greedy rounds,
    up to three retry passes against blocks with free capacity, then a
    distance-agnostic leftover fill. Returns (block per row, stats)."""
    t0 = time.perf_counter()
    n = xt.shape[0]
    cents = centroids.float()
    c_sq = D.squared_norms(cents)
    # bounds the [step, B] score intermediate to ~2 GB at large B
    step = min(1 << 17, max(4096, _pow2((1 << 29) // max(B, 1))))
    tt = min(8, B)

    def score_all(full):
        ds, is_ = [], []
        for s in range(0, n, step):
            xb = xt[s:s + step].float()
            d_, i_ = _top_blocks_chunk(xb, D.squared_norms(xb), cents, c_sq,
                                       t=tt, full=full)
            ds.append(d_)
            is_.append(i_)
        return torch.cat(ds), torch.cat(is_)

    with annotate("assign_topk", n):
        cand_d, cand_i = score_all(None)
        _sync(xt.device)
    t1 = time.perf_counter()
    with annotate("assign_rounds", n):
        assign = torch.full((n,), -1, dtype=torch.int64, device=xt.device)
        free = torch.full((B,), S, dtype=torch.int64, device=xt.device)
        _assign_rounds_device(cand_i, cand_d, assign, free, B=B)
        retried = int((assign < 0).sum())
        left = retried
        for _retry in range(3):  # three retry rounds leave ~no row unplaced
            if left == 0:
                break
            rd, ri = score_all(free <= 0)
            _assign_rounds_device(ri, rd, assign, free, B=B)
            left = int((assign < 0).sum())
        if left:
            assign = _leftover_fill_device(assign, free, B=B)
    stats = {
        "assign_topk_s": round(t1 - t0, 3),
        "assign_greedy_s": round(time.perf_counter() - t1, 3),
        "assign_retried_rows": retried,
        "assign_leftover_rows": left,
    }
    return assign, stats


def _make_score_copy(blocks: torch.Tensor, score_dtype: str = "int8"):
    """Scoring copy of the blocks (block.py:524-562), rows padded with zeros
    to a 16-byte multiple for the kernel's loads. Returns ``(copy, scale)``:
    int8 with a per-block dequant factor ``max|block| / 127`` ``[B]``
    (``torch.round`` is half-to-even, like ``jnp.round``), or bf16 with
    scale None (aliasing bf16 storage whose rows are already aligned)."""
    B, S, d = blocks.shape
    chunk = 1024  # blocks per step: bounds the f32 temporaries
    if score_dtype == "int8":
        out = torch.zeros((B, S, _score_width(d, torch.int8)),
                          dtype=torch.int8, device=blocks.device)
        scale = torch.empty(B, dtype=torch.float32, device=blocks.device)
        for s in range(0, B, chunk):
            bf = blocks[s:s + chunk].float()
            scl = torch.clamp_min(bf.abs().amax(dim=(1, 2)), 1e-30) / 127.0
            out[s:s + chunk, :, :d] = torch.clamp(
                torch.round(bf / scl[:, None, None]), -127, 127
            ).to(torch.int8)
            scale[s:s + chunk] = scl
        return out, scale
    if score_dtype != "bf16":
        raise ValueError("score_dtype must be int8|bf16")
    dp = _score_width(d, torch.bfloat16)
    if blocks.dtype == torch.bfloat16 and dp == d:
        return blocks, None
    return _pad_cols(blocks.to(torch.bfloat16), dp), None


def _check_score_dtype(score_dtype: str | None) -> str | None:
    """A loader's ``score_dtype`` keyword: None or a scoring copy's name."""
    if score_dtype not in (None, "int8", "bf16"):
        raise ValueError("score_dtype must be int8|bf16")
    return score_dtype


def _chunk(elems_per_item: int) -> int:
    """Items per step so a step's f32 temporaries hold ~_CHUNK_ELEMS."""
    return max(1, _CHUNK_ELEMS // max(elems_per_item, 1))


def _gather_blocks(xt: torch.Tensor, block_ids: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``[B, S]`` ids (-1 pad) -> ``[B, S, d]`` rows of ``xt`` in ``dtype``,
    pad rows zero (block.py:63-69), gathered in steps so no corpus-sized
    temporary exists beside the output."""
    B, S = block_ids.shape
    d = xt.shape[1]
    flat = block_ids.reshape(-1)
    out = torch.empty((B * S, d), dtype=dtype, device=xt.device)
    step = _chunk(d)
    for s in range(0, B * S, step):
        ids = flat[s:s + step]
        out[s:s + step] = xt.index_select(0, torch.clamp_min(ids, 0)).to(
            dtype).mul_((ids >= 0)[:, None])
    return out.reshape(B, S, d)


def _block_stats(blocks: torch.Tensor):
    """(row squared norms ``[B, S]``, row sums ``[B, d]``) in f32, in steps
    of blocks (block.py:72-80 fuse them for the same reason: an f32 copy
    of a bf16 store is 6 GB at 1M x 1536)."""
    B, S, d = blocks.shape
    sq = torch.empty((B, S), dtype=torch.float32, device=blocks.device)
    rowsum = torch.empty((B, d), dtype=torch.float32, device=blocks.device)
    step = _chunk(S * d)
    for s in range(0, B, step):
        bf = blocks[s:s + step].float()
        sq[s:s + step] = (bf * bf).sum(-1)
        rowsum[s:s + step] = bf.sum(1)
    return sq, rowsum


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """``l2_normalize`` keeping the dtype, in steps of rows (block.py:83-90)."""
    out = torch.empty_like(x)
    step = _chunk(x.shape[1])
    for s in range(0, x.shape[0], step):
        out[s:s + step] = D.l2_normalize(x[s:s + step])
    return out


def _all_finite(x: torch.Tensor) -> bool:
    """No NaN or infinity, checked in steps of rows (block.py:93-98)."""
    ok = torch.ones((), dtype=torch.bool, device=x.device)
    step = _chunk(x.shape[1])
    for s in range(0, x.shape[0], step):
        ok &= torch.isfinite(x[s:s + step]).all()
    return bool(ok)


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host array; bf16 comes back as its raw uint16 bits (the
    reference's on-disk form)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _write_blob(path: str, arr: np.ndarray) -> None:
    """Raw bytes of ``arr`` to ``path`` (``io/native.py:112-125``'s format),
    raising unless the whole array reached the file."""
    arr = np.ascontiguousarray(arr)
    arr.tofile(path)
    if os.path.getsize(path) != arr.nbytes:
        raise OSError(f"short write: {path} holds {os.path.getsize(path)} "
                      f"of {arr.nbytes} bytes")


class BlockHnswIndex:
    """HNSW index with cluster-blocked level 0.

    ``block_size`` is the level-0 granularity S; ``config.m`` and
    ``ef_construction`` shape the centroid graph. ``routing``: "exact"
    scans all centroids at any block count, "graph" walks an HNSW graph
    over them, "auto" scans while B <= EXACT_ROUTING_MAX and walks the
    graph above it. ``device`` holds every
    tensor of the index: the card unless the caller names another
    (``"cpu"`` runs the kernel's plain version). Attributes
    ``two_stage`` (scoring copy + exact rerank), ``rerank_width`` (rows per
    query kept by stage 1) and ``score_dtype`` ("int8" | "bf16", the
    scoring copy made at build) may be set before ``build``.
    """

    EXACT_ROUTING_MAX = 65536
    # above this block count, probes >= n_blocks streams the whole store
    # once instead of expanding every block for every query
    EXHAUSTIVE_SCAN_MIN_BLOCKS = 2048

    def __init__(self, config: HnswConfig, block_size: int = 256,
                 routing: str = "auto", block_slack: float = 1.05,
                 device=None):
        if routing not in ("auto", "exact", "graph"):
            raise ValueError("routing must be auto|exact|graph")
        if config.metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            raise ValueError(f"{config.metric} unsupported by BlockHnswIndex")
        self.cfg = config
        self.block_size = int(block_size)
        self.routing = routing
        self.device = entry_device(device)
        self.two_stage = True
        self.rerank_width = 40
        self.score_dtype = "int8"
        # packing slack: at exact capacity the balanced packer strands rows
        # in arbitrary leftover blocks, a probe-independent recall floor
        self.block_slack = float(block_slack)
        self.n = 0                # live block rows (deleted excluded)
        self.n_total = 0          # id space placed in blocks (tail excluded)
        self.n_blocks = 0
        self.blocks = None        # [B, S, d] storage dtype
        self.blocks_sq = None     # [B, S] f32
        self.block_ids = None     # [B, S] int32, -1 = dead/pad
        self.blocks_score = None  # [B, S, dp] int8 | bf16 scoring copy
        self.score_scale = None   # [B] f32 per-block dequant (int8 copy)
        self.centroids = None     # [B, d] storage dtype
        self.centroids_sq = None  # [B] f32
        self.centroid_index: HnswIndex | None = None
        self.build_stats = {}
        self._install_stats = {}
        # host id -> flat slot (block*S + s), -2 in the tail, -1 deleted;
        # made lazily (_ensure_slot): only delete/add/save need it
        self._slot_of = None
        self._filter_cache = None
        self._reset_tail()

    def _reset_tail(self):
        """Empty spill tail (inserts since the last compact)."""
        self.tail_n = 0           # high-water mark (next free tail slot)
        self.tail_live = 0        # live (non-deleted) tail rows
        self.tail = None          # [cap, d] storage dtype
        self.tail_sq = None       # [cap] f32
        self.tail_ids = None      # [cap] int32, -1 = pad/deleted

    # ------------------------------------------------------------------ util
    @property
    def size(self) -> int:
        return self.n + self.tail_live

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.cfg.dtype == "bfloat16" else torch.float32

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

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """Host array -> device: one pinned staging copy, copied
        asynchronously (the reference's chunked relay upload is not needed
        over PCIe)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _use_graph_routing(self) -> bool:
        if self.routing == "graph":
            return True
        if self.routing == "exact":
            return False
        return self.n_blocks > self.EXACT_ROUTING_MAX

    def probes_for_ef(self, ef_search: int) -> int:
        """Blocks a query probes for an ef (:func:`probes_for_ef`), at most
        ``n_blocks``."""
        return probes_for_ef(ef_search, self.block_size, self.block_slack,
                             self.n_blocks)

    # ----------------------------------------------------------------- build
    def build(self, data, kmeans_iters: int = 10,
              device_data: torch.Tensor | None = None) -> "BlockHnswIndex":
        """CREATE INDEX analogue: k-means, balanced pack, install. ``data``
        is an ``[n, d]`` array or tensor (a tensor is used where it lies
        when that is the index's device). ``device_data``, the reference's
        keyword, takes the place of ``data`` when given. Stage times land in
        ``self.build_stats``."""
        if self.score_dtype not in ("int8", "bf16"):
            raise ValueError("score_dtype must be int8|bf16")
        if device_data is not None:
            data = device_data
        t0 = time.perf_counter()
        device_input = isinstance(data, torch.Tensor)
        if device_input:
            if data.ndim != 2 or data.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not "
                    f"{data.shape[-1] if data.ndim else 0}")
            xt = data.to(self.device, self.dtype)
            if not _all_finite(xt):
                raise ValueError("NaN or infinity values are not allowed")
            if self.cfg.metric.needs_normalized:
                xt = _normalize_rows(xt)
        else:
            xt = self._upload(self._prep(data))
        n = int(xt.shape[0])
        _sync(self.device)  # stage times cover the device work
        t1 = time.perf_counter()
        if n == 0:  # CREATE INDEX on an empty table succeeds upstream
            self.build_stats = {"prep_s": round(t1 - t0, 3),
                                "device_resident_input": device_input,
                                "total_s": round(t1 - t0, 3),
                                "vectors_per_sec": 0.0}
            return self
        block_ids = self._pack(xt, kmeans_iters)
        _sync(self.device)
        t2 = time.perf_counter()
        with annotate("install", n):
            self._install_blocks(block_ids, xt)
            _sync(self.device)
        t3 = time.perf_counter()
        self.build_stats = {
            "prep_s": round(t1 - t0, 3),
            "cluster_pack_s": round(t2 - t1, 3),
            "install_s": round(t3 - t2, 3),
            **self._pack_stats,
            **self._install_stats,
            "device_resident_input": device_input,
            "total_s": round(t3 - t0, 3),
            "vectors_per_sec": round(n / max(t3 - t0, 1e-9), 1),
        }
        return self

    def _pack(self, xt: torch.Tensor, kmeans_iters: int) -> torch.Tensor:
        """Cluster + capacity-balanced packing: ``[B, S]`` int32 row
        positions in ``xt``."""
        n = xt.shape[0]
        S = self.block_size
        B = max(1, math.ceil(n * self.block_slack / S))
        tk = time.perf_counter()
        if B == 1:
            assign = torch.zeros(n, dtype=torch.int64, device=xt.device)
            self._pack_stats = {}
            return _pack_block_ids_device(assign, S=S, B=B)
        centroids, _ = KM.kmeans(
            xt, B, iters=kmeans_iters, seed=self.cfg.seed,
            sample=min(n, max(65536, 32 * B)), balance=True,
            assign_full=False)
        ta = time.perf_counter()
        with annotate("balanced_assign", n):
            assign, assign_stats = _balanced_assign_device(xt, centroids, S,
                                                           B)
        self._pack_stats = {
            "kmeans_s": round(ta - tk, 3),
            "balanced_assign_s": round(time.perf_counter() - ta, 3),
            **assign_stats,
        }
        return _pack_block_ids_device(assign, S=S, B=B)

    def _install_blocks(self, block_ids: torch.Tensor, xt: torch.Tensor,
                        ids: torch.Tensor | None = None):
        """Gather the packed blocks, their norms, centroids and scoring
        copy. ``block_ids`` holds row positions in ``xt``; ``ids`` (when
        given) maps a position to the element id that is stored."""
        blocks = _gather_blocks(xt, block_ids, self.dtype)
        if ids is not None:
            block_ids = torch.where(
                block_ids >= 0, ids[torch.clamp_min(block_ids, 0).long()],
                -1).to(torch.int32)
        self._set_blocks(blocks, block_ids)
        self.n = int(xt.shape[0])
        self.n_total = self.n
        self._slot_of = None
        self._reset_tail()
        self._install_stats = {}
        if self._use_graph_routing():
            self._ensure_centroid_graph()

    def _set_blocks(self, blocks: torch.Tensor, block_ids: torch.Tensor):
        """Install blocks and derive norms, scoring copy and centroids (the
        mean of each block's rows over its live count; block.py:1050-1060,
        1681-1689)."""
        self.blocks = blocks
        self.blocks_sq, rowsum = _block_stats(blocks)
        self.blocks_score, self.score_scale = _make_score_copy(
            blocks, self.score_dtype)
        self.block_ids = block_ids
        counts = torch.clamp_min((block_ids >= 0).float().sum(1), 1.0)
        cents = rowsum / counts[:, None]
        self.centroids = cents.to(self.dtype)
        self.centroids_sq = (cents * cents).sum(-1)
        self.n_blocks = int(blocks.shape[0])
        self._filter_cache = None
        self.centroid_index = None  # made again for these centroids

    def _ensure_centroid_graph(self) -> HnswIndex:
        """The HNSW graph over the block centroids, built once (block.py:
        1090-1122) with the index's config, over the raw centroids: a
        centroid of normalised rows is not unit-norm, so a cosine index's
        graph takes inner product, which keeps the order routing needs.

        Its waves hold at most B/32 centroids. The reference gives them the
        element config's ``wave_size`` (1024): over a few thousand
        centroids a wave is a quarter of the graph it joins, and the wave
        staleness leaves islands no search reaches (4,102 centroids of the
        1M x 128 cell: recall@10 stops at 0.86 even at 128 probes). From
        ``BULK_THRESHOLD`` centroids the graph is bulk-built and the wave
        size plays no part."""
        if self.centroid_index is not None:
            return self.centroid_index
        ccfg = HnswConfig(
            dim=self.cfg.dim,
            metric=(Metric.IP if self.cfg.metric is Metric.COSINE
                    else self.cfg.metric),
            m=self.cfg.m, ef_construction=self.cfg.ef_construction,
            dtype=self.cfg.dtype,
            wave_size=max(1, min(self.cfg.wave_size, self.n_blocks // 32)),
            descent_ef=self.cfg.descent_ef, seed=self.cfg.seed)
        t0 = time.perf_counter()
        self.centroid_index = HnswIndex(ccfg, capacity=self.n_blocks,
                                        device=self.device)
        self.centroid_index.build(
            self.centroids[: self.n_blocks].float().cpu().numpy())
        self._install_stats = {
            "centroid_graph_s": round(time.perf_counter() - t0, 3)}
        return self.centroid_index

    @property
    def _stored(self) -> Stored:
        """The arrays and serving options :func:`_expand_step` reads."""
        return Stored(self.blocks, self.blocks_score, self.blocks_sq,
                      self.block_ids, self.score_scale, self.two_stage,
                      self.rerank_width)

    def _route(self, qt, probes: int, ef_route: int):
        """Each query's ``probes`` blocks through the centroid graph's beam
        (block.py:1133-1144); a missing result repeats block 0, whose
        duplicate rows lose the top-k ties."""
        ci = self._ensure_centroid_graph()
        _, bids = ci.search_device(qt, k=probes,
                                   ef_search=min(max(ef_route, probes), 1000))
        return torch.where(bids == ci.graph.sentinel, 0, bids)

    @classmethod
    def from_state(cls, cfg: HnswConfig, state: dict, block_size: int = 256,
                   device=None) -> "BlockHnswIndex":
        """An index over arrays exported from ``tpu_hnsw``'s BlockHnswIndex
        (numpy arrays under its attribute names, plus ``n`` and
        ``n_blocks``). Its 128-lane scoring copy is cut to this package's
        16-byte rows (the cut columns are zero)."""
        idx = cls(cfg, block_size=block_size, device=device)
        dev = idx.device
        B = int(state["n_blocks"])
        d = cfg.dim
        idx.blocks = _tensor(state["blocks"][:B], dev)
        idx.blocks_sq = _tensor(state["blocks_sq"][:B], dev)
        idx.block_ids = _tensor(state["block_ids"][:B], dev)
        score = _tensor(state["blocks_score"][:B], dev)
        idx.score_dtype = "int8" if score.dtype == torch.int8 else "bf16"
        idx.blocks_score = _pad_cols(score[..., :d].contiguous(),
                                     _score_width(d, score.dtype))
        scale = state.get("score_scale")
        idx.score_scale = None if scale is None else _tensor(scale[:B], dev)
        idx.centroids = _tensor(state["centroids"][:B], dev)
        idx.centroids_sq = _tensor(state["centroids_sq"][:B], dev)
        idx.n = int(state["n"])
        idx.n_total = int(state.get("n_total",
                                    int(state["block_ids"].max()) + 1))
        idx.n_blocks = B
        return idx

    # ---------------------------------------------------------------- search
    def _queries(self, queries) -> torch.Tensor:
        """Queries -> f32 ``[Q, d]`` on the device (normalised for cosine).
        A tensor is not validated (finite values are the caller's job)."""
        if isinstance(queries, torch.Tensor):
            qt = queries.to(self.device, torch.float32).contiguous()
            if qt.ndim == 1:
                qt = qt[None]
            if qt.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not {qt.shape[1]}")
            if self.cfg.metric.needs_normalized:
                qt = D.l2_normalize(qt)
            return qt
        return self._upload(self._prep(queries))

    def _filter_device(self, filter_mask):
        """(allowed slots ``[B, S]``, allowed tail rows ``[tail_n]`` | None)
        bool masks from a per-id filter: a bool mask over element ids (array
        or tensor) or a list of ids (block.py:1150-1181). Cached for the
        same mask object until the index changes; the cache holds the
        object, so a new mask can never reuse a dead one's cache entry."""
        cache = self._filter_cache
        if cache is not None and cache[0] is filter_mask:
            return cache[1], cache[2]
        hi = max(self.n_total + self.tail_n, 1)
        dev = self.device
        full = torch.zeros(hi, dtype=torch.bool, device=dev)
        if isinstance(filter_mask, torch.Tensor) \
                and filter_mask.dtype == torch.bool:
            m = filter_mask.reshape(-1).to(dev)
            ln = min(m.shape[0], hi)
            full[:ln] = m[:ln]
        else:
            m = np.asarray(filter_mask.cpu() if isinstance(
                filter_mask, torch.Tensor) else filter_mask).reshape(-1)
            if m.dtype == bool:
                ln = min(m.shape[0], hi)
                full[:ln] = torch.from_numpy(m[:ln]).to(dev)
            else:
                ids = m.astype(np.int64)
                ids = ids[(ids >= 0) & (ids < hi)]
                full[torch.from_numpy(ids).to(dev)] = True
        slots = None
        if self.block_ids is not None:
            bi = self.block_ids
            slots = full[torch.clamp_min(bi, 0).long()] & (bi >= 0)
        tailm = None
        if self.tail_n:
            ti = self.tail_ids[:self.tail_n]
            tailm = full[torch.clamp_min(ti, 0).long()] & (ti >= 0)
        self._filter_cache = (filter_mask, slots, tailm)
        return slots, tailm

    def _tail_scores(self, qt, q_sq, k: int, allowed_tail=None):
        n = self.tail_n
        return _scan_tail(self.tail[:n], self.tail_sq[:n],
                          self.tail_ids[:n], qt, q_sq, allowed_tail, k=k,
                          metric=self.cfg.metric)

    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None, filter_mask=None):
        """Device-resident search. Returns (distances, ids) tensors in
        pgvector operator units; missing ids are -1. A tensor of queries
        is not validated (finite values are the caller's job).

        ``filter_mask`` (bool mask or id list over element ids) is applied
        on the device: disallowed rows score +inf in the kernel, like dead
        rows. Selective filters want wider probes; see
        :meth:`search_iterative` for automatic widening."""
        with annotate("search") as span:
            validate_ef_search(max(ef_search, 1))
            if self.n_blocks == 0 and not self.tail_n:
                raise ValueError("index is empty")
            if probes is None:
                probes = self.probes_for_ef(max(ef_search, k))
            probes = max(1, min(probes, max(self.n_blocks, 1)))
            with annotate("queries") as qspan:
                qt = self._queries(queries)
                span.work = qspan.work = qt.shape[0]
            allowed_slots = allowed_tail = None
            if filter_mask is not None:
                allowed_slots, allowed_tail = self._filter_device(filter_mask)
            metric = self.cfg.metric
            if self.n_blocks == 0:  # every row arrived through the spill tail
                sc, ids = self._tail_scores(qt, D.squared_norms(qt), k,
                                            allowed_tail)
                return D.score_to_distance(sc, metric), ids
            if (probes >= self.n_blocks
                    and self.n_blocks > self.EXHAUSTIVE_SCAN_MIN_BLOCKS):
                sc, ids = self._scan_all(qt, k, allowed_slots)
            else:
                q_sq = D.squared_norms(qt)
                nq = qt.shape[0]
                with annotate("route", nq):
                    if self._use_graph_routing():
                        bids = self._route(qt, probes, max(ef_search, probes))
                    else:  # block.py:287-306
                        bids = R.route_topk(self.centroids, self.centroids_sq,
                                            qt, q_sq, probes, metric)[:, 0]
                with annotate("expand", nq):
                    sc, ids = _expand_step(self._stored, qt, q_sq, bids, k=k,
                                           metric=metric,
                                           allowed=allowed_slots)
            if self.tail_n:
                t_sc, t_ids = self._tail_scores(qt, D.squared_norms(qt), k,
                                                allowed_tail)
                # lax.top_k's order: ties to the block result over the tail
                sc, sel = T.topk_smallest_by_index(torch.cat([sc, t_sc], 1), k)
                ids = torch.gather(torch.cat([ids, t_ids], 1), 1, sel)
            return D.score_to_distance(sc, metric), ids

    def _scan_all(self, qt, k: int, allowed_slots=None):
        """Exhaustive scan of the blocked store for ``probes >= n_blocks``
        (block.py:1292-1326): a streamed scan of the bf16 copy (or of the
        stored blocks when the copy is int8, whose per-block scales the
        flat scan does not take) keeps ``max(4k, rerank_width)`` candidates,
        re-scored exactly. Raw scores out."""
        d = self.cfg.dim
        if self.score_scale is not None:
            scan_src = self.blocks
        else:
            scan_src = self.blocks_score
        dp = scan_src.shape[2]
        cand = max(4 * k, self.rerank_width)
        valid = (self.block_ids >= 0).reshape(-1)
        if allowed_slots is not None:
            valid = valid & allowed_slots.reshape(-1)
        _, pos = FL._stream_search(
            _pad_cols(qt, dp), scan_src.reshape(-1, dp),
            self.blocks_sq.reshape(-1), valid, cand, self.cfg.metric,
            FL.FlatIndex.BLOCK)
        bad = pos < 0
        safe = torch.clamp_min(pos, 0)
        v = self.blocks.reshape(-1, d)[safe]
        sc2 = torch.where(bad, torch.inf,
                          D.batched_scores(qt, v, self.cfg.metric))
        vals, sel = T.topk_smallest_by_index(sc2, k)
        cand_ids = torch.where(bad, -1, self.block_ids.reshape(-1)[safe])
        ids = torch.gather(cand_ids, 1, sel)
        return vals, torch.where(torch.isfinite(vals), ids, -1)

    def search(self, queries, k: int = 10, ef_search: int = 40,
               probes: int | None = None, return_distances: bool = True,
               filter_mask=None):
        d, i = self.search_device(queries, k=k, ef_search=ef_search,
                                  probes=probes, filter_mask=filter_mask)
        if not return_distances:
            return i.cpu().numpy()
        return d.cpu().numpy(), i.cpu().numpy()

    def search_iterative(self, queries, k: int = 10, ef_search: int = 40,
                         predicate=None, max_probes: int = 0):
        """Iterative scan (upstream ``hnsw.iterative_scan``; block.py:
        1338-1459): when a filter rejects results, widen the probe set. The
        fully sorted centroid ranking (exact, whatever the routing) is
        prefix-consistent, so an
        unfiltered round expands only the blocks ranked ``[p_prev, p)`` and
        accumulates (a resume). A filtered round re-expands the whole
        prefix ``[0, p)`` at a doubled retained width W, rescans the spill
        tail at that width too (the reference reads it once, at the first
        W), and a filtered query finalises only when its k passing results
        survive one further widening.

        ``predicate(ids) -> bool mask`` runs on the host over an ``[nq, m]``
        int64 id array; ``max_probes`` (default: all blocks) bounds the
        scan. Returns numpy (distances, ids), inf / -1 padded when fewer
        than k pass."""
        validate_ef_search(max(ef_search, 1))
        if self.n_blocks == 0:
            raise ValueError("index is empty")
        max_probes = min(max_probes or self.n_blocks, self.n_blocks)
        S = self.block_size
        metric = self.cfg.metric
        qt = self._queries(queries)
        nq = qt.shape[0]
        q_sq = D.squared_norms(qt)
        W = max(4 * k, self.rerank_width)
        bids_full = _route_exact_sorted(
            self.centroids, self.centroids_sq, qt, q_sq, p=max_probes,
            metric=metric)

        def tail_pool(width: int):
            if not self.tail_n:
                return (np.zeros((nq, 0), np.float32),
                        np.zeros((nq, 0), np.int64))
            sc, ids = self._tail_scores(qt, q_sq, min(width, self.tail_n))
            return sc.cpu().numpy(), ids.cpu().numpy().astype(np.int64)

        filtered = predicate is not None
        acc_d, acc_i = tail_pool(W)
        out_d = np.full((nq, k), np.inf, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        done = np.zeros(nq, bool)
        confirm = np.zeros(nq, bool)
        p_prev, p = 0, min(self.probes_for_ef(max(ef_search, k)), max_probes)
        while True:
            lo = 0 if filtered else p_prev
            bids = bids_full[:, lo:p].contiguous()
            sc, ids = _expand_step(self._stored, qt, q_sq, bids,
                                   k=min(W, (p - lo) * S), metric=metric)
            if filtered:  # fresh pool: the prefix was re-expanded in full
                acc_d, acc_i = tail_pool(W)
            acc_d = np.concatenate([acc_d, sc.cpu().numpy()], axis=1)
            acc_i = np.concatenate(
                [acc_i, ids.cpu().numpy().astype(np.int64)], axis=1)
            order = np.argsort(acc_d, axis=1, kind="stable")
            acc_d = np.take_along_axis(acc_d, order, axis=1)
            acc_i = np.take_along_axis(acc_i, order, axis=1)
            mask = np.asarray(predicate(acc_i), bool) if filtered \
                else acc_i >= 0
            mask &= acc_i >= 0
            rank = np.cumsum(mask, axis=1) - 1
            satisfied = mask.sum(1) >= k
            final = ~done & ((p >= max_probes)
                             | (satisfied & (confirm | (not filtered))))
            r, c = np.nonzero(mask & (rank < k) & final[:, None])
            out_d[r, rank[r, c]] = acc_d[r, c]
            out_i[r, rank[r, c]] = acc_i[r, c]
            confirm |= ~done & ~final & satisfied
            done |= final
            if done.all() or p >= max_probes:
                break
            p_prev, p = p, min(2 * p, max_probes)
            if filtered:
                W = min(2 * W, max_probes * S)
        out_d = D.score_to_distance(torch.from_numpy(out_d), metric).numpy()
        return np.where(out_i >= 0, out_d, np.inf), out_i

    # ------------------------------------------------------------ add/delete
    def _ensure_slot(self) -> None:
        """Make the host id -> slot map from ``block_ids`` and the tail
        (block.py:1462-1483)."""
        if self._slot_of is not None or (self.block_ids is None
                                         and not self.tail_n):
            return
        flat = (self.block_ids.reshape(-1).cpu().numpy()
                if self.block_ids is not None else np.zeros(0, np.int32))
        live = flat >= 0
        hi = int(flat[live].max()) + 1 if live.any() else 0
        t_ids = None
        if self.tail_n:
            t_ids = self.tail_ids[:self.tail_n].cpu().numpy()
            t_ids = t_ids[t_ids >= 0]
            if t_ids.size:
                hi = max(hi, int(t_ids.max()) + 1)
        slot = np.full(hi, -1, np.int64)
        slot[flat[live]] = np.arange(flat.size, dtype=np.int64)[live]
        if t_ids is not None and t_ids.size:
            slot[t_ids] = -2  # in the tail
        self._slot_of = slot

    def add(self, data) -> np.ndarray:
        """Insert vectors into the spill tail (hnswinsert analogue for the
        blocked layout; :meth:`compact` folds them into blocks). Returns
        their ids, continuing the id space."""
        x = self._prep(data)
        count = x.shape[0]
        start = self.n_total + self.tail_n
        ids = np.arange(start, start + count, dtype=np.int32)
        if count == 0:
            return ids
        need = self.tail_n + count
        cap = 0 if self.tail is None else self.tail.shape[0]
        if need > cap:
            new_cap = _pow2(max(need, 1024))
            dev = self.device
            tail = torch.zeros((new_cap, self.cfg.dim), dtype=self.dtype,
                               device=dev)
            tail_sq = torch.zeros(new_cap, dtype=torch.float32, device=dev)
            tail_ids = torch.full((new_cap,), -1, dtype=torch.int32,
                                  device=dev)
            if self.tail_n:
                tail[:self.tail_n] = self.tail[:self.tail_n]
                tail_sq[:self.tail_n] = self.tail_sq[:self.tail_n]
                tail_ids[:self.tail_n] = self.tail_ids[:self.tail_n]
            self.tail, self.tail_sq, self.tail_ids = tail, tail_sq, tail_ids
        xt = self._upload(x).to(self.dtype)
        self.tail[self.tail_n:need] = xt
        self.tail_sq[self.tail_n:need] = D.squared_norms(xt)
        self.tail_ids[self.tail_n:need] = torch.from_numpy(ids).to(
            self.device)
        self.tail_n = need
        self.tail_live += count
        self._filter_cache = None
        self._ensure_slot()
        if self._slot_of is None or len(self._slot_of) < ids[-1] + 1:
            grown = np.full(ids[-1] + 1, -1, np.int64)
            if self._slot_of is not None:
                grown[:len(self._slot_of)] = self._slot_of
            self._slot_of = grown
        self._slot_of[ids] = -2  # in the tail
        return ids

    def delete(self, ids) -> None:
        """Tombstone rows (hnswbulkdelete analogue): their slots' ids become
        -1 and they never score again. Unknown or repeated ids are
        ignored."""
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        self._ensure_slot()
        if self._slot_of is None:  # nothing built or added yet
            return
        ids = ids[(ids >= 0) & (ids < len(self._slot_of))]
        slots = self._slot_of[ids]
        dev = self.device
        blk = slots[slots >= 0]
        if blk.size:
            self.block_ids = self.block_ids.reshape(-1).index_put(
                (torch.from_numpy(blk).to(dev),),
                torch.tensor(-1, dtype=torch.int32, device=dev),
            ).reshape(self.block_ids.shape)
            self.n -= int(blk.size)
        in_tail = ids[slots == -2]
        if in_tail.size and self.tail_n:
            kill = torch.isin(self.tail_ids,
                              torch.from_numpy(in_tail).to(dev))
            self.tail_ids = torch.where(kill, -1, self.tail_ids)
            self.tail_live -= int(kill.sum())
        self._slot_of[ids] = -1
        self._filter_cache = None

    def compact(self) -> None:
        """Re-cluster blocks + tail into a fresh packed layout (vacuum
        analogue): dead rows are dropped, tail rows are placed into blocks,
        centroids are rebuilt; ids keep their meaning. The id space never
        shrinks (the reference restarts it after the largest live id, so
        deleted top ids were handed out again)."""
        live_ids, live_vecs = self._export_live()
        if live_ids.numel() == 0:
            raise ValueError("cannot compact an index with every row deleted")
        id_space = self.n_total + self.tail_n
        block_ids = self._pack(live_vecs, kmeans_iters=5)
        self._install_blocks(block_ids, live_vecs, ids=live_ids)
        self.n_total = id_space

    def _export_live(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids int64, vectors in the storage dtype) of every live row,
        blocks then tail, on the device. ``_pack`` and ``_install_blocks``
        widen them to f32 in steps, so no corpus-sized f32 copy exists."""
        d = self.cfg.dim
        ids, vecs = [], []
        if self.block_ids is not None:
            bi = self.block_ids.reshape(-1)
            live = bi >= 0
            ids.append(bi[live].long())
            vecs.append(self.blocks.reshape(-1, d)[live])
        if self.tail_n:
            ti = self.tail_ids[:self.tail_n]
            tl = ti >= 0
            ids.append(ti[tl].long())
            vecs.append(self.tail[:self.tail_n][tl])
        if not ids:
            return (torch.zeros(0, dtype=torch.int64, device=self.device),
                    torch.zeros((0, d), dtype=self.dtype, device=self.device))
        return torch.cat(ids), torch.cat(vecs)

    # ----------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Write the reference's layout (block.py:1617-1659): raw
        ``blocks.bin`` (bf16 as uint16), ``blocks.npz`` (block_ids,
        slot_of), ``meta.json`` and, with a spill tail, ``tail.npz``.
        ``meta.json`` also holds ``block_slack`` and ``score_dtype``, which
        the reference does not persist (and ignores when it loads). A built
        centroid graph goes to ``centroid_graph/`` in
        :meth:`HnswIndex.save`'s layout."""
        os.makedirs(path, exist_ok=True)
        self._ensure_slot()
        S, d = self.block_size, self.cfg.dim
        if self.blocks is not None:
            blocks = _numpy_of(self.blocks)
            block_ids = self.block_ids.cpu().numpy()
        else:
            blocks = np.zeros((0, S, d), np.uint16 if self.dtype
                              == torch.bfloat16 else np.float32)
            block_ids = np.zeros((0, S), np.int32)
        _write_blob(os.path.join(path, "blocks.bin"), blocks)
        np.savez(os.path.join(path, "blocks.npz"), block_ids=block_ids,
                 slot_of=self._slot_of if self._slot_of is not None
                 else np.zeros(0, np.int64))
        meta = {
            "config": {**dataclasses.asdict(self.cfg),
                       "metric": self.cfg.metric.value},
            "block_size": S,
            "routing": self.routing,
            "n": self.n,
            "n_total": self.n_total,
            "n_blocks": self.n_blocks,
            "blocks_bin": {"dtype": str(blocks.dtype),
                           "shape": list(blocks.shape)},
            "block_slack": self.block_slack,
            "score_dtype": self.score_dtype,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        if self.centroid_index is not None:  # built lazily; may not exist
            self.centroid_index.save(os.path.join(path, "centroid_graph"))
        if self.tail_n:
            np.savez(os.path.join(path, "tail.npz"),
                     tail=self.tail.float().cpu().numpy(),
                     tail_ids=self.tail_ids.cpu().numpy(),
                     tail_n=self.tail_n)

    @classmethod
    def load(cls, path: str, device=None,
             score_dtype: str | None = None) -> "BlockHnswIndex":
        """Read a directory written by :meth:`save` or by ``tpu_hnsw``
        (block.py:1661-1706): norms, scoring copy and centroids are derived
        again from the blocks, and a saved ``centroid_graph/`` is loaded.
        ``block_slack`` defaults to 1.05 where the directory does not hold
        it. ``score_dtype`` ("int8" | "bf16") names the scoring copy to
        make; None takes the directory's, else "int8". The reference's
        directories hold none: it picks the copy from
        ``TPU_HNSW_SCORE_DTYPE`` when it loads (block.py:546-547)."""
        score_dtype = _check_score_dtype(score_dtype)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        c = dict(meta["config"])
        c["metric"] = Metric(c["metric"])
        idx = cls(HnswConfig(**c), block_size=meta["block_size"],
                  routing=meta["routing"],
                  block_slack=meta.get("block_slack", 1.05), device=device)
        idx.score_dtype = score_dtype or meta.get("score_dtype", "int8")
        z = np.load(os.path.join(path, "blocks.npz"))
        bb = meta.get("blocks_bin")
        if bb is not None:
            raw = np.fromfile(os.path.join(path, "blocks.bin"),
                              np.dtype(bb["dtype"])).reshape(bb["shape"])
        else:  # the reference's older layout: blocks inside the npz
            raw = z["blocks"]
        if raw.dtype == np.uint16:
            blocks = torch.from_numpy(raw.view(np.int16)).view(
                torch.bfloat16).to(idx.device)
        else:
            blocks = torch.from_numpy(raw).to(idx.device, idx.dtype)
        if blocks.shape[0]:
            idx._set_blocks(blocks, _tensor(z["block_ids"], idx.device))
        idx._slot_of = z["slot_of"]
        cg = os.path.join(path, "centroid_graph")
        if os.path.exists(cg):
            idx.centroid_index = HnswIndex.load(cg, device=idx.device)
        idx.n = meta["n"]
        idx.n_total = meta["n_total"]
        tp = os.path.join(path, "tail.npz")
        if os.path.exists(tp):
            t = np.load(tp)
            idx.tail = _tensor(t["tail"], idx.device).to(idx.dtype)
            idx.tail_sq = D.squared_norms(idx.tail)
            idx.tail_ids = _tensor(t["tail_ids"], idx.device)
            idx.tail_n = int(t["tail_n"])
            idx.tail_live = int((t["tail_ids"] >= 0).sum())
        return idx

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        comp = {}
        for name in ("blocks", "blocks_sq", "blocks_score", "block_ids",
                     "score_scale", "centroids", "centroids_sq"):
            a = getattr(self, name)
            if a is not None and not (name == "blocks_score"
                                      and a is self.blocks):
                comp[name] = a.numel() * a.element_size()
        if self.centroid_index is not None:
            comp["centroid_graph"] = self.centroid_index.stats()[
                "memory_total_bytes"]
        total = sum(comp.values())
        return {
            "n": self.n,
            "tail_n": self.tail_n,
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "dim": self.cfg.dim,
            "dtype": self.cfg.dtype,
            "score_dtype": self.score_dtype,
            "routing": "graph" if self._use_graph_routing() else "exact",
            "device": str(self.device),
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total / max(self.size, 1), 1),
            "fill_factor": round(
                self.n / max(self.n_blocks * self.block_size, 1), 4),
            **({"build_stats": self.build_stats} if self.build_stats else {}),
        }
