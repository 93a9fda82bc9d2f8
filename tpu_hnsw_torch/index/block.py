"""BlockHnswIndex — cluster-blocked level 0 (port of
``tpu_hnsw/index/block.py``: exact centroid routing, build and serve).

Vectors are k-means clustered and packed into ``[B, S, d]`` blocks of S
spatially close rows. A query scores the B block centroids (one ``[Q, B]``
GEMM), keeps its ``probes`` nearest blocks, and expands them: every row of
each selected block is scored by the ``expand_score`` kernel
(``ops/expand.py``) from a reduced-precision scoring copy (int8 with
per-block scales by default, or bf16); the best ``rerank_width`` rows per
query are re-scored exactly in f32 from the stored blocks and the top-k
returned. ``two_stage=False`` scores the stored blocks directly.

Not ported yet (each raises ``NotImplementedError`` naming its roadmap
item): graph routing over the centroid HNSW (B > EXACT_ROUTING_MAX),
add/delete/compact and the spill tail, the filtered scan,
search_iterative, save/load.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from tpu_hnsw_torch.config import HnswConfig, Metric, validate_ef_search
from tpu_hnsw_torch.index import flat as FL
from tpu_hnsw_torch.ops import distance as D
from tpu_hnsw_torch.ops import expand as X
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.parallel import kmeans as KM

#: the kernel loads 16 bytes at a time; scoring-copy rows are padded to it
ROW_ALIGN_BYTES = 16
_NEXT_SLICE = "ROADMAP queue 1, slice 1 item 8 (mutation, filter, persistence)"


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
    """Positions in the ``[Q, p*S]`` expansion -> flat slots (block*S + s)."""
    return torch.gather(bids, 1, torch.div(sel, S, rounding_mode="floor")) * S + sel % S


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _expand_blocks(blocks, blocks_sq, block_ids, q, q_sq, bids, *, k: int,
                   metric: Metric):
    """Single-stage expansion (block.py:106-145): score every row of each
    query's selected blocks from the stored blocks, return the top-k as
    (scores ``[Q, k]`` ascending, ids ``[Q, k]``, -1 padded)."""
    Q, p = bids.shape
    S = blocks.shape[1]
    sc = X.expand_score(blocks, blocks_sq, block_ids, q, q_sq, bids, metric)
    vals, sel = T.topk_smallest_fast(sc.reshape(Q, p * S), k)
    ids = block_ids.reshape(-1)[_slots_of(bids, sel, S)]
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def _expand_blocks_2stage(blocks_score, blocks_sq, block_ids, flat_exact, q,
                          q_sq, bids, *, k: int, rerank: int, metric: Metric,
                          score_scale=None):
    """Two-stage expansion (block.py:153-237): the kernel scores the
    selected blocks from the int8 (``score_scale`` given) or bf16 copy, the
    best ``rerank`` rows per query are re-scored exactly in f32 from
    ``flat_exact [B*S, d]``, and the top-k is returned."""
    Q, p = bids.shape
    S, dp = blocks_score.shape[1], blocks_score.shape[2]
    qp = _pad_cols(q, dp)  # zero columns change neither dots nor norms
    if score_scale is not None:
        q8, q_scl = _quantize_rows(qp)
        sc = X.expand_score(blocks_score, blocks_sq, block_ids, qp, q_sq,
                            bids, metric, q8=q8, q_scale=q_scl,
                            score_scale=score_scale)
    else:
        sc = X.expand_score(blocks_score, blocks_sq, block_ids, qp, q_sq,
                            bids, metric)
    r = min(rerank, p * S)
    _, sel = T.topk_smallest_fast(sc.reshape(Q, p * S), r)
    slots = _slots_of(bids, sel, S)
    cand_ids = block_ids.reshape(-1)[slots]
    v = flat_exact[slots].float()                     # [Q, r, d]
    dots2 = (v @ q[:, :, None])[..., 0]
    if metric is Metric.L2:
        vsq = (v * v).sum(-1)
        sc2 = torch.clamp_min(q_sq[:, None] + vsq - 2.0 * dots2, 0.0)
    else:
        sc2 = -dots2
    sc2 = torch.where(cand_ids < 0, torch.inf, sc2)
    vals, sel2 = T.topk_smallest(sc2, k)
    ids = torch.gather(cand_ids, 1, sel2)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def _route_exact(centroids, c_sq, q, q_sq, *, p: int, metric: Metric):
    """Exact top-p blocks per query (block.py:287-306): one ``[Q, B]``
    GEMM (a library GEMM, in f32) + top-p."""
    dots = q.to(centroids.dtype).float() @ centroids.float().T
    if metric is Metric.L2:
        sc = q_sq[:, None] + c_sq[None, :] - 2.0 * dots
    else:
        sc = -dots
    return T.topk_smallest_fast(sc, p)[1]


def _serve_exact(blocks, blocks_score, blocks_sq, block_ids, centroids, c_sq,
                 q, score_scale=None, *, k: int, probes: int, rerank: int,
                 metric: Metric, two_stage: bool):
    """The exact-routing serving step (block.py:245-284): query norms ->
    centroid routing -> block expansion (+ rerank) -> operator units."""
    q = q.float()
    q_sq = D.squared_norms(q)
    bids = _route_exact(centroids, c_sq, q, q_sq, p=probes, metric=metric)
    if two_stage:
        sc, ids = _expand_blocks_2stage(
            blocks_score, blocks_sq, block_ids,
            blocks.reshape(-1, blocks.shape[-1]), q, q_sq, bids, k=k,
            rerank=rerank, metric=metric, score_scale=score_scale)
    else:
        sc, ids = _expand_blocks(blocks, blocks_sq, block_ids, q, q_sq, bids,
                                 k=k, metric=metric)
    return D.score_to_distance(sc, metric), ids


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

    cand_d, cand_i = score_all(None)
    _sync(xt.device)
    t1 = time.perf_counter()
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


def _tensor(a, device) -> torch.Tensor:
    """numpy array (including ml_dtypes bfloat16) -> tensor on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


class BlockHnswIndex:
    """HNSW index with cluster-blocked level 0, exact centroid routing.

    ``block_size`` is the level-0 granularity S. ``routing``: "exact"
    scans all centroids at any block count; "auto" does so while
    B <= EXACT_ROUTING_MAX and would switch to graph routing above it,
    which is not ported ("graph" likewise). ``device`` holds every
    tensor of the index (CPU runs the kernel's plain version). Attributes
    ``two_stage`` (scoring copy + exact rerank), ``rerank_width`` (rows per
    query kept by stage 1) and ``score_dtype`` ("int8" | "bf16", the
    scoring copy made at build) may be set before ``build``.
    """

    EXACT_ROUTING_MAX = 65536
    # above this block count, probes >= n_blocks streams the whole store
    # once instead of expanding every block for every query
    EXHAUSTIVE_SCAN_MIN_BLOCKS = 2048
    #: stage-1 candidate rows per unit of ef_search (block.py:810-815)
    ROWS_PER_EF = 64

    def __init__(self, config: HnswConfig, block_size: int = 256,
                 routing: str = "auto", block_slack: float = 1.05,
                 device=None):
        if routing not in ("auto", "exact", "graph"):
            raise ValueError("routing must be auto|exact|graph")
        if routing == "graph":
            raise NotImplementedError(
                "graph routing: ROADMAP queue 1, slice 2 (graph engine)")
        if config.metric not in (Metric.L2, Metric.IP, Metric.COSINE):
            raise ValueError(f"{config.metric} unsupported by BlockHnswIndex")
        self.cfg = config
        self.block_size = int(block_size)
        self.routing = routing
        self.device = torch.device(device or "cpu")
        self.two_stage = True
        self.rerank_width = 40
        self.score_dtype = "int8"
        # packing slack: at exact capacity the balanced packer strands rows
        # in arbitrary leftover blocks, a probe-independent recall floor
        self.block_slack = float(block_slack)
        self.n = 0
        self.n_blocks = 0
        self.blocks = None        # [B, S, d] storage dtype
        self.blocks_sq = None     # [B, S] f32
        self.block_ids = None     # [B, S] int32, -1 = pad
        self.blocks_score = None  # [B, S, dp] int8 | bf16 scoring copy
        self.score_scale = None   # [B] f32 per-block dequant (int8 copy)
        self.centroids = None     # [B, d] storage dtype
        self.centroids_sq = None  # [B] f32
        self.build_stats = {}

    # ------------------------------------------------------------------ util
    @property
    def size(self) -> int:
        return self.n

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

    def probes_for_ef(self, ef_search: int) -> int:
        """Map the ef_search GUC onto a block-probe count: ``ROWS_PER_EF``
        scanned rows per unit of ef, compensated for block slack."""
        p = math.ceil(self.ROWS_PER_EF * ef_search / self.block_size)
        p += int((self.block_slack - 1) * p + 0.5)
        return max(1, min(p, self.n_blocks))

    # ----------------------------------------------------------------- build
    def build(self, data, kmeans_iters: int = 10) -> "BlockHnswIndex":
        """CREATE INDEX analogue: k-means, balanced pack, install. ``data``
        is an ``[n, d]`` array or tensor (a tensor is used where it lies
        when that is the index's device). Stage times land in
        ``self.build_stats``."""
        if self.score_dtype not in ("int8", "bf16"):
            raise ValueError("score_dtype must be int8|bf16")
        t0 = time.perf_counter()
        device_input = isinstance(data, torch.Tensor)
        if device_input:
            if data.ndim != 2 or data.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not "
                    f"{data.shape[-1] if data.ndim else 0}")
            xt = data.to(self.device, self.dtype)
            if not bool(torch.isfinite(xt).all()):
                raise ValueError("NaN or infinity values are not allowed")
            if self.cfg.metric.needs_normalized:
                xt = D.l2_normalize(xt)
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
        self._install_blocks(block_ids, xt)
        _sync(self.device)
        t3 = time.perf_counter()
        self.build_stats = {
            "prep_s": round(t1 - t0, 3),
            "cluster_pack_s": round(t2 - t1, 3),
            "install_s": round(t3 - t2, 3),
            **self._pack_stats,
            "device_resident_input": device_input,
            "total_s": round(t3 - t0, 3),
            "vectors_per_sec": round(n / max(t3 - t0, 1e-9), 1),
        }
        return self

    def _pack(self, xt: torch.Tensor, kmeans_iters: int) -> torch.Tensor:
        """Cluster + capacity-balanced packing: ``[B, S]`` int32 ids."""
        n = xt.shape[0]
        S = self.block_size
        B = max(1, math.ceil(n * self.block_slack / S))
        if self.routing == "auto" and B > self.EXACT_ROUTING_MAX:
            raise NotImplementedError(
                f"{B} blocks need graph routing: ROADMAP queue 1, slice 2")
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
        assign, assign_stats = _balanced_assign_device(xt, centroids, S, B)
        self._pack_stats = {
            "kmeans_s": round(ta - tk, 3),
            "balanced_assign_s": round(time.perf_counter() - ta, 3),
            **assign_stats,
        }
        return _pack_block_ids_device(assign, S=S, B=B)

    def _install_blocks(self, block_ids: torch.Tensor, xt: torch.Tensor):
        """Gather the packed blocks, their norms, centroids and scoring copy."""
        S = self.block_size
        B = block_ids.shape[0]
        valid = (block_ids >= 0).reshape(-1, 1)
        # gather + mask in place: no second corpus-sized temporary
        blocks = xt.index_select(0, torch.clamp_min(block_ids, 0).reshape(-1))
        blocks = blocks.to(self.dtype).mul_(valid).reshape(B, S, -1)
        counts = torch.clamp_min(valid.reshape(B, S).float().sum(1), 1.0)
        cents = blocks.float().sum(1) / counts[:, None]
        self.blocks = blocks
        self.blocks_sq = D.squared_norms(blocks)
        self.blocks_score, self.score_scale = _make_score_copy(
            blocks, self.score_dtype)
        self.block_ids = block_ids
        self.centroids = cents.to(self.dtype)
        self.centroids_sq = (cents * cents).sum(-1)
        self.n_blocks = B
        self.n = int(xt.shape[0])

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
        idx.n_blocks = B
        return idx

    # ---------------------------------------------------------------- search
    def search_device(self, queries, k: int = 10, ef_search: int = 40,
                      probes: int | None = None, filter_mask=None):
        """Device-resident search. Returns (distances, ids) tensors in
        pgvector operator units; missing ids are -1. A tensor of queries
        is not validated (finite values are the caller's job)."""
        validate_ef_search(max(ef_search, 1))
        if filter_mask is not None:
            raise NotImplementedError(f"filter_mask: {_NEXT_SLICE}")
        if self.n_blocks == 0:
            raise ValueError("index is empty")
        if probes is None:
            probes = self.probes_for_ef(max(ef_search, k))
        probes = max(1, min(probes, self.n_blocks))
        if isinstance(queries, torch.Tensor):
            qt = queries.to(self.device, torch.float32).contiguous()
            if qt.ndim == 1:
                qt = qt[None]
            if qt.shape[1] != self.cfg.dim:
                raise ValueError(
                    f"expected {self.cfg.dim} dimensions, not {qt.shape[1]}")
            if self.cfg.metric.needs_normalized:
                qt = D.l2_normalize(qt)
        else:
            qt = self._upload(self._prep(queries))
        if (probes >= self.n_blocks
                and self.n_blocks > self.EXHAUSTIVE_SCAN_MIN_BLOCKS):
            sc, ids = self._scan_all(qt, k)
            return D.score_to_distance(sc, self.cfg.metric), ids
        return _serve_exact(
            self.blocks, self.blocks_score, self.blocks_sq, self.block_ids,
            self.centroids, self.centroids_sq, qt, self.score_scale, k=k,
            probes=probes, rerank=max(self.rerank_width, k),
            metric=self.cfg.metric, two_stage=self.two_stage)

    def _scan_all(self, qt, k: int):
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
        _, pos = FL._stream_search(
            _pad_cols(qt, dp), scan_src.reshape(-1, dp),
            self.blocks_sq.reshape(-1), valid, cand, self.cfg.metric,
            FL.FlatIndex.BLOCK)
        bad = pos < 0
        safe = torch.clamp_min(pos, 0)
        v = self.blocks.reshape(-1, d)[safe]
        sc2 = torch.where(bad, torch.inf,
                          D.batched_scores(qt, v, self.cfg.metric))
        vals, sel = T.topk_smallest(sc2, k)
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

    def search_iterative(self, *args, **kwargs):
        raise NotImplementedError(f"search_iterative: {_NEXT_SLICE}")

    def add(self, data):
        raise NotImplementedError(f"add (spill tail): {_NEXT_SLICE}")

    def delete(self, ids):
        raise NotImplementedError(f"delete: {_NEXT_SLICE}")

    def compact(self):
        raise NotImplementedError(f"compact: {_NEXT_SLICE}")

    def save(self, path: str):
        raise NotImplementedError(f"save: {_NEXT_SLICE}")

    @classmethod
    def load(cls, path: str):
        raise NotImplementedError(f"load: {_NEXT_SLICE}")

    # ----------------------------------------------------------------- stats
    def stats(self) -> dict:
        comp = {}
        for name in ("blocks", "blocks_sq", "blocks_score", "block_ids",
                     "score_scale", "centroids", "centroids_sq"):
            a = getattr(self, name)
            if a is not None and not (name == "blocks_score"
                                      and a is self.blocks):
                comp[name] = a.numel() * a.element_size()
        total = sum(comp.values())
        return {
            "n": self.n,
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "dim": self.cfg.dim,
            "dtype": self.cfg.dtype,
            "score_dtype": self.score_dtype,
            "routing": "exact",
            "device": str(self.device),
            "memory_bytes": comp,
            "memory_total_bytes": total,
            "bytes_per_element": round(total / max(self.size, 1), 1),
            "fill_factor": round(
                self.n / max(self.n_blocks * self.block_size, 1), 4),
            **({"build_stats": self.build_stats} if self.build_stats else {}),
        }
