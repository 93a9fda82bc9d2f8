"""Block-expansion scoring: the CUDA kernel's two entries and their plain
versions.

Port of ``tpu_hnsw/ops/pallas_expand.py::expand_score``, widened to the
scoring copies the reference serves through XLA (``block.py:127-130``,
``block.py:181-200``): f32, bf16 and int8 rows. Two entries:

- :func:`expand_score`: every row's score, ``[Q, p, S]`` f32;
- :func:`expand_topr`: the stage-1 top-r of ``block.py:210-212`` fused in:
  each query's ``r`` best rows of its ``p * S``, ascending by (score,
  position), without a ``[Q, p, S]`` matrix.

On a CUDA tensor each launches ``csrc/expand_score.cu`` or raises; on a CPU
tensor each runs its plain version (:func:`expand_score_reference`,
:func:`expand_topr_reference`). The kernel library is built by
``ops/_nvcc.py`` at first use and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import _nvcc
from tpu_hnsw_torch.ops import topk as T

#: launches of either kernel entry so far; a run resets it to show the
#: kernel was used
LAUNCHES = 0
#: launches of the fused top-r entry alone
TOPR_LAUNCHES = 0
#: the fused entry's launches by route (see :func:`topr_route`)
TOPR_ROUTE_LAUNCHES = {"grouped": 0, "ring": 0}

NAME = "expand_score"
#: the largest r the fused entry takes; above it callers take the
#: all-scores entry and a keyed top-r
TOPR_MAX_R = 128
#: the largest block size the fused entry takes (one pass of 256 rows)
TOPR_MAX_S = 256
#: the most keys a query the grouped route's merge holds (p * min(r, S));
#: csrc: grouped::kMergeC
GROUPED_MAX_KEYS = 1024
#: row bytes a stage of either route holds (csrc: kKC)
_SLICE_BYTES = 128

_P = ctypes.c_void_p
_I, _LL = ctypes.c_int, ctypes.c_longlong
# mode, vec; blocks .. bids and the grouping scratch (12 pointers)
_COMMON = [_I, _I] + [_P] * 12
_SIZES = [_LL, _LL, _I, _I, _I, _I]  # n_blocks, pairs, p, S, row bytes, l2
_SCORE_ARGS = _COMMON + [_P] * 2 + _SIZES + [_P]
_TOPR_ARGS = _COMMON + [_P] * 3 + _SIZES + [_I, _P, _P, _I, _P]
_GROUPED_ARGS = _COMMON + [_P] * 2 + _SIZES + [_I, _P, _P, _I, _P]
_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# int32 entries of the grouping table (csrc: 2 * kGroupCtas)
_GTAB_INTS = 128
_ERRORS = {10001: "the CUDA driver has no cuTensorMapEncodeTiled",
           10002: "cuTensorMapEncodeTiled refused the rows' tensor map"}
# elements of the gathered [chunk, p, S, dp] operand per step of the plain
# version (bounds its temporaries at main-path shapes)
_REF_CHUNK_ELEMS = 1 << 27


def expand_score_reference(blocks, blocks_sq, block_ids, q, q_sq, bids,
                           metric: Metric, *, q8=None, q_scale=None,
                           score_scale=None, allowed=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand_score` (same arguments).

    int8 dots are exact: a float64 product is exact for int8 x int8 sums
    below 2^53, so no integer matmul (which overflows in int8 and has no
    CUDA kernel in int32) is needed. bf16 rows meet the bf16-rounded query
    in f32, where each product is exact.
    """
    Q, p = bids.shape
    B, S, dp = blocks.shape
    out = torch.empty((Q, p, S), dtype=torch.float32, device=blocks.device)
    step = max(1, _REF_CHUNK_ELEMS // max(p * S * dp, 1))
    for s in range(0, Q, step):
        raw = bids[s:s + step].long()
        bad = (raw < 0) | (raw >= B)
        b = torch.where(bad, 0, raw)
        g = blocks[b]                                   # [c, p, S, dp]
        if blocks.dtype == torch.int8:
            qv = q8[s:s + step].double()[:, None, :, None]
            dots = (g.double() @ qv)[..., 0].float() * (
                q_scale[s:s + step][:, None, None]
                * score_scale[b][:, :, None])
        elif blocks.dtype == torch.bfloat16:
            qv = q[s:s + step].to(torch.bfloat16).float()[:, None, :, None]
            dots = (g.float() @ qv)[..., 0]
        else:
            qv = q[s:s + step].float()[:, None, :, None]
            dots = (g.float() @ qv)[..., 0]
        if metric is Metric.L2:
            sc = torch.clamp_min(
                q_sq[s:s + step][:, None, None] + blocks_sq[b] - 2.0 * dots,
                0.0)
        else:
            sc = -dots
        dead = (block_ids[b] < 0) | bad[:, :, None]
        if allowed is not None:
            dead |= ~allowed[b]
        out[s:s + step] = torch.where(dead, torch.inf, sc)
    return out


def topr_of_scores(scores: torch.Tensor, r: int):
    """The smallest ``min(r, p * S)`` of each query's ``[p, S]`` scores
    (``scores [Q, p, S]``), ascending by (score, position): (f32 scores,
    int64 positions ``j * S + s``)."""
    flat = scores.reshape(scores.shape[0], -1)
    return T.topk_smallest_by_index(flat, min(r, flat.shape[1]))


def expand_topr_reference(blocks, blocks_sq, block_ids, q, q_sq, bids,
                          metric: Metric, r: int, **kw):
    """Plain PyTorch version of :func:`expand_topr` (same arguments):
    every score, then the smallest ``min(r, p * S)`` keys."""
    return topr_of_scores(expand_score_reference(
        blocks, blocks_sq, block_ids, q, q_sq, bids, metric, **kw), r)


def fused_topr(r: int, S: int) -> bool:
    """Whether :func:`expand_topr` takes a stage-1 width ``r`` over blocks
    of ``S`` rows (otherwise the caller takes the all-scores entry)."""
    return 1 <= r <= TOPR_MAX_R and S <= TOPR_MAX_S


def topr_routes(p: int, r: int, S: int) -> tuple[str, ...]:
    """The routes :func:`expand_topr` can take at ``p`` probes, width ``r``
    and blocks of ``S`` rows: the ring always, and the grouped route where
    a query's ``p * min(r, S)`` keys fit its merge."""
    if p * min(r, S) <= GROUPED_MAX_KEYS:
        return ("grouped", "ring")
    return ("ring",)


def topr_route(Q: int, p: int, r: int, B: int, S: int,
               row_bytes: int) -> str:
    """The kernel route of :func:`expand_topr` for ``Q`` queries of ``p``
    probes into ``B`` blocks of ``S`` rows of ``row_bytes`` bytes.

    ``"grouped"`` (CTAs of 32 grouped pairs, two an SM, each pair's r keys
    merged by a second kernel) where a query's ``p * min(r, S)`` keys fit its
    merge and the table's blocks are probed more than once a 128-byte row
    slice on average (``Q * p > B * slices``): there a block's load feeds
    several pairs' selects, which that design overlaps with the other CTA's
    loads. ``"ring"`` (persistent CTAs on a TMA ring, the threshold select)
    otherwise: blocks mostly probed once, or wide rows, where bytes set the
    time, and any number of keys a query."""
    slices = -(-row_bytes // _SLICE_BYTES)
    if "grouped" in topr_routes(p, r, S) and Q * p > B * slices:
        return "grouped"
    return "ring"


def _check_row_info_aligned(entry, S, blocks_sq, block_ids, allowed):
    """The scorer copies a block's row ids, norms and filter bytes 16 bytes
    at a time (bulk copies in the fused entry) when S % 16 == 0 and else 4
    (the filter bytes only when S % 4 == 0): each source must be aligned to
    its copy."""
    width = 16 if S % 16 == 0 else 4
    tensors = [("blocks_sq", blocks_sq), ("block_ids", block_ids)]
    if allowed is not None and S % 4 == 0:
        tensors.append(("allowed", allowed))
    for name, t in tensors:
        if t.data_ptr() % width:
            raise ValueError(f"{entry}: {name} must be {width}-byte aligned "
                             f"at S={S}")


def _library():
    return _nvcc.load_library(NAME, {
        "expand_score_launch": _SCORE_ARGS,
        "expand_topr_launch": _TOPR_ARGS,
        "expand_topr_grouped_launch": _GROUPED_ARGS})


#: the scratch pointers each launch takes after the grouping table
_SCRATCH_ARGS = {None: ("gbid",), "grouped": ("gbid", "keys"),
                 "ring": ("thresh", "count", "cand")}


def _scratch_offsets(P: int, Q: int = 0, C: int = 0,
                     route: str | None = None) -> tuple[dict, int]:
    """Byte offsets of a launch's scratch in one buffer: the pairs grouped
    by block (int32 ``[P]``), the work items (int4 ``[P]``, 16-byte
    aligned) and the grouping table (int32 ``[_GTAB_INTS]``); then for the
    all-scores entry (``route`` None) the grouped pairs' block ids (int32
    ``[P]``); for the fused entry's grouped route also each pair's keys
    (int64 ``[Q, C]``, ``C = p * min(r, S)``); for its ring route, with ``C
    = p * cap`` candidate slots a query, each query's threshold key (uint64
    ``[Q]``), each pair's candidate count (int32 ``[P]``) and each pair's
    candidate keys (uint64 ``[P, cap]``, that is ``[Q, C]``). Returns
    (offsets, total bytes)."""
    def up(n, a):
        return (n + a - 1) // a * a

    off = {"gpair": 0, "items": up(4 * P, 16)}
    off["gtab"] = off["items"] + 16 * P
    end = off["gtab"] + 4 * _GTAB_INTS
    if route == "ring":
        off["thresh"] = up(end, 8)
        off["count"] = off["thresh"] + 8 * Q
        off["cand"] = up(off["count"] + 4 * P, 8)
        return off, off["cand"] + 8 * Q * C
    off["gbid"] = end
    end += 4 * P
    if route == "grouped":
        off["keys"] = up(end, 8)
        end = off["keys"] + 8 * Q * C
    return off, end


def _pair_slots(R: int, S: int) -> int:
    """Candidate slots a (query, probe) pair has in the fused entry: it
    keeps at most ``min(2R, S)`` keys (csrc: ``Args::cap``)."""
    return min(2 * R, S)


def _operands(entry, blocks, blocks_sq, block_ids, q, q_sq, bids, metric,
              q8, q_scale, score_scale, allowed, C: int = 0,
              route: str | None = None):
    """Checked launch operands shared by both entries: (mode, copy width,
    the pointer arguments of a C entry through its scratch (``route`` and
    ``C`` as :func:`_scratch_offsets`'s), tensors to keep alive, (B, Q, p,
    S, row bytes))."""
    if blocks.device.type != "cuda":
        raise ValueError(f"{entry}: no kernel for {blocks.device}")
    if blocks.dtype not in _MODES:
        raise TypeError(f"{entry}: unsupported block dtype {blocks.dtype}")
    dev = blocks.device
    B, S, dp = blocks.shape
    Q, p = bids.shape
    if Q * p >= 1 << 31 or p * S >= 1 << 31:
        raise ValueError(f"{entry}: Q * p and p * S must be below 2^31")
    _nvcc.check("blocks", blocks, blocks.dtype, (B, S, dp), dev)
    _nvcc.check("blocks_sq", blocks_sq, torch.float32, (B, S), dev)
    _nvcc.check("block_ids", block_ids, torch.int32, (B, S), dev)
    _nvcc.check("q_sq", q_sq, torch.float32, (Q,), dev)
    _nvcc.check("q", q, torch.float32, (Q, dp), dev)
    if bids.device != dev:
        raise ValueError(f"bids: expected device {dev}, got {bids.device}")
    if allowed is not None:
        _nvcc.check("allowed", allowed, torch.bool, (B, S), dev)
    _check_row_info_aligned(entry, S, blocks_sq, block_ids, allowed)
    if blocks.dtype == torch.int8:
        if q8 is None or q_scale is None or score_scale is None:
            raise ValueError("int8 blocks need q8, q_scale and score_scale")
        _nvcc.check("q8", q8, torch.int8, (Q, dp), dev)
        _nvcc.check("q_scale", q_scale, torch.float32, (Q,), dev)
        _nvcc.check("score_scale", score_scale, torch.float32, (B,), dev)
        q_op, qs_ptr, ss_ptr = q8, q_scale.data_ptr(), score_scale.data_ptr()
    else:
        q_op = q.to(blocks.dtype)  # bf16 rows meet a bf16-rounded query
        qs_ptr = ss_ptr = None
    row_bytes = dp * blocks.element_size()
    if row_bytes % 4 or blocks.data_ptr() % 4 or q_op.data_ptr() % 4:
        raise ValueError(f"{entry}: rows must be 4-byte multiples and "
                         "4-byte aligned")
    vec = 16 if (row_bytes % 16 == 0 and blocks.data_ptr() % 16 == 0
                 and q_op.data_ptr() % 16 == 0) else 4
    P = Q * p
    flat = bids.reshape(-1).to(torch.int64).contiguous()
    # the pairs grouped by block and cut into work items in the launch (a
    # counting sort on the device: no host synchronisation)
    off, nbytes = _scratch_offsets(P, Q, C, route)
    work = torch.empty((nbytes + 7) // 8, dtype=torch.int64, device=dev)
    keep = (q_op, flat, work)  # alive until the launch is enqueued
    at = work.data_ptr()
    args = [blocks.data_ptr(), blocks_sq.data_ptr(), block_ids.data_ptr(),
            None if allowed is None else allowed.data_ptr(),
            q_op.data_ptr(), q_sq.data_ptr(), qs_ptr, ss_ptr,
            flat.data_ptr()] + [at + off[k] for k in ("gpair", "items",
                                                       "gtab")]
    args += [at + off[k] for k in _SCRATCH_ARGS[route]]
    return _MODES[blocks.dtype], vec, args, keep, (B, Q, p, S, row_bytes)


def expand_score(blocks, blocks_sq, block_ids, q, q_sq, bids, metric: Metric,
                 *, q8=None, q_scale=None, score_scale=None,
                 allowed=None) -> torch.Tensor:
    """Scores of every row of every selected block: ``[Q, p, S]`` f32.

    blocks ``[B, S, dp]`` f32, bf16 or int8; blocks_sq ``[B, S]`` f32;
    block_ids ``[B, S]`` int32 (-1 dead/pad -> +inf); q ``[Q, dp]`` f32;
    q_sq ``[Q]`` f32; bids ``[Q, p]`` block ids (outside ``[0, B)``: every
    row +inf). int8 rows also take ``q8 [Q, dp]`` int8, ``q_scale [Q]`` and
    ``score_scale [B]`` f32 (dot = int dot * q_scale * score_scale). L2
    scores are ``max(q_sq + x_sq - 2 dot, 0)``, IP and cosine ``-dot``.
    ``allowed`` ``[B, S]`` bool (the filter) scores a disallowed row +inf,
    as a ``block_ids < 0`` row is.
    """
    global LAUNCHES
    if blocks.device.type == "cpu":
        return expand_score_reference(
            blocks, blocks_sq, block_ids, q, q_sq, bids, metric, q8=q8,
            q_scale=q_scale, score_scale=score_scale, allowed=allowed)
    mode, vec, args, _keep, (B, Q, p, S, row_bytes) = _operands(
        "expand_score", blocks, blocks_sq, block_ids, q, q_sq, bids, metric,
        q8, q_scale, score_scale, allowed)
    out = torch.empty((Q, p, S), dtype=torch.float32, device=blocks.device)
    _nvcc.launch(_library(), "expand_score_launch", blocks.device, mode, vec,
                 *args, out.data_ptr(), B, Q * p, p, S, row_bytes,
                 int(metric is Metric.L2), errors=_ERRORS)
    LAUNCHES += 1
    return out


def expand_topr(blocks, blocks_sq, block_ids, q, q_sq, bids, metric: Metric,
                r: int, *, q8=None, q_scale=None, score_scale=None,
                allowed=None, route: str | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's ``min(r, p * S)`` best rows of its ``p`` blocks: (scores
    ``[Q, r]`` f32 ascending, positions ``[Q, r]`` int64 into the query's
    ``[p * S]`` expansion), ordered by (score, position). Arguments as
    :func:`expand_score`; ``fused_topr(r, S)`` must hold. On the card the
    kernel takes ``route`` (``"grouped"`` or ``"ring"``; None: the one
    :func:`topr_route` picks). The grouped route writes each (query, probe)
    pair's ``min(r, S)`` keys and merges a query's (at most
    ``GROUPED_MAX_KEYS``); on the ring each pair keeps only its keys at or
    below its query's running bound on the r-th key (at most
    ``_pair_slots(r, S)``), and a select kernel orders each query's
    ``min(r, p * S)`` smallest, whatever their count."""
    global LAUNCHES, TOPR_LAUNCHES
    S = blocks.shape[1]
    if not fused_topr(r, S):
        raise ValueError(f"expand_topr: need 1 <= r <= {TOPR_MAX_R} and "
                         f"S <= {TOPR_MAX_S}, got r={r}, S={S}")
    if route not in (None, "grouped", "ring"):
        raise ValueError(f"expand_topr: unknown route {route!r}")
    p = bids.shape[1]
    R = min(r, S)
    if route is not None and route not in topr_routes(p, r, S):
        raise ValueError(f"expand_topr: the grouped route merges at most "
                         f"{GROUPED_MAX_KEYS} keys a query, got p * "
                         f"min(r, S) = {p * R}")
    if blocks.device.type == "cpu":
        return expand_topr_reference(
            blocks, blocks_sq, block_ids, q, q_sq, bids, metric, r, q8=q8,
            q_scale=q_scale, score_scale=score_scale, allowed=allowed)
    if route is None:
        route = topr_route(bids.shape[0], p, r, blocks.shape[0], S,
                           blocks.shape[2] * blocks.element_size())
    C = p * (R if route == "grouped" else _pair_slots(R, S))
    mode, vec, args, _keep, (B, Q, p, S, row_bytes) = _operands(
        "expand_topr", blocks, blocks_sq, block_ids, q, q_sq, bids, metric,
        q8, q_scale, score_scale, allowed, C=C, route=route)
    rq = min(r, p * S)
    dev = blocks.device
    top = (torch.empty((Q, rq), dtype=torch.float32, device=dev),
           torch.empty((Q, rq), dtype=torch.int64, device=dev))
    entry = ("expand_topr_grouped_launch" if route == "grouped"
             else "expand_topr_launch")
    _nvcc.launch(_library(), entry, dev, mode, vec, *args, B, Q * p, p, S,
                 row_bytes, int(metric is Metric.L2), R, top[0].data_ptr(),
                 top[1].data_ptr(), rq, errors=_ERRORS)
    LAUNCHES += 1
    TOPR_LAUNCHES += 1
    TOPR_ROUTE_LAUNCHES[route] += 1
    return top
