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

NAME = "expand_score"
#: the largest r the fused entry takes; above it callers take the
#: all-scores entry and a keyed top-r
TOPR_MAX_R = 128
#: the largest block size the fused entry takes (one pass of 256 rows)
TOPR_MAX_S = 256

_P = ctypes.c_void_p
_I, _LL = ctypes.c_int, ctypes.c_longlong
_COMMON = [_I, _I] + [_P] * 12
_SCORE_ARGS = _COMMON + [_LL, _LL, _I, _I, _I, _I, _P]
_TOPR_ARGS = _COMMON + [_LL, _LL, _I, _I, _I, _I, _I, _P, _P, _I, _P]
_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MERGE_MAX_C = 1024    # candidates a query the in-kernel merge takes
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


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_row_info_aligned(entry, S, blocks_sq, block_ids, allowed):
    """The scorer copies a run's row ids, norms and filter bytes with
    cp.async, 16 bytes a copy when S % 16 == 0 and else 4 (the filter bytes
    only when S % 4 == 0): each source must be aligned to its copy."""
    width = 16 if S % 16 == 0 else 4
    tensors = [("blocks_sq", blocks_sq), ("block_ids", block_ids)]
    if allowed is not None and S % 4 == 0:
        tensors.append(("allowed", allowed))
    for name, t in tensors:
        if t.data_ptr() % width:
            raise ValueError(f"{entry}: {name} must be {width}-byte aligned "
                             f"at S={S}")


def _library():
    return _nvcc.load_library(NAME, {"expand_score_launch": _SCORE_ARGS,
                                     "expand_topr_launch": _TOPR_ARGS})


def _operands(entry, blocks, blocks_sq, block_ids, q, q_sq, bids, metric,
              q8, q_scale, score_scale, allowed):
    """Checked launch operands shared by both entries: (mode, copy width,
    the pointer arguments of either C entry through the grouping scratch,
    tensors to keep alive, (B, Q, p, S, row bytes))."""
    if blocks.device.type != "cuda":
        raise ValueError(f"{entry}: no kernel for {blocks.device}")
    if blocks.dtype not in _MODES:
        raise TypeError(f"{entry}: unsupported block dtype {blocks.dtype}")
    dev = blocks.device
    B, S, dp = blocks.shape
    Q, p = bids.shape
    if Q * p >= 1 << 31 or p * S >= 1 << 31:
        raise ValueError(f"{entry}: Q * p and p * S must be below 2^31")
    _check("blocks", blocks, blocks.dtype, (B, S, dp), dev)
    _check("blocks_sq", blocks_sq, torch.float32, (B, S), dev)
    _check("block_ids", block_ids, torch.int32, (B, S), dev)
    _check("q_sq", q_sq, torch.float32, (Q,), dev)
    _check("q", q, torch.float32, (Q, dp), dev)
    if bids.device != dev:
        raise ValueError(f"bids: expected device {dev}, got {bids.device}")
    if allowed is not None:
        _check("allowed", allowed, torch.bool, (B, S), dev)
    _check_row_info_aligned(entry, S, blocks_sq, block_ids, allowed)
    if blocks.dtype == torch.int8:
        if q8 is None or q_scale is None or score_scale is None:
            raise ValueError("int8 blocks need q8, q_scale and score_scale")
        _check("q8", q8, torch.int8, (Q, dp), dev)
        _check("q_scale", q_scale, torch.float32, (Q,), dev)
        _check("score_scale", score_scale, torch.float32, (B,), dev)
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
    # the pairs grouped by block in the launch (a counting sort on the
    # device: no host synchronisation)
    grouped = torch.empty(2 * P, dtype=torch.int32, device=dev)
    keep = (q_op, flat, grouped)  # alive until the launch is enqueued
    args = [blocks.data_ptr(), blocks_sq.data_ptr(), block_ids.data_ptr(),
            None if allowed is None else allowed.data_ptr(),
            q_op.data_ptr(), q_sq.data_ptr(), qs_ptr, ss_ptr,
            flat.data_ptr(), grouped.data_ptr(), grouped.data_ptr() + 4 * P]
    return _MODES[blocks.dtype], vec, args, keep, (B, Q, p, S, row_bytes)


def _launch(fn: str, dev, args) -> None:
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: cudaError {err}")


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
    _launch("expand_score_launch", blocks.device,
            [mode, vec] + args
            + [out.data_ptr(), B, Q * p, p, S, row_bytes,
               int(metric is Metric.L2)])
    LAUNCHES += 1
    return out


def expand_topr(blocks, blocks_sq, block_ids, q, q_sq, bids, metric: Metric,
                r: int, *, q8=None, q_scale=None, score_scale=None,
                allowed=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's ``min(r, p * S)`` best rows of its ``p`` blocks: (scores
    ``[Q, r]`` f32 ascending, positions ``[Q, r]`` int64 into the query's
    ``[p * S]`` expansion), ordered by (score, position). Arguments as
    :func:`expand_score`; ``fused_topr(r, S)`` must hold. On the card each
    (query, probe) pair keeps its ``min(r, S)`` smallest keys in the kernel
    and a merge kernel orders each query's ``p`` lists (``torch.topk``
    where they hold more than ``_MERGE_MAX_C`` keys)."""
    global LAUNCHES, TOPR_LAUNCHES
    S = blocks.shape[1]
    if not fused_topr(r, S):
        raise ValueError(f"expand_topr: need 1 <= r <= {TOPR_MAX_R} and "
                         f"S <= {TOPR_MAX_S}, got r={r}, S={S}")
    if blocks.device.type == "cpu":
        return expand_topr_reference(
            blocks, blocks_sq, block_ids, q, q_sq, bids, metric, r, q8=q8,
            q_scale=q_scale, score_scale=score_scale, allowed=allowed)
    mode, vec, args, _keep, (B, Q, p, S, row_bytes) = _operands(
        "expand_topr", blocks, blocks_sq, block_ids, q, q_sq, bids, metric,
        q8, q_scale, score_scale, allowed)
    R = min(r, S)
    rq = min(r, p * S)
    dev = blocks.device
    keys = torch.empty((Q, p * R), dtype=torch.int64, device=dev)
    merge = p * R <= _MERGE_MAX_C  # else more candidates than it holds
    top = (torch.empty((Q, rq), dtype=torch.float32, device=dev),
           torch.empty((Q, rq), dtype=torch.int64, device=dev))
    _launch("expand_topr_launch", dev,
            [mode, vec] + args
            + [keys.data_ptr(), B, Q * p, p, S, row_bytes,
               int(metric is Metric.L2), R]
            + ([top[0].data_ptr(), top[1].data_ptr()] if merge
               else [None, None]) + [rq])
    LAUNCHES += 1
    TOPR_LAUNCHES += 1
    if merge:
        return top
    return T.decode_score_keys(torch.topk(keys, rq, dim=1, largest=False,
                                          sorted=True).values)
