"""Fused block-expansion scoring: the CUDA kernel and its plain version.

Port of ``tpu_hnsw/ops/pallas_expand.py::expand_score``, widened to the
scoring copies the reference serves through XLA (``block.py:127-130``,
``block.py:181-200``): f32, bf16 and int8 rows. On a CUDA tensor
:func:`expand_score` launches ``csrc/expand_score.cu`` or raises; on a CPU
tensor it runs :func:`expand_score_reference`. The kernel library is
built by ``ops/_nvcc.py`` at first use and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_hnsw_torch.config import Metric
from tpu_hnsw_torch.ops import _nvcc

#: kernel launches so far; a run resets it to show the kernel was used
LAUNCHES = 0

NAME = "expand_score"
_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
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
        b = bids[s:s + step].long()
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
        dead = block_ids[b] < 0
        if allowed is not None:
            dead |= ~allowed[b]
        out[s:s + step] = torch.where(dead, torch.inf, sc)
    return out


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


def expand_score(blocks, blocks_sq, block_ids, q, q_sq, bids, metric: Metric,
                 *, q8=None, q_scale=None, score_scale=None,
                 allowed=None) -> torch.Tensor:
    """Scores of every row of every selected block: ``[Q, p, S]`` f32.

    blocks ``[B, S, dp]`` f32, bf16 or int8; blocks_sq ``[B, S]`` f32;
    block_ids ``[B, S]`` int32 (-1 dead/pad -> +inf); q ``[Q, dp]`` f32;
    q_sq ``[Q]`` f32; bids ``[Q, p]`` block ids in ``[0, B)``. int8 rows
    also take ``q8 [Q, dp]`` int8, ``q_scale [Q]`` and ``score_scale [B]``
    f32 (dot = int dot * q_scale * score_scale). L2 scores are
    ``max(q_sq + x_sq - 2 dot, 0)``, IP and cosine ``-dot``. ``allowed``
    ``[B, S]`` bool (the filter) scores a disallowed row +inf, as a
    ``block_ids < 0`` row is.
    """
    global LAUNCHES
    if blocks.device.type == "cpu":
        return expand_score_reference(
            blocks, blocks_sq, block_ids, q, q_sq, bids, metric, q8=q8,
            q_scale=q_scale, score_scale=score_scale, allowed=allowed)
    if blocks.device.type != "cuda":
        raise ValueError(f"expand_score: no kernel for {blocks.device}")
    if blocks.dtype not in _MODES:
        raise TypeError(f"expand_score: unsupported block dtype {blocks.dtype}")
    dev = blocks.device
    B, S, dp = blocks.shape
    Q, p = bids.shape
    if Q * p >= 1 << 31:
        raise ValueError("expand_score: Q * p must be below 2^31")
    _check("blocks", blocks, blocks.dtype, (B, S, dp), dev)
    _check("blocks_sq", blocks_sq, torch.float32, (B, S), dev)
    _check("block_ids", block_ids, torch.int32, (B, S), dev)
    _check("q_sq", q_sq, torch.float32, (Q,), dev)
    _check("q", q, torch.float32, (Q, dp), dev)
    bids = bids.to(torch.int64).contiguous()
    _check("bids", bids, torch.int64, (Q, p), dev)
    if allowed is not None:
        _check("allowed", allowed, torch.bool, (B, S), dev)
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
        raise ValueError("expand_score: rows must be 4-byte multiples and "
                         "4-byte aligned")
    words = 4 if row_bytes % 16 == 0 and blocks.data_ptr() % 16 == 0 else 1
    nchunks = row_bytes // (4 * words)
    lanes = min(32, 1 << (nchunks.bit_length() - 1))
    out = torch.empty((Q, p, S), dtype=torch.float32, device=dev)
    lib = _nvcc.load_library(NAME, {"expand_score_launch": _ARGTYPES})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.expand_score_launch(
            _MODES[blocks.dtype], words, blocks.data_ptr(),
            blocks_sq.data_ptr(), block_ids.data_ptr(),
            None if allowed is None else allowed.data_ptr(), q_op.data_ptr(),
            q_sq.data_ptr(), bids.data_ptr(), qs_ptr, ss_ptr, out.data_ptr(),
            B, Q, p, S, row_bytes, int(metric is Metric.L2), lanes, stream)
    if err != 0:
        raise RuntimeError(f"expand_score kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
