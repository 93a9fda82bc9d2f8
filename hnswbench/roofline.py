"""The least time a kernel call could take on one H100: a copy of
``chip_smoke.py``'s ``bound`` and ``expand_bound`` arithmetic, with the
data sheet's peaks (NVIDIA H100 SXM, dense, at the 700 W limit)."""

from __future__ import annotations

import torch

HBM_BPS = 3.35e12
PEAK_OPS = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}


def bound(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    """(least ms, what bounds it) for a call moving ``nbytes`` and doing
    ``ops`` operations of ``dtype``."""
    b, o = nbytes / HBM_BPS * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def expand_bytes(blocks_shape, elem_bytes: int, bids: torch.Tensor,
                 n_blocks: int, *, scaled: bool, filtered: bool,
                 out_bytes: int) -> int:
    """Bytes one stage-1 call must move: each distinct probed block's rows,
    norms and ids (and scale, filter bytes) read once, the queries and
    their block ids once, the output written once."""
    Q, p = bids.shape
    S, dp = blocks_shape[1], blocks_shape[2]
    per_block = S * dp * elem_bytes + 8 * S + 4 * scaled + S * filtered
    valid = bids[(bids >= 0) & (bids < n_blocks)]
    distinct = int(torch.unique(valid).numel())
    return (distinct * per_block + Q * dp * elem_bytes + 4 * Q * (1 + scaled)
            + 8 * Q * p + out_bytes)


def expand_bound(blocks_shape, dtype: torch.dtype, bids: torch.Tensor,
                 *, scaled: bool, filtered: bool,
                 out_bytes: int) -> tuple[float, str]:
    """(least ms, what bounds it) of one stage-1 call over ``bids [Q, p]``
    into blocks of ``blocks_shape`` (B, S, dp): :func:`expand_bytes`, and
    ``2 Q p S dp`` operations of the rows' type."""
    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = expand_bytes(blocks_shape, elem, bids, blocks_shape[0],
                          scaled=scaled, filtered=filtered,
                          out_bytes=out_bytes)
    Q, p = bids.shape
    name = {torch.int8: "int8", torch.bfloat16: "bfloat16"}.get(dtype,
                                                               "float32")
    return bound(nbytes, 2 * Q * p * blocks_shape[1] * blocks_shape[2], name)
