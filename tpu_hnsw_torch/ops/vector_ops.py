"""The ``vector`` type function surface (port of
``tpu_hnsw/ops/vector_ops.py``).

Python equivalents of pgvector's SQL functions and operators over dense
vectors (upstream ``pgvector:src/vector.c`` / ``sql/vector.sql``):
distances (`<->` `<#>` `<=>` `<+>`), arithmetic (`+ - *`, concat), norms,
``l2_normalize``, ``binary_quantize``, ``subvector``, the ``avg``/``sum``
aggregates, the ``'[1,2,3]'`` text I/O, the btree comparison family and
the binary wire format, with upstream's error text.

The tensor functions run on torch and accumulate in f32, batched over
leading axes: a tensor stays on its device; an array (or list) becomes a
CPU tensor, with float64 and int64 narrowed to 32 bits as ``jnp.asarray``
narrows them. Text I/O, binary I/O and comparison are numpy on the host,
as in the reference. ``halfvec`` values are ``torch.bfloat16`` tensors
(the reference's ``ml_dtypes.bfloat16`` arrays, bit for bit).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from tpu_hnsw_torch.config import MAX_DIM

_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32}


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    arr = np.asarray(a)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _pair(a, b) -> tuple[torch.Tensor, torch.Tensor]:
    a, b = _tensor(a), _tensor(b)
    if a.shape[-1] != b.shape[-1]:
        raise ValueError(
            f"different vector dimensions {a.shape[-1]} and {b.shape[-1]}")
    return a, b


def l2_distance(a, b) -> torch.Tensor:
    """``<->`` euclidean distance."""
    a, b = _pair(a, b)
    d = a.float() - b.float()
    return torch.sqrt(torch.clamp_min((d * d).sum(-1), 0.0))


def l2_squared_distance(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    d = a.float() - b.float()
    return (d * d).sum(-1)


def inner_product(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    return (a.float() * b.float()).sum(-1)


def negative_inner_product(a, b) -> torch.Tensor:
    """``<#>`` (pgvector returns the negation for index ordering)."""
    return -inner_product(a, b)


def cosine_distance(a, b) -> torch.Tensor:
    """``<=>`` = 1 - cos(a, b); NaN for zero vectors like upstream."""
    a, b = _pair(a, b)
    af, bf = a.float(), b.float()
    num = (af * bf).sum(-1)
    den = torch.sqrt((af * af).sum(-1) * (bf * bf).sum(-1))
    return 1.0 - num / den


def l1_distance(a, b) -> torch.Tensor:
    """``<+>`` taxicab distance."""
    a, b = _pair(a, b)
    return (a.float() - b.float()).abs().sum(-1)


def vector_dims(a) -> int:
    return int(_tensor(a).shape[-1])


def vector_norm(a) -> torch.Tensor:
    a = _tensor(a).float()
    return torch.sqrt((a * a).sum(-1))


def l2_normalize(a, eps: float = 0.0) -> torch.Tensor:
    """Upstream returns the zero vector unchanged (norm == 0)."""
    a = _tensor(a).float()
    n = torch.sqrt((a * a).sum(-1, keepdim=True))
    return torch.where(n > eps, a / torch.where(n == 0, 1.0, n), a)


def vector_add(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    return a + b


def vector_sub(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    return a - b


def vector_mul(a, b) -> torch.Tensor:
    a, b = _pair(a, b)
    return a * b


def vector_concat(a, b) -> torch.Tensor:
    out = torch.cat([_tensor(a), _tensor(b)], -1)
    if out.shape[-1] > MAX_DIM:
        raise ValueError(f"vector cannot have more than {MAX_DIM} dimensions")
    return out


def subvector(a, start: int, count: int) -> torch.Tensor:
    """1-based start like SQL ``subvector(v, start, count)``."""
    a = _tensor(a)
    if count < 1:
        raise ValueError("vector must have at least 1 dimension")
    s = start - 1
    if s < 0 or s >= a.shape[-1]:
        raise ValueError("vector must have at least 1 dimension")
    return a[..., s:s + count]


def binary_quantize(a) -> torch.Tensor:
    """``binary_quantize``: 1 where component > 0, as uint8 0/1 (pack with
    ``ops.bitops.pack_bits``)."""
    return (_tensor(a) > 0).to(torch.uint8)


def vector_avg(x, axis: int = 0) -> torch.Tensor:
    """``avg`` aggregate over a set of vectors."""
    return _tensor(x).float().mean(axis)


def vector_sum(x, axis: int = 0) -> torch.Tensor:
    """``sum`` aggregate over a set of vectors."""
    return _tensor(x).float().sum(axis)


# --------------------------------------------------------------- text I/O
# The type-input/output half of the ``vector`` type (upstream ``vector_in``
# / ``vector_out`` in ``pgvector:src/vector.c``): the ``'[1,2,3]'`` literal
# format with the same validation and error wording. ``halfvec`` rounds
# through bf16 (the storage dtype here; bf16 shares f32's exponent range,
# so only values within half an ulp of f32's largest overflow).


def vector_in(s: str, dim: int | None = None) -> np.ndarray:
    """Parse a ``'[1,2,3]'`` vector literal (``vector_in`` analogue).

    ``dim`` plays the role of the typmod: when given, the parsed vector
    must have exactly that many dimensions.
    """
    raw = s
    t = s.strip()
    if not t.startswith("[") or not t.endswith("]"):
        raise ValueError(f'malformed vector literal: "{raw}"')
    inner = t[1:-1].strip()
    if not inner:
        raise ValueError("vector must have at least 1 dimension")
    parts = inner.split(",")
    vals = np.empty(len(parts), np.float32)
    for i, p in enumerate(parts):
        p = p.strip()
        if not p:
            raise ValueError(f'malformed vector literal: "{raw}"')
        try:
            v = float(p)
        except ValueError:
            raise ValueError(f'malformed vector literal: "{raw}"') from None
        if np.isnan(v):
            raise ValueError("NaN not allowed in vector")
        with np.errstate(over="ignore"):  # f32 overflow -> inf, checked
            if np.isinf(v) or np.isinf(np.float32(v)):
                raise ValueError("infinite value not allowed in vector")
        vals[i] = v
    if len(vals) > MAX_DIM:
        raise ValueError(f"vector cannot have more than {MAX_DIM} dimensions")
    if dim is not None and len(vals) != dim:
        raise ValueError(f"expected {dim} dimensions, not {len(vals)}")
    return vals


def _fmt_f32(x) -> str:
    # shortest decimal that round-trips through float32 (upstream uses Ryu
    # float_to_shortest_decimal, so '1.0' prints as '1')
    return np.format_float_positional(np.float32(x), unique=True, trim="-")


def _host_f32(v) -> np.ndarray:
    """Any vector (array, list, tensor of any float dtype) as a flat f32
    numpy array on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy().reshape(-1)
    return np.asarray(v).astype(np.float32).reshape(-1)


def vector_out(v) -> str:
    """Format a vector as the ``'[1,2,3]'`` literal (``vector_out``
    analogue; shortest round-trip decimals like upstream's
    float_to_shortest_decimal)."""
    return "[" + ",".join(_fmt_f32(x) for x in _host_f32(v)) + "]"


def _to_bf16(v: np.ndarray) -> torch.Tensor:
    """f32 values -> a bf16 CPU tensor, rounded to nearest even (as
    ``ml_dtypes``' cast)."""
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
        torch.bfloat16)


def halfvec_in(s: str, dim: int | None = None) -> torch.Tensor:
    """Parse a halfvec literal into the bf16 storage dtype."""
    h = _to_bf16(vector_in(s, dim=dim))
    if not torch.isfinite(h).all():
        raise ValueError("infinite value not allowed in halfvec")
    return h


def halfvec_out(v) -> str:
    return vector_out(v)


# ------------------------------------------------- ordering / btree opclass
# Upstream registers a btree operator class over ``vector`` (``vector_cmp``
# + ``< <= = != >= >`` in ``pgvector:sql/vector.sql``) so vectors can be
# sorted, DISTINCT-ed, and equality-joined. Ordering is element by element
# with Postgres float semantics: NaN sorts GREATER than every number and
# equal to itself (float4_cmp), and a strict prefix sorts first.


def _cmp_keys(v) -> np.ndarray:
    """Total-order keys for f32 values with Postgres NaN-is-largest
    semantics: monotone int32 image of the float order."""
    # -0.0 + 0.0 == +0.0: collapse signed zeros first (float4_cmp treats
    # them equal; their bit patterns differ)
    v = np.asarray(v, np.float32) + np.float32(0.0)
    b = np.ascontiguousarray(v, np.float32).view(np.int32)
    # flip negative floats so the int image is monotone; pin NaN to +max
    keys = np.where(b < 0, np.int32(-2147483648) - (b + 1), b)
    keys = np.where(np.isnan(v), np.int32(2147483647), keys)
    return keys


def vector_cmp(a, b) -> int:
    """``vector_cmp`` analogue: -1 / 0 / +1 lexicographic comparison."""
    a, b = _host_f32(a), _host_f32(b)
    n = min(len(a), len(b))
    ka, kb = _cmp_keys(a[:n]), _cmp_keys(b[:n])
    neq = np.nonzero(ka != kb)[0]
    if len(neq):
        i = neq[0]
        return -1 if ka[i] < kb[i] else 1
    if len(a) != len(b):
        return -1 if len(a) < len(b) else 1
    return 0


def vector_lt(a, b) -> bool:
    return vector_cmp(a, b) < 0


def vector_le(a, b) -> bool:
    return vector_cmp(a, b) <= 0


def vector_eq(a, b) -> bool:
    return vector_cmp(a, b) == 0


def vector_ne(a, b) -> bool:
    return vector_cmp(a, b) != 0


def vector_ge(a, b) -> bool:
    return vector_cmp(a, b) >= 0


def vector_gt(a, b) -> bool:
    return vector_cmp(a, b) > 0


def vector_sort_keys(x) -> np.ndarray:
    """Batched total-order keys [N, d] int32 — ``ORDER BY vec`` /
    ``DISTINCT`` over a vector column via ``np.lexsort`` on the columns
    (the batched form of :func:`vector_cmp`; same NaN/prefix rules for
    equal-dim batches)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return _cmp_keys(np.asarray(x, np.float32))


# ----------------------------------------------------------- binary I/O
# The wire format (upstream ``vector_recv``/``vector_send``): big-endian
# int16 dim, int16 unused (0), then ``dim`` float4s. ``halfvec`` sends
# float2 (IEEE fp16 on the wire; the storage here is bf16, so send converts
# bf16 -> fp16 and recv back, both rounding once through float32).


def vector_send(v) -> bytes:
    v = _host_f32(v)
    if len(v) > MAX_DIM:
        raise ValueError(f"vector cannot have more than {MAX_DIM} dimensions")
    return struct.pack(f">hh{len(v)}f", len(v), 0, *(float(x) for x in v))


def vector_recv(data: bytes) -> np.ndarray:
    if len(data) < 4:
        raise ValueError("invalid binary data for type vector")
    dim, unused = struct.unpack(">hh", data[:4])
    if not (0 < dim <= MAX_DIM) or unused != 0:
        raise ValueError(f"expected dimension in [1, {MAX_DIM}], got {dim}")
    if len(data) != 4 + 4 * dim:
        raise ValueError("invalid binary data for type vector")
    vals = np.frombuffer(data, dtype=">f4", offset=4).astype(np.float32)
    if np.isnan(vals).any():
        raise ValueError("NaN not allowed in vector")
    if np.isinf(vals).any():
        raise ValueError("infinite value not allowed in vector")
    return vals


def halfvec_send(v) -> bytes:
    # one rounding to fp16 (a float64 list is not rounded to f32 first)
    src = _host_f32(v) if isinstance(v, torch.Tensor) else np.asarray(v)
    h = src.astype(np.float16).reshape(-1)
    return struct.pack(">hh", len(h), 0) + h.astype(">f2").tobytes()


def halfvec_recv(data: bytes) -> torch.Tensor:
    if len(data) < 4:
        raise ValueError("invalid binary data for type halfvec")
    dim, unused = struct.unpack(">hh", data[:4])
    if not (0 < dim <= MAX_DIM) or unused != 0:
        raise ValueError(f"expected dimension in [1, {MAX_DIM}], got {dim}")
    if len(data) != 4 + 2 * dim:
        raise ValueError("invalid binary data for type halfvec")
    vals = np.frombuffer(data, dtype=">f2", offset=4).astype(np.float32)
    if np.isnan(vals).any():
        raise ValueError("NaN not allowed in halfvec")
    if np.isinf(vals).any():
        raise ValueError("infinite value not allowed in halfvec")
    return _to_bf16(vals)
