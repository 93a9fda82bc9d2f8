"""Counter-based Gaussian rows in torch integer ops: the ``threefry2x32``
generator and the normal transform of JAX's default PRNG, so a projection
table drawn here matches one the reference draws with
``jax.random.normal(jax.random.fold_in(key, r), (d,))`` (bits equal; the
normals within a few 1e-7, from the ``log1p`` inside ``erfinv``).

uint32 words are held in int64 tensors (``torch.uint32`` has no shifts or
adds), masked to 32 bits after every add and shift, so the same code runs
on the CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    ``jax._src.prng.threefry2x32``: key words ``k0, k1`` and counter words
    ``x0, x1`` (int64 tensors or ints holding uint32 values, broadcast
    together). Returns the two output words."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def seed_key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s two words: (high, low) 32 bits."""
    seed = int(seed) & ((1 << 64) - 1)
    return seed >> 32, seed & _MASK


def fold_in(key, data: torch.Tensor):
    """``jax.random.fold_in(key, data)`` for a tensor of non-negative int
    ``data``: one key per element, as two int64 word tensors."""
    data = data.to(torch.int64)
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(k0: torch.Tensor, k1: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of ``[R]`` key
    words: ``[R, n]`` int64 in [0, 2^32). JAX's partitionable scheme: the
    counter is the element's index split into (high, low) words, and the
    two output words are xored."""
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)[None, :]
    x0, x1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(lo), lo)
    return x0 ^ x1


# Giles, "Approximating the erfinv function" (GPU Gems 4), single
# precision: the polynomial XLA's ErfInv32 evaluates, highest term first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function by XLA's polynomial (``torch.erfinv``
    differs from it by up to 2e-5)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * torch.inf, p * x)


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> f32 standard normal, as ``jax.random.normal``:
    the top 23 bits as a mantissa of [1, 2), mapped onto
    [nextafter(-1, 0), 1) and through ``sqrt(2) * erfinv``."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fb.view(torch.float32) - 1.0
    u = torch.clamp_min(f * span + lo, lo)
    return float(np.float32(math.sqrt(2.0))) * erfinv_f32(u)


def normal_rows(seed: int, rows: torch.Tensor, width: int) -> torch.Tensor:
    """``[len(rows), width]`` f32: row ``i`` is
    ``jax.random.normal(jax.random.fold_in(jax.random.key(seed), rows[i]),
    (width,))``, on ``rows``' device. A row depends only on (seed, its
    index), never on how many rows are drawn with it."""
    k0, k1 = fold_in(seed_key(seed), rows)
    return bits_to_normal(random_bits(k0, k1, width))
