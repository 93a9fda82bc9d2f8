"""Dataset files and synthesis (numpy only).

fvecs/ivecs are the TEXMEX formats used by SIFT/GIST/DEEP. The synthetic
generators make the same arrays, byte for byte, as
``tpu_hnsw/io/datasets.py`` for the same seed: the numpy RNG calls are the
same calls in the same order, so both packages can be held to one corpus.
"""

from __future__ import annotations

import os

import numpy as np


def read_fvecs(path: str, count: int | None = None) -> np.ndarray:
    """Read .fvecs: each row is [int32 dim, float32 x dim]."""
    raw = np.fromfile(path, dtype=np.int32)
    if raw.size == 0:
        return np.zeros((0, 0), np.float32)
    dim = int(raw[0])
    row = dim + 1
    n_rows = raw.size // row
    if count is not None:
        n_rows = min(n_rows, count)
    raw = raw[: n_rows * row].reshape(n_rows, row)
    return raw[:, 1:].view(np.float32).copy()


def read_ivecs(path: str, count: int | None = None) -> np.ndarray:
    return read_fvecs(path, count).view(np.int32)


def write_fvecs(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x.view(np.int32)
    out.tofile(path)


def write_ivecs(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.int32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x
    out.tofile(path)


def synthetic_clustered(
    n: int,
    dim: int,
    n_queries: int = 1000,
    n_clusters: int | None = None,
    seed: int = 42,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian-mixture corpus + queries drawn near corpus points.

    Queries are perturbed corpus points, giving non-degenerate nearest
    neighbors (as in SIFT-style benchmarks) rather than uniform noise.
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(16, n // 2000)
    centers = rng.normal(0.0, 1.0, size=(n_clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, n_clusters, size=n)
    base = centers[assign] + rng.normal(0.0, 1.0, size=(n, dim)).astype(np.float32)
    qidx = rng.integers(0, n, size=n_queries)
    queries = base[qidx] + 0.1 * rng.normal(0.0, 1.0, size=(n_queries, dim)).astype(
        np.float32
    )
    return base.astype(dtype), queries.astype(dtype)


def synthetic_uniform(
    n: int,
    dim: int,
    n_queries: int = 1000,
    seed: int = 42,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform-random corpus: no cluster structure, the worst case for a
    k-means-blocked layout. Queries are perturbed corpus points."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.0, 1.0, size=(n, dim)).astype(np.float32)
    qidx = rng.integers(0, n, size=n_queries)
    queries = base[qidx] + 0.02 * rng.normal(
        0.0, 1.0, size=(n_queries, dim)
    ).astype(np.float32)
    return base.astype(dtype), queries.astype(dtype)


def load_or_synthesize(
    name: str, data_dir: str | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """A named benchmark dataset from ``data_dir`` when its
    ``<name>_{base,query}.fvecs`` (and optionally ``_groundtruth.ivecs``)
    are there, else a synthetic stand-in of its shape (the reference's
    arrays, byte for byte). Returns (base, queries, ground_truth or None).
    Names: sift10k, sift1m, glove100, deep10m."""
    shapes = {
        "sift10k": (10_000, 128, 100),
        "sift1m": (1_000_000, 128, 10_000),
        "glove100": (1_183_514, 100, 10_000),
        "deep10m": (10_000_000, 96, 10_000),
    }
    if name not in shapes:
        raise ValueError(f"unknown dataset {name}")
    n, dim, nq = shapes[name]
    if data_dir:
        base_p = os.path.join(data_dir, f"{name}_base.fvecs")
        query_p = os.path.join(data_dir, f"{name}_query.fvecs")
        gt_p = os.path.join(data_dir, f"{name}_groundtruth.ivecs")
        if os.path.exists(base_p) and os.path.exists(query_p):
            gt = read_ivecs(gt_p) if os.path.exists(gt_p) else None
            return read_fvecs(base_p), read_fvecs(query_p), gt
    base, queries = synthetic_clustered(n, dim, n_queries=nq)
    return base, queries, None
