"""Dataset files and synthesis (numpy only, plus the native parser).

fvecs/ivecs/bvecs are the TEXMEX formats used by SIFT/GIST/DEEP; the
readers take the native mmap parser (``io/native.py``) and fall back to
numpy only on a host without ``g++``. The synthetic
generators make the same arrays, byte for byte, as
``tpu_hnsw/io/datasets.py`` for the same seed: the numpy RNG calls are the
same calls in the same order, so both packages can be held to one corpus.
"""

from __future__ import annotations

import os

import numpy as np


def read_fvecs(path: str, count: int | None = None) -> np.ndarray:
    """Read .fvecs: each row is [int32 dim, float32 x dim]. Native first
    (the mmap'd multithreaded parser), numpy without a compiler."""
    from tpu_hnsw_torch.io import native

    out = native.read_fvecs_native(path, count)
    if out is not None:
        return out
    return read_fvecs_numpy(path, count)


def read_fvecs_numpy(path: str, count: int | None = None) -> np.ndarray:
    """:func:`read_fvecs` in numpy alone."""
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


def read_bvecs(path: str, count: int | None = None) -> np.ndarray:
    """Read .bvecs: each row is [int32 dim, uint8 x dim], as f32. Native
    first, numpy without a compiler."""
    from tpu_hnsw_torch.io import native

    out = native.read_bvecs_native(path, count)
    if out is not None:
        return out
    return read_bvecs_numpy(path, count)


def read_bvecs_numpy(path: str, count: int | None = None) -> np.ndarray:
    """:func:`read_bvecs` in numpy alone."""
    with open(path, "rb") as f:
        dim = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        row = 4 + dim
        f.seek(0, os.SEEK_END)
        n = f.tell() // row
        if count is not None:
            n = min(n, count)
        f.seek(0)
        raw = np.fromfile(f, dtype=np.uint8, count=n * row).reshape(n, row)
    return raw[:, 4:].astype(np.float32)


def write_bvecs(path: str, x: np.ndarray) -> None:
    """Write uint8 rows as .bvecs."""
    x = np.ascontiguousarray(x, dtype=np.uint8)
    n, d = x.shape
    out = np.empty((n, 4 + d), dtype=np.uint8)
    out[:, :4] = np.array([d], np.int32).view(np.uint8)
    out[:, 4:] = x
    out.tofile(path)


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


def synthetic_splade(
    n: int,
    vocab: int = 30522,
    nnz: int = 128,
    n_queries: int = 1000,
    n_topics: int | None = None,
    seed: int = 42,
):
    """SPLADE-style learned-sparse corpus + queries (for the sparse ANN
    index).

    Mimics the structure of SPLADE/uniCOIL embeddings: a BERT-sized
    vocabulary, ~``nnz`` active coordinates per row with positive
    log-saturated weights, and topical cluster structure (documents of
    one topic share most of their active terms). Queries are sparsified
    perturbations of corpus rows (as in the dense generators: perturbed
    corpus points give non-degenerate neighbors).

    Returns ``(base_indices [n, nnz], base_values, q_indices [nq, nnz],
    q_values)`` as padded COO (-1 padding), ready for
    :class:`~tpu_hnsw_torch.ops.sparse.SparseVecs`.
    """
    rng = np.random.default_rng(seed)
    if n_topics is None:
        n_topics = max(16, n // 2000)
    # each topic activates a ~4*nnz-term sub-vocabulary with Zipf-ish
    # topic-term affinities; a shared high-frequency stratum (stopword
    # analogue) is available to every topic
    common = rng.choice(vocab, size=max(nnz // 4, 8), replace=False)
    topic_terms = rng.integers(0, vocab, size=(n_topics, 4 * nnz))
    topic_w = (1.0 / np.arange(1, 4 * nnz + 1)) ** 0.5  # affinity decay

    def draw(count: int, topics: np.ndarray, chunk: int = 65536):
        """Vectorized weighted sampling-without-replacement per row via
        the Gumbel-top-k trick (chunked: the [chunk, 4*nnz] noise matrix
        is the working set)."""
        take_n = nnz - len(common) // 2
        idx = np.full((count, nnz), -1, np.int64)
        val = np.zeros((count, nnz), np.float32)
        logw = np.log(topic_w)[None, :]
        for s in range(0, count, chunk):
            c = min(chunk, count - s)
            g = rng.gumbel(size=(c, 4 * nnz)).astype(np.float32)
            take = np.argpartition(-(logw + g), take_n, axis=1)[:, :take_n]
            terms = np.take_along_axis(topic_terms[topics[s:s + c]], take,
                                       axis=1)
            cm = common[rng.integers(0, len(common),
                                     size=(c, len(common) // 2))]
            terms = np.concatenate([terms, cm], axis=1)
            # per-row unique with -1 padding: sort, mask repeats
            terms.sort(axis=1)
            dup = np.zeros_like(terms, bool)
            dup[:, 1:] = terms[:, 1:] == terms[:, :-1]
            terms = np.where(dup, -1, terms)
            order = np.argsort(np.where(terms < 0, vocab + 1, terms), axis=1)
            terms = np.take_along_axis(terms, order, axis=1)[:, :nnz]
            w = np.log1p(rng.gamma(2.0, 1.0, size=terms.shape)).astype(
                np.float32)
            idx[s:s + c] = terms
            val[s:s + c] = np.where(terms >= 0, w, 0.0)
        return idx, val

    base_topics = rng.integers(0, n_topics, size=n)
    bi, bv = draw(n, base_topics)
    # queries: take a corpus row, keep a random ~60% of its terms,
    # re-jitter weights — same topic, overlapping support
    qsrc = rng.integers(0, n, size=n_queries)
    qi = np.full((n_queries, nnz), -1, np.int64)
    qv = np.zeros((n_queries, nnz), np.float32)
    for r in range(n_queries):
        row = bi[qsrc[r]]
        live = row[row >= 0]
        keep = rng.random(len(live)) < 0.6
        terms = live[keep]
        if len(terms) == 0:
            terms = live[:1]
        w = np.log1p(rng.gamma(2.0, 1.0, size=len(terms))).astype(np.float32)
        qi[r, : len(terms)] = terms
        qv[r, : len(terms)] = w
    return bi, bv, qi, qv


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
