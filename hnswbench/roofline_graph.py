"""The least time of the graph engine's level-0 beam on one H100: the
bytes its steps had to gather, over :data:`hnswbench.roofline.HBM_BPS`."""

from __future__ import annotations

from hnswbench.roofline import HBM_BPS


def beam_bytes(rows: int, vectors: int, degree: int, dim: int) -> int:
    """Bytes of ``rows`` expanded nodes' adjacency rows (``degree`` int32
    ids each) and of ``vectors`` distinct f32 vectors of ``dim`` elements,
    each read once, as pgvector's visited set reads them."""
    return rows * degree * 4 + vectors * dim * 4


def beam_least_ms(rows: int, vectors: int, degree: int, dim: int) -> float:
    """:func:`beam_bytes` over the HBM peak, in ms."""
    return beam_bytes(rows, vectors, degree, dim) / HBM_BPS * 1e3
