"""Flat HNSW graph storage (port of ``tpu_hnsw/index/graph.py``).

The whole graph lives on the device as a few flat tensors, so every graph
access on the hot path is a batched gather:

- ``vectors      [cap+1, d]``      storage dtype; row ``cap`` is an all-zero
                                   trash row, so the sentinel id ``cap`` can
                                   be gathered without a mask
- ``vectors_sq   [cap+1]``         f32 squared norms
- ``neighbors0   [cap+1, 2m]``     level-0 adjacency, int32, sentinel ``cap``
- ``upper_nbrs   [cap_u+1, L, m]`` packed adjacency of levels 1..L for the
                                   elements of level >= 1
- ``upper_slot   [cap+1]``         element id -> row of ``upper_nbrs``
                                   (``cap_u`` = trash slot)
- ``levels       [cap+1]``         per-element top level
- ``deleted      [cap+1]``         tombstones

The trash rows (``cap`` of each per-element table, ``cap_u`` of
``upper_nbrs``) stay all zero / all sentinel / not deleted through every
scatter: the searches gather them for sentinel ids and rely on reading
nothing. Scalars (count, entry point, entry level) live on
:class:`~tpu_hnsw_torch.index.hnsw.HnswIndex`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_hnsw_torch.config import HnswConfig


@dataclasses.dataclass
class HnswGraph:
    """The tensors of one graph (all on one device)."""

    vectors: torch.Tensor     # [cap+1, d] storage dtype
    vectors_sq: torch.Tensor  # [cap+1] f32
    neighbors0: torch.Tensor  # [cap+1, 2m] int32, sentinel = cap
    upper_nbrs: torch.Tensor  # [cap_u+1, max_level, m] int32, sentinel = cap
    upper_slot: torch.Tensor  # [cap+1] int32, sentinel slot = cap_u
    levels: torch.Tensor      # [cap+1] int32
    deleted: torch.Tensor     # [cap+1] bool

    def _replace(self, **kw) -> "HnswGraph":
        return dataclasses.replace(self, **kw)

    @property
    def cap(self) -> int:
        return self.vectors.shape[0] - 1

    @property
    def cap_upper(self) -> int:
        return self.upper_nbrs.shape[0] - 1

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def sentinel(self) -> int:
        return self.cap

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def upper_capacity(cap: int, m: int) -> int:
    """Rows of the packed upper-level table: elements of level >= 1 are
    Binomial(cap, 1/m), mean cap/m; 1.25x + 256 is > 60 standard deviations
    out at 1M rows, and the insert paths raise if it ever overflows."""
    return cap // m + cap // (4 * m) + 256


def storage_dtype(config: HnswConfig) -> torch.dtype:
    return torch.bfloat16 if config.dtype == "bfloat16" else torch.float32


def init_graph(config: HnswConfig, cap: int, device,
               cap_upper: int | None = None) -> HnswGraph:
    """Empty tables for ``cap`` elements and ``cap_upper`` upper slots
    (default :func:`upper_capacity`)."""
    cap_u = upper_capacity(cap, config.m) if cap_upper is None else cap_upper
    i32 = dict(dtype=torch.int32, device=device)
    return HnswGraph(
        vectors=torch.zeros((cap + 1, config.dim), dtype=storage_dtype(config),
                            device=device),
        vectors_sq=torch.zeros(cap + 1, dtype=torch.float32, device=device),
        neighbors0=torch.full((cap + 1, config.m0), cap, **i32),
        upper_nbrs=torch.full((cap_u + 1, config.max_level, config.m), cap,
                              **i32),
        upper_slot=torch.full((cap + 1,), cap_u, **i32),
        levels=torch.zeros(cap + 1, **i32),
        deleted=torch.zeros(cap + 1, dtype=torch.bool, device=device),
    )


def restore_trash(g: HnswGraph) -> HnswGraph:
    """Set every trash row back to its initial contents, in place."""
    cap, cap_u = g.cap, g.cap_upper
    g.vectors[cap] = 0
    g.vectors_sq[cap] = 0
    g.neighbors0[cap] = cap
    g.upper_nbrs[cap_u] = cap
    g.upper_slot[cap] = cap_u
    g.levels[cap] = 0
    g.deleted[cap] = False
    return g


def neighbor_rows(g: HnswGraph, ids: torch.Tensor, level: int) -> torch.Tensor:
    """Adjacency rows of ``ids [...]`` at ``level``: ``[..., deg]`` int32."""
    if level == 0:
        return g.neighbors0[ids]
    return g.upper_nbrs[:, level - 1][g.upper_slot[ids]]


def gather_vectors(g: HnswGraph, ids: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(vectors, squared norms) of ``ids``; the sentinel gathers the zero
    trash row."""
    return g.vectors[ids], g.vectors_sq[ids]


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def graph_degree(config: HnswConfig, level: int) -> int:
    return config.m0 if level == 0 else config.m


def from_ref(ref, config: HnswConfig,
             cap: int | None = None) -> tuple[HnswGraph, int, int]:
    """A ``RefHnsw`` oracle graph as CPU tensors (tests; :func:`to_device`
    moves it). Returns (graph, n, n_upper)."""
    n = len(ref.vectors)
    cap = cap or n
    g = init_graph(config, cap, "cpu")
    sent = cap
    vecs = np.asarray(ref.vectors, dtype=np.float32)
    nbr0 = np.full((n, config.m0), sent, np.int32)
    levels = np.asarray(ref.levels, np.int32)
    slot_of = np.full(n, g.cap_upper, np.int32)
    upper = g.upper_nbrs.numpy().copy()
    n_upper = 0
    for i in range(n):
        row = ref.neighbors[i][0]
        nbr0[i, : len(row)] = row
        if levels[i] >= 1:
            slot_of[i] = n_upper
            for lv in range(1, levels[i] + 1):
                row = ref.neighbors[i][lv]
                upper[n_upper, lv - 1, : len(row)] = row
            n_upper += 1
    g.vectors[:n] = torch.from_numpy(vecs).to(g.vectors.dtype)
    g.vectors_sq[:] = g.vectors.float().pow(2).sum(-1)
    g.neighbors0[:n] = torch.from_numpy(nbr0)
    g.upper_nbrs = torch.from_numpy(upper)
    g.upper_slot[:n] = torch.from_numpy(slot_of)
    g.levels[:n] = torch.from_numpy(levels)
    return g, n, n_upper


def to_device(g: HnswGraph, device) -> HnswGraph:
    return HnswGraph(**{f.name: getattr(g, f.name).to(device)
                        for f in dataclasses.fields(g)})


def to_ref_lists(g: HnswGraph, n: int, n_upper: int) -> list[list[list[int]]]:
    """Adjacency as python lists per element and level (tests)."""
    cap = g.cap
    nbr0 = g.neighbors0[:n].cpu().numpy()
    levels = g.levels[:n].cpu().numpy()
    slots = g.upper_slot[:n].cpu().numpy()
    upper = g.upper_nbrs.cpu().numpy()
    out = []
    for i in range(n):
        per_level = [[int(x) for x in nbr0[i] if x != cap]]
        for lv in range(1, int(levels[i]) + 1):
            per_level.append([int(x) for x in upper[slots[i], lv - 1]
                              if x != cap])
        out.append(per_level)
    return out
