"""Configuration of the PyTorch port (a copy of ``tpu_hnsw/config.py``:
pure Python, so both packages validate options identically).

Mirrors the two-tier config system of the reference (pgvector):

- per-index *reloptions* baked at build time (``m``, ``ef_construction``;
  upstream ``pgvector:src/hnsw.c`` ``hnswoptions``), frozen here in
  :class:`HnswConfig`;
- per-scan *GUCs* (``hnsw.ef_search`` default 40, upstream ``HnswInit``),
  which are per-call arguments to ``search`` in this API.

Defaults are pinned to upstream's (m=16, ef_construction=64, ef_search=40)
because the evaluation configs assume them (BASELINE.json:7-8).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class Metric(enum.Enum):
    """Distance metric, covering pgvector's dense operator classes.

    Reference operators (upstream ``pgvector:sql/vector.sql`` opclasses):
    ``<->`` L2 (vector_l2_ops), ``<#>`` negative inner product
    (vector_ip_ops), ``<=>`` cosine distance (vector_cosine_ops),
    ``<+>`` L1 (vector_l1_ops), ``<~>`` hamming (bit_hamming_ops),
    ``<%>`` jaccard (bit_jaccard_ops).
    """

    L2 = "l2"
    IP = "ip"
    COSINE = "cosine"
    L1 = "l1"
    HAMMING = "hamming"
    JACCARD = "jaccard"

    @property
    def needs_normalized(self) -> bool:
        return self is Metric.COSINE

    @property
    def is_binary(self) -> bool:
        return self in (Metric.HAMMING, Metric.JACCARD)


# pgvector limits (upstream ``pgvector:src/vector.h``): dims 1..16000 for
# vector, 1..4000 indexable; HNSW m in [2,100], ef_construction in [4,1000],
# ef_search in [1,1000]; ef_construction >= 2*m enforced at build.
MAX_DIM = 16000
HNSW_MIN_M, HNSW_MAX_M = 2, 100
HNSW_MIN_EFC, HNSW_MAX_EFC = 4, 1000
HNSW_MIN_EFS, HNSW_MAX_EFS = 1, 1000

# Default maximum upper level stored in the packed upper-level adjacency
# array.  With ml = 1/ln(m) and m=16, P(level >= 6) ~ 16^-6 ~ 4e-8: at a
# 12.5M-row shard (config E) <1 element expects to exceed it.  Elements
# drawing a higher level are clamped — harmless for recall (greedy
# descent just starts one hop lower), and the table's L dimension
# multiplies upper-level memory (8 -> 6 saves 25% of it).
DEFAULT_MAX_LEVEL = 6


@dataclasses.dataclass(frozen=True)
class HnswConfig:
    """Frozen per-index build options (the reloptions analogue).

    ``m``/``ef_construction`` semantics follow upstream
    ``pgvector:src/hnsw.c`` (defaults HNSW_DEFAULT_M=16,
    HNSW_DEFAULT_EF_CONSTRUCTION=64) and ``hnswutils.c``
    (level-0 degree cap is ``2*m``, upper levels ``m``,
    ``ml = 1 / ln(m)``).
    """

    dim: int
    metric: Metric = Metric.L2
    m: int = 16
    ef_construction: int = 64
    max_elements: int = 0  # capacity; 0 = size to first build batch
    dtype: str = "float32"  # storage dtype: float32 | bfloat16 (halfvec parity)
    max_level: int = DEFAULT_MAX_LEVEL
    # Construction wave size (TPU-native batched-insert analogue of
    # pgvector's parallel build workers, SURVEY.md §2.3).  1 reproduces
    # sequential insert semantics exactly.
    wave_size: int = 1024
    # Queries expanded per beam-search step (1 = pgvector's one-candidate-
    # at-a-time HnswSearchLayer order; >1 trades extra distance evals for
    # fewer, larger TPU steps).
    expand_per_step: int = 1
    # Same, for construction-time searches. >1 shortens the serial while-
    # loop (the build-throughput bottleneck) at a small recall cost.
    build_expand_per_step: int = 1
    # Width of the upper-level descent beam at query time. 1 = pgvector's
    # ef=1 greedy descent; wider closes multi-basin routing misses on
    # bulk-built (pure-kNN level 0) graphs at small upper-level cost.
    descent_ef: int = 1
    # Merge within-wave brute-force top-k into each wave element's candidate
    # set before neighbor selection. Compensates for wave staleness (elements
    # of one wave not seeing each other), restoring the sequential build's
    # connectivity at large wave sizes. No-op at wave_size=1.
    link_within_wave: bool = True
    seed: int = 0

    def __post_init__(self):
        if isinstance(self.metric, str):
            # accept the SQL-ish spelling ("l2", "cosine", ...) so the
            # engines' `config.metric is Metric.X` checks stay exact
            object.__setattr__(self, "metric", Metric(self.metric))
        if not (0 < self.dim <= MAX_DIM):
            raise ValueError(f"dim must be in [1, {MAX_DIM}], got {self.dim}")
        if not (HNSW_MIN_M <= self.m <= HNSW_MAX_M):
            raise ValueError(f"m must be in [{HNSW_MIN_M}, {HNSW_MAX_M}], got {self.m}")
        if not (HNSW_MIN_EFC <= self.ef_construction <= HNSW_MAX_EFC):
            raise ValueError(
                f"ef_construction must be in [{HNSW_MIN_EFC}, {HNSW_MAX_EFC}]"
            )
        if self.ef_construction < 2 * self.m:
            # upstream hnswbuild errors with "ef_construction must be greater
            # than or equal to 2 * m"
            raise ValueError("ef_construction must be >= 2 * m")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError("dtype must be float32 or bfloat16")
        if self.metric in (Metric.HAMMING, Metric.JACCARD):
            # bit-vector opclasses ride BinaryHnswIndex (index/binary.py),
            # which encodes bits into the dense engines
            raise ValueError(
                f"{self.metric} is not supported by the HNSW index; "
                "use BinaryHnswIndex for bit vectors"
            )

    @property
    def ml(self) -> float:
        """Level normalization factor, upstream ``HnswGetMl``: 1/ln(m)."""
        return 1.0 / math.log(self.m)

    @property
    def m0(self) -> int:
        """Level-0 degree cap, upstream ``HnswGetLayerM`` (2*m at level 0)."""
        return 2 * self.m

    def layer_m(self, level: int) -> int:
        return self.m0 if level == 0 else self.m


def validate_ef_search(ef_search: int) -> int:
    """Validate the per-scan ef_search GUC (range 1..1000 upstream)."""
    if not (HNSW_MIN_EFS <= ef_search <= HNSW_MAX_EFS):
        raise ValueError(
            f"ef_search must be in [{HNSW_MIN_EFS}, {HNSW_MAX_EFS}], got {ef_search}"
        )
    return ef_search
