"""tpu_hnsw_torch — the PyTorch / CUDA port of ``tpu_hnsw``.

The same index classes, configuration and result contract (distances in
pgvector operator units, -1 for a missing id), on torch tensors. Every
TPU kernel on a ported path is a CUDA kernel written for Hopper
(``csrc/``), with a plain PyTorch version that runs on CPU tensors.

This package imports neither JAX nor ``tpu_hnsw``.
"""

import torch

# Exact paths rely on full-f32 matrix products, as the reference forces
# Precision.HIGHEST: TF32 keeps ~3 decimal digits, and the |q|^2+|x|^2-2q.x
# form loses nearest-neighbour order to it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from tpu_hnsw_torch.config import HnswConfig, Metric  # noqa: E402
from tpu_hnsw_torch.index.binary import BinaryHnswIndex  # noqa: E402
from tpu_hnsw_torch.index.block import BlockHnswIndex  # noqa: E402
from tpu_hnsw_torch.index.flat import FlatIndex  # noqa: E402
from tpu_hnsw_torch.index.hnsw import HnswIndex  # noqa: E402
from tpu_hnsw_torch.index.ivf import IvfFlatIndex  # noqa: E402
from tpu_hnsw_torch.index.sparse_ann import SparseHnswIndex  # noqa: E402
from tpu_hnsw_torch.ops.bitops import BinaryFlatIndex  # noqa: E402
from tpu_hnsw_torch.ops.sparse import SparseFlatIndex, SparseVecs  # noqa: E402
from tpu_hnsw_torch.parallel.partition import (  # noqa: E402
    PartitionedHnswIndex, ShardedBlockSearcher, ShardedHnswSearcher)

__all__ = ["BinaryFlatIndex", "BinaryHnswIndex", "BlockHnswIndex",
           "FlatIndex", "HnswConfig", "HnswIndex", "IvfFlatIndex", "Metric",
           "PartitionedHnswIndex", "ShardedBlockSearcher",
           "ShardedHnswSearcher", "SparseFlatIndex", "SparseHnswIndex",
           "SparseVecs"]
