"""tpu_hnsw_torch stands alone: importing it and running builds and
searches (block, binary, graph, IVF and partitioned indexes, the lockstep
partition build, the stacked searchers, the merge collectives, the QPS
harness and the sparse indexes) loads neither JAX nor tpu_hnsw. The entry
points added with IVF, partitioning and sparse vectors, and the stacked
searchers, default to the card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = """
import sys
import torch
torch.set_num_threads(1)
from tpu_hnsw_torch import (BinaryFlatIndex, BinaryHnswIndex, BlockHnswIndex,
                            FlatIndex, HnswConfig, HnswIndex, Metric)
from tpu_hnsw_torch.ops.bitops import pack_bits
from tpu_hnsw_torch.ops.vector_ops import binary_quantize
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.utils.recall import recall_at_k
base, q = synthetic_clustered(1024, 16, n_queries=8, seed=0)
idx = BlockHnswIndex(HnswConfig(dim=16, m=8, ef_construction=32),
                     block_size=64, device="cpu").build(base)
_, ids = idx.search(q, k=5, probes=idx.n_blocks)
gt = FlatIndex(base, Metric.L2, device="cpu").search(q, k=5, exact=True)[1]
assert recall_at_k(ids, gt, 5) == 1.0
bits = binary_quantize(base).numpy()
bidx = BinaryHnswIndex(16, engine="block", block_size=64,
                       device="cpu").build(bits)
d, ids = bidx.search(bits[:8], k=5, probes=bidx.inner.n_blocks)
flat = BinaryFlatIndex.from_bits(bits, device="cpu")
gd, _ = flat.search(pack_bits(bits[:8]), k=5)
assert (d == gd).all()
g = HnswIndex(HnswConfig(dim=16, m=8, ef_construction=32, wave_size=64),
              device="cpu").build(base[:400])
_, ids = g.search(q, k=5, ef_search=64)
assert recall_at_k(ids, FlatIndex(base[:400], Metric.L2, device="cpu").search(
    q, k=5, exact=True)[1], 5) >= 0.9
bg = BinaryHnswIndex(16, device="cpu").build(bits[:300])
d, _ = bg.search(bits[:8], k=5)
assert (d[:, 0] == 0).all()
from tpu_hnsw_torch import IvfFlatIndex, PartitionedHnswIndex
from tpu_hnsw_torch.utils.evalharness import measure_qps
ivf = IvfFlatIndex(16, lists=8, device="cpu").build(base)
_, ids = ivf.search(q, k=5, probes=8)
assert recall_at_k(ids, gt, 5) == 1.0
for engine in ("block", "graph"):
    part = PartitionedHnswIndex(HnswConfig(dim=16, m=8, ef_construction=32,
                                           wave_size=64), 2, engine=engine,
                                block_size=64, device="cpu").build(base[:400])
    _, ids = part.search(q, k=5, ef_search=64)
    _, dids = part.search_device(q, k=5, ef_search=64)
    assert (dids.numpy() == ids).all()
    lock = PartitionedHnswIndex(HnswConfig(dim=16, m=8, ef_construction=32,
                                           wave_size=64), 2, engine=engine,
                                block_size=64, device="cpu").build(
        base[:400], mesh="auto")
    assert (lock.search(q, k=5, ef_search=64)[1] == ids).all()
    sh = part.sharded()
    _, sids = sh.search(q, k=5, ef_search=64, merge="ring")
    assert (sids == ids).all()
    if engine == "block":
        import tempfile
        from tpu_hnsw_torch import ShardedBlockSearcher
        with tempfile.TemporaryDirectory() as tmp:
            part.save(tmp)
            ld = ShardedBlockSearcher.from_saved(tmp, chunk_bytes=1 << 14,
                                                 device="cpu")
            assert (ld.search(q, k=5, ef_search=64)[1] == ids).all()
from tpu_hnsw_torch.parallel import collectives as C
d = torch.tensor([[3.0, 1.0, 1.0, 2.0]])
i = torch.tensor([[7, 5, 5, 6]])
for merge in (C.gather_merge_topk, C.ring_merge_topk,
              C.hierarchical_merge_topk):
    v, j = merge(d, i, 3, dedup=True)
    assert v.tolist() == [[1.0, 2.0, 3.0]] and j.tolist() == [[5, 6, 7]]
qps, ids = measure_qps(ivf, q, 5, 0, repeats=1, min_window_s=0.0, probes=8)
assert qps > 0 and recall_at_k(ids, gt, 5) == 1.0
from tpu_hnsw_torch import SparseFlatIndex, SparseHnswIndex, SparseVecs
from tpu_hnsw_torch.io.datasets import synthetic_splade
bi, bv, qi, qv = synthetic_splade(600, vocab=300, nnz=8, n_queries=8, seed=1)
sb, sq = SparseVecs(bi, bv, 300), SparseVecs(qi, qv, 300)
sgt = SparseFlatIndex(sb, Metric.IP, device="cpu").search(sq, k=5)[1]
sidx = SparseHnswIndex(metric="ip", proj_dim=16, block_size=32,
                       device="cpu").build(sb)
assert recall_at_k(sidx.search(sq, k=5, rerank_k=600)[1], sgt, 5) == 1.0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpu_hnsw"))
print("LOADED", bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_ivf_and_partitioned_default_to_the_card(monkeypatch):
    """IvfFlatIndex and PartitionedHnswIndex (and its centroid router) go
    to CUDA without a device; without a card that raises instead of
    running on the CPU."""
    from tpu_hnsw_torch import HnswConfig, IvfFlatIndex, PartitionedHnswIndex

    cfg = HnswConfig(dim=4)
    assert IvfFlatIndex(4, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            IvfFlatIndex(4)
        with pytest.raises(RuntimeError, match="CUDA"):
            PartitionedHnswIndex(cfg, 2, router="centroid")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert IvfFlatIndex(4).device.type == "cuda"
    part = PartitionedHnswIndex(cfg, 2, router="centroid")
    assert part.device.type == part.router.device.type == "cuda"
    cpu = PartitionedHnswIndex(cfg, 2, engine="block", device="cpu").build(
        np.eye(4, dtype=np.float32))
    assert all(s.device.type == "cpu" for s in cpu.parts)
    assert cpu.sharded().blocks.device.type == "cpu"


def test_stacked_searchers_default_to_the_card(tmp_path):
    """sharded() serves on its index's device, and from_saved, without a
    device, on the card: without one it raises instead of running on the
    CPU."""
    from tpu_hnsw_torch import (HnswConfig, PartitionedHnswIndex,
                                ShardedBlockSearcher)

    base = np.random.default_rng(0).normal(size=(64, 4)).astype(np.float32)
    for engine in ("block", "graph"):
        idx = PartitionedHnswIndex(HnswConfig(dim=4), 2, engine=engine,
                                   device="cpu").build(base)
        assert idx.sharded().device.type == "cpu"
    idx = PartitionedHnswIndex(HnswConfig(dim=4), 2, engine="block",
                               device="cpu").build(base)
    idx.save(str(tmp_path / "p"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedBlockSearcher.from_saved(str(tmp_path / "p"))
        return
    assert ShardedBlockSearcher.from_saved(
        str(tmp_path / "p")).device.type == "cuda"


def test_sparse_entry_points_default_to_the_card(monkeypatch):
    """SparseFlatIndex, SparseHnswIndex (and its load) and sparse_distance
    go to CUDA without a device; without a card that raises instead of
    running on the CPU."""
    from tpu_hnsw_torch import SparseFlatIndex, SparseHnswIndex, SparseVecs
    from tpu_hnsw_torch.ops.sparse import sparse_distance

    v = SparseVecs(np.array([[0, 2]]), np.array([[1.0, 2.0]]), 4)
    assert SparseHnswIndex(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert SparseHnswIndex().device.type == "cuda"
        return
    for make in (lambda: SparseHnswIndex(), lambda: SparseFlatIndex(v),
                 lambda: sparse_distance(v, v)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert SparseHnswIndex().device.type == "cuda"
