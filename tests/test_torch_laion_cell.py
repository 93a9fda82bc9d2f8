"""The ``laion12m5.bulk`` cell's path on the CPU at a tiny size:
``PartitionedHnswIndex(engine="block")`` built in the process from rows
already in a tensor, with bf16 storage, the bf16 scoring copy aliasing
it, block slack 1.10 and rerank 128 (``hnswbench/configs/laion12m5.json``),
then ``.sharded()`` and ``release_parts_device_state()``.

- its stacked layout equals, bit for bit, what ``save`` and
  ``ShardedBlockSearcher.from_saved(score_dtype="bf16")`` make of the same
  index: blocks, global ids, row norms, centroids and their norms;
- a stored row is the unit row rounded to bf16 once (the ``dist_gap``
  limit's premise);
- the stacked answers against the harness's plain reference
  (``hnswbench/reference.py``): ids at every probe equal ``exact_topk``'s
  over the stored rows up to ties, distances within f32 rounding of
  float64 ``pair_scores``, and within the cell's ``dist_gap`` limit of the
  drawn f32 rows' scores;
- the engine's cosine-to-ip mapping (``hnswbench/engines/
  partitioned_bf16.py``);
- the default build, config D's (``deep10m.bulk``), is as before: int8
  copy with scales, rerank 40, slack 1.05, each part equal to a
  ``BlockHnswIndex`` built with its defaults, and the same tensors from
  host rows and from a tensor.
"""

import os

import numpy as np
import pytest
import torch

from hnswbench import reference as REF
from hnswbench import spec
from tpu_hnsw_torch import (BlockHnswIndex, HnswConfig, Metric,
                            PartitionedHnswIndex, ShardedBlockSearcher)
from tpu_hnsw_torch.ops import distance as D

torch.set_num_threads(1)

P, N, DIM, NQ, K = 4, 4096, 512, 48, 10
S, SLACK, RERANK = 32, 1.10, 128
CFG = dict(dim=DIM, metric=Metric.COSINE, m=16, ef_construction=64,
           dtype="bfloat16", seed=0)
CONFIG = os.path.join(spec.ROOT, "hnswbench", "configs", "laion12m5.json")
#: the rerank's f32 sum of DIM products of unit vectors (|q . x| <= 1)
F32_TOL = DIM * float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def data():
    """Unit rows of the harness's recipe (``hnswbench/data.py``) and noisy
    unit queries near them, f32."""
    from hnswbench import data as HD

    return HD.clustered(N, DIM, NQ, seed=2**31 + 5, device="cpu",
                        normalize=True)


def _laion(**kw) -> PartitionedHnswIndex:
    return PartitionedHnswIndex(HnswConfig(**CFG), P, router="hash",
                                engine="block", block_size=S, device="cpu",
                                score_dtype="bf16", rerank_width=RERANK,
                                block_slack=SLACK, **kw)


@pytest.fixture(scope="module")
def built(data, tmp_path_factory):
    """(the stacked searcher of the in-process build, released; the same
    index saved and loaded by ``from_saved(score_dtype="bf16")``)."""
    pidx = _laion().build(data[0])
    path = str(tmp_path_factory.mktemp("laion_parts"))
    pidx.save(path)
    sh = pidx.sharded()
    sh.release_parts_device_state()
    return sh, ShardedBlockSearcher.from_saved(path, device="cpu",
                                               score_dtype="bf16")


def test_in_process_build_equals_the_saved_layout(built):
    sh, ld = built
    assert sh.blocks.dtype == torch.bfloat16 and sh.blocks_score is sh.blocks
    assert ld.blocks_score is ld.blocks and sh.score_scales is None
    assert sh.rerank_width == RERANK  # save keeps no rerank width
    b = sh.blocks.shape[1]
    assert b == -(-int(N / P * SLACK) // S)
    for name in ("blocks", "block_gids", "blocks_sq", "centroids",
                 "centroids_sq"):
        got, want = getattr(sh, name), getattr(ld, name)
        assert got.dtype == want.dtype, name
        assert torch.equal(got, want[:, :b]), name
        assert not want[:, b:].any(), name  # from_saved's slab padding


def test_a_stored_row_is_rounded_once(built, data):
    sh = built[0]
    live = sh.block_gids >= 0
    gids = sh.block_gids[live].long()
    assert torch.equal(torch.sort(gids).values, torch.arange(N))
    want = D.l2_normalize(data[0][gids]).to(torch.bfloat16)
    assert torch.equal(sh.blocks[live], want)


@pytest.mark.parametrize("probes", [4, 40])
def test_stacked_answers_against_the_plain_reference(built, data, probes):
    """At 40 probes (every block) the search is exhaustive: ids equal the
    reference's over the stored rows but for ties; at 4 the ids found are
    scored as the reference scores them."""
    sh, (rows, q) = built[0], data
    stored = torch.zeros((N, DIM))
    live = sh.block_gids >= 0
    stored[sh.block_gids[live].long()] = sh.blocks[live].float()
    sc, ids = sh.search_device(q, k=K, probes=probes)
    assert (ids >= 0).all()
    assert all(len(set(r)) == K for r in ids.tolist())
    # distances: f32 rounding of the stored rows' float64 <#> scores, and
    # within the cell's dist_gap limit of the drawn rows' scores
    limit = spec.load_json(CONFIG)["limits"]["dist_gap"]
    exact, _ = REF.pair_scores(stored, q, ids, "ip")
    assert (sc.double() - exact).abs().max() <= F32_TOL
    drawn, scale = REF.pair_scores(rows, q, ids, "ip")
    assert ((sc.double() - drawn).abs() / scale).max() <= limit
    if probes >= sh.blocks.shape[1]:
        want_s, want = REF.exact_topk(stored, q, K, "ip")
        diff = ids != want
        assert diff.float().mean() <= 0.02
        assert ((sc - want_s).abs() <= F32_TOL).all()


def test_engine_maps_cosine_onto_ip(built, data):
    from hnswbench.engines import partitioned_bf16 as E

    sh, q = built[0], data[1]
    got, ids = E.search(sh, q, K, 8)
    raw, want = sh.search_device(q, k=K, probes=8)
    assert torch.equal(ids, want) and torch.equal(got, raw)
    d, _ = sh.search(q, k=K, probes=8)  # pgvector's <=>, 1 - cos
    assert np.abs(d - 1.0 - got.numpy()).max() <= 2 ** -23
    cfg = E.index_config(spec.load_json(CONFIG))
    assert cfg.metric is Metric.COSINE and cfg.dtype == "bfloat16"


@pytest.mark.parametrize("router", ["hash", "centroid"])
def test_the_default_build_is_config_d(data, router):
    """No keyword: each part is the block engine's default (int8 copy with
    per-block scales, rerank 40, slack 1.05) over its router's rows, and
    host rows build the same tensors as the tensor of rows."""
    rows = data[0][:1024, :64].contiguous()
    cfg = HnswConfig(dim=64, metric=Metric.IP, seed=0)

    def build(x):
        return PartitionedHnswIndex(cfg, P, router=router, engine="block",
                                    block_size=S, device="cpu").build(x)

    host, dev = build(rows.numpy()), build(rows)
    assert np.array_equal(host._part_of, dev._part_of)
    for a, b in zip(host.parts, dev.parts):
        assert (a.score_dtype, a.rerank_width, a.block_slack) == (
            "int8", 40, 1.05)
        ref = BlockHnswIndex(cfg, block_size=S, device="cpu").build(
            rows.numpy()[a._global_ids])
        for sub in (b, ref):
            for name in ("blocks", "blocks_sq", "block_ids", "blocks_score",
                         "score_scale", "centroids", "centroids_sq"):
                assert torch.equal(getattr(a, name), getattr(sub, name)), name
    sh = dev.sharded()
    assert sh.blocks_score.dtype == torch.int8 and sh.rerank_width == 40
