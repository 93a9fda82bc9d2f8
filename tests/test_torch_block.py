"""tpu_hnsw_torch BlockHnswIndex against tpu_hnsw BlockHnswIndex.

(a) carried state: the reference builds, its arrays load into the port
    through ``from_state``, and both serve the same index;
(b) the port's own build from the same data and seed;
(c) IP and cosine.
On CPU the reference's approx_min_k returns the exact top-k, so its
serving path is exact-top-k like the port's.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw.index.block import BlockHnswIndex as JBlock
from tpu_hnsw.index.block import _make_score_copy as j_make_score_copy
from tpu_hnsw_torch import BlockHnswIndex, FlatIndex, HnswConfig, Metric
from tpu_hnsw_torch.index.block import _make_score_copy
from tpu_hnsw_torch.io.datasets import synthetic_clustered
from tpu_hnsw_torch.utils.recall import recall_at_k

torch.set_num_threads(1)

CFG = HnswConfig(dim=32, m=8, ef_construction=32, seed=1)
STATE_KEYS = ("blocks", "blocks_sq", "block_ids", "blocks_score",
              "score_scale", "centroids", "centroids_sq")


def _data(n=8192, d=32, nq=64, seed=0):
    return synthetic_clustered(n, d, n_queries=nq, seed=seed)


@pytest.fixture(scope="module")
def ref():
    """The reference index at n=8192 (S=64, 135 blocks), its exported
    state, and the exact ground truth."""
    from tpu_hnsw import HnswConfig as JCfg

    base, q = _data()
    jidx = JBlock(JCfg(dim=32, m=8, ef_construction=32, seed=1),
                  block_size=64).build(base)
    state = {k: np.asarray(getattr(jidx, k)) for k in STATE_KEYS}
    state.update(n=jidx.n, n_blocks=jidx.n_blocks)
    gt = FlatIndex(base, Metric.L2,
                   device="cpu").search(q, k=10, exact=True)[1]
    return base, q, jidx, state, gt


def _assert_sq_close(d, jd, base, q):
    """L2 distances agree as squared distances within d * eps_f32 *
    (max|q|^2 + max|x|^2): the worst-case rounding of f32 sums of d terms
    (Higham's gamma_d) in |q|^2 + |x|^2 - 2q.x, which both packages
    compute in f32 in different summation orders. A relative tolerance on
    a small distance would hold them to digits f32 never had."""
    scale = float((base ** 2).sum(1).max() + (q ** 2).sum(1).max())
    tol = base.shape[1] * np.finfo(np.float32).eps * scale
    err = np.abs(d.astype(np.float64) ** 2 - jd.astype(np.float64) ** 2)
    assert err.max(initial=0.0) <= tol, (err.max(), tol)


def _assert_ids_equal_up_to_ties(ids, jids, d, jd, base, q):
    """Ids agree except where two rows tie within f32 rounding: where the
    ids differ, the distances at that rank agree (_assert_sq_close)."""
    diff = ids != jids
    assert diff.mean() <= 0.01
    _assert_sq_close(d[diff], jd[diff], base, q)


def test_carried_state_single_stage_all_probes_matches(ref):
    base, q, jidx, state, gt = ref
    idx = BlockHnswIndex.from_state(CFG, state, block_size=64, device="cpu")
    idx.two_stage = jidx.two_stage = False
    try:
        jd, jids = jidx.search(q, k=10, probes=jidx.n_blocks)
    finally:
        jidx.two_stage = True
    d, ids = idx.search(q, k=10, probes=idx.n_blocks)
    _assert_ids_equal_up_to_ties(ids, jids, d, jd, base, q)
    assert recall_at_k(ids, gt, 10) == 1.0


def test_carried_state_int8_two_stage_agrees(ref):
    """int8 stage 1 + exact rerank at probes=16: >= 99% of ids agree,
    recall within 0.005 of the reference's, and the distances of matching
    ids agree to f32 rounding (both rerank exactly in f32;
    _assert_sq_close states the bound)."""
    base, q, jidx, state, gt = ref
    idx = BlockHnswIndex.from_state(CFG, state, block_size=64, device="cpu")
    assert idx.score_dtype == "int8" and idx.blocks_score.shape[2] == 32
    jd, jids = jidx.search(q, k=10, probes=16)
    d, ids = idx.search(q, k=10, probes=16)
    same = ids == jids
    assert same.mean() >= 0.99
    assert abs(recall_at_k(ids, gt, 10) - recall_at_k(jids, gt, 10)) <= 0.005
    _assert_sq_close(d[same], jd[same], base, q)


def test_score_copy_bytes_match_reference(ref):
    """int8 copy and per-block scales equal the reference's for the same
    blocks (the reference pads d=32 to 128 zero lanes; the port to 16 bytes)."""
    _, _, jidx, state, _ = ref
    j8, jscale = j_make_score_copy(jidx.blocks)
    c8, scale = _make_score_copy(torch.from_numpy(state["blocks"]))
    np.testing.assert_array_equal(c8.numpy(), np.asarray(j8)[..., :32])
    assert not np.asarray(j8)[..., 32:].any()
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


def test_own_build_all_probes_matches_exact_oracle():
    base, q = _data(n=4096)
    idx = BlockHnswIndex(CFG, block_size=64, device="cpu").build(base)
    gt = FlatIndex(base, Metric.L2,
                   device="cpu").search(q, k=10, exact=True)[1]
    _, ids = idx.search(q, k=10, probes=idx.n_blocks)
    assert recall_at_k(ids, gt, 10) == 1.0


@pytest.mark.parametrize("score_dtype", ["int8", "bf16"])
def test_own_build_recall_at_modest_probes(ref, score_dtype):
    """16 of 135 blocks probed: recall >= 0.95 and within 0.02 of the
    reference build's (same data, same seed)."""
    base, q, jidx, _, gt = ref
    idx = BlockHnswIndex(CFG, block_size=64, device="cpu")
    idx.score_dtype = score_dtype
    idx.build(base)
    assert idx.n_blocks == jidx.n_blocks
    _, ids = idx.search(q, k=10, probes=16)
    _, jids = jidx.search(q, k=10, probes=16)
    r = recall_at_k(ids, gt, 10)
    assert r >= 0.95
    assert abs(r - recall_at_k(jids, gt, 10)) <= 0.02
    # every row is placed exactly once
    live = idx.block_ids[idx.block_ids >= 0].numpy()
    assert np.array_equal(np.sort(live), np.arange(len(base)))


def test_device_tensor_build_and_exhaustive_scan():
    """A tensor input builds the same index as the array input; with the
    exhaustive-scan threshold lowered, probes >= n_blocks takes _scan_all
    and stays exact."""
    base, q = _data(n=4096)
    gt = FlatIndex(base, Metric.L2,
                   device="cpu").search(q, k=10, exact=True)[1]
    a = BlockHnswIndex(CFG, block_size=64, device="cpu").build(base)
    b = BlockHnswIndex(CFG, block_size=64,
                       device="cpu").build(torch.from_numpy(base))
    assert torch.equal(a.block_ids, b.block_ids)
    assert b.build_stats["device_resident_input"]
    b.EXHAUSTIVE_SCAN_MIN_BLOCKS = 0
    _, ids = b.search(torch.from_numpy(q), k=10, probes=b.n_blocks)
    assert recall_at_k(ids, gt, 10) == 1.0


def test_cosine_metric():
    base, q = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, metric=Metric.COSINE)
    idx = BlockHnswIndex(cfg, block_size=64, device="cpu").build(base)
    gt = FlatIndex(base, Metric.COSINE,
                   device="cpu").search(q, k=10, exact=True)[1]
    _, ids = idx.search(q, k=10, probes=16)
    assert recall_at_k(ids, gt, 10) >= 0.9
    d, _ = idx.search(q[:4], k=5, probes=idx.n_blocks)  # 1 - cos in [0, 2]
    assert (d >= -1e-5).all() and (d <= 2 + 1e-5).all()


def test_ip_metric():
    base, q = _data(n=4096)
    cfg = HnswConfig(dim=32, m=8, ef_construction=32, metric=Metric.IP)
    idx = BlockHnswIndex(cfg, block_size=64, device="cpu").build(base)
    gt = FlatIndex(base, Metric.IP,
                   device="cpu").search(q, k=10, exact=True)[1]
    _, ids = idx.search(q, k=10, probes=24)
    assert recall_at_k(ids, gt, 10) >= 0.9


def test_later_slices_raise_not_implemented(tmp_path):
    """Graph routing, once a later slice that raised, now works: asking for
    it, or needing it ("auto" above EXACT_ROUTING_MAX blocks), builds a
    centroid HnswIndex that routes the search; "exact" still scans every
    centroid at any block count; a saved centroid_graph/ loads back and
    serves the same ids."""
    from tpu_hnsw_torch import HnswIndex

    base, q = _data(n=1024)
    gt = FlatIndex(base, Metric.L2, device="cpu").search(q, k=10,
                                                        exact=True)[1]
    graph = BlockHnswIndex(CFG, routing="graph", block_size=64,
                           device="cpu").build(base)
    assert isinstance(graph.centroid_index, HnswIndex)
    assert graph.centroid_index.n == graph.n_blocks == 17
    assert graph.stats()["routing"] == "graph"
    # "auto" needs graph routing above EXACT_ROUTING_MAX blocks
    auto = BlockHnswIndex(CFG, block_size=64, device="cpu")
    auto.EXACT_ROUTING_MAX = 8
    assert auto.build(base).stats()["routing"] == "graph"
    assert auto.centroid_index is not None
    exact = BlockHnswIndex(CFG, block_size=64, routing="exact", device="cpu")
    exact.EXACT_ROUTING_MAX = 8
    assert exact.build(base).n_blocks == 17
    assert exact.centroid_index is None and "centroid_graph" not in \
        exact.stats()["memory_bytes"]
    d, ids = graph.search(q, k=10, probes=graph.n_blocks)
    assert recall_at_k(ids, gt, 10) == 1.0
    _, ids = graph.search(q, k=10, probes=6)
    graph.save(str(tmp_path / "x"))
    assert (tmp_path / "x" / "centroid_graph" / "meta.json").exists()
    back = BlockHnswIndex.load(str(tmp_path / "x"), device="cpu")
    assert back.centroid_index.n == 17
    np.testing.assert_array_equal(back.search(q, k=10, probes=6)[1], ids)


def test_block_index_defaults_to_the_card(tmp_path, monkeypatch):
    """No device means CUDA, for the constructor and for the loaders;
    without a card both raise at construction."""
    assert BlockHnswIndex(CFG, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert BlockHnswIndex(CFG).device.type == "cuda"
        return
    base, _ = _data(n=512)
    BlockHnswIndex(CFG, block_size=64, device="cpu").build(base).save(
        str(tmp_path / "x"))
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockHnswIndex(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockHnswIndex.load(str(tmp_path / "x"))
    # the default itself, where a card is reported
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert BlockHnswIndex(CFG).device.type == "cuda"


def _tie_state(seed=21, B=12, S=32, d=32, Q=16, p=4):
    """Carried state whose int8 copy is exact: rows drawn from 6 patterns of
    small integers with a 127 column (per-block and per-query scales are
    1), so stage-1 scores equal the exact distances and tie in groups."""
    rng = np.random.default_rng(seed)
    pats = rng.integers(-1, 2, size=(6, d)).astype(np.int8)
    pats[:, 0] = 127
    rows = pats[rng.integers(0, 6, size=(B, S))]
    block_ids = np.where(rng.random((B, S)) < 0.1, -1,
                         np.arange(B * S).reshape(B, S)).astype(np.int32)
    q = rng.integers(-1, 2, size=(Q, d)).astype(np.float32)
    q[:, 0] = 127.0
    bids = np.stack([rng.permutation(B)[:p] for _ in range(Q)]).astype(
        np.int32)
    x = rows.astype(np.float32)
    return dict(blocks8=rows, x=x, blocks_sq=(x * x).sum(-1),
                block_ids=block_ids, q=q, q_sq=(q * q).sum(1), bids=bids,
                allowed=rng.random((B, S)) < 0.7)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked", [False, True])
def test_expand_blocks_2stage_ties_match_jax(metric, masked, monkeypatch):
    """The port's two-stage expansion against JAX's
    _expand_blocks_2stage_body on the same tie-heavy carried state: the
    stage-2 distances equal exactly (integers in f32), and the ids agree
    up to ties: below each query's k-th distance the same ids, each
    returned id at its own exact distance. JAX's CPU approx_min_k orders
    tied entries arbitrarily, so ids at the k-th place may differ; with
    lax.top_k in its place (the same set, ordered by (score, position) as
    the port's stage 1) the reference returns the port's ids exactly."""
    import jax.numpy as jnp

    from tpu_hnsw.config import Metric as JMetric
    from tpu_hnsw.index.block import _expand_blocks_2stage_body
    from tpu_hnsw.ops import topk as JT
    from tpu_hnsw_torch.index.block import Stored, _expand_step

    st = _tie_state()
    B, S, d = st["x"].shape
    k, rerank = 10, 40
    allowed = st["allowed"] if masked else None

    def reference():
        jv, ji = _expand_blocks_2stage_body(
            jnp.asarray(st["blocks8"]), jnp.asarray(st["blocks_sq"]),
            jnp.asarray(st["block_ids"]), jnp.asarray(st["x"].reshape(-1, d)),
            jnp.asarray(st["q"]), jnp.asarray(st["q_sq"]),
            jnp.asarray(st["bids"]), k=k, rerank=rerank,
            metric=JMetric(metric), score_scale=jnp.ones(B, jnp.float32),
            allowed=None if allowed is None else jnp.asarray(allowed))
        return np.asarray(jv), np.asarray(ji)

    jv, ji = reference()
    t = torch.from_numpy
    stored = Stored(t(st["x"]), t(st["blocks8"]), t(st["blocks_sq"]),
                    t(st["block_ids"]), torch.ones(B), two_stage=True,
                    rerank=rerank)
    v, i = _expand_step(
        stored, t(st["q"]), t(st["q_sq"]), t(st["bids"]), k=k,
        metric=Metric(metric),
        allowed=None if allowed is None else t(allowed))
    v, i = v.numpy(), i.numpy()
    np.testing.assert_array_equal(v, jv)
    kth = v[:, -1:]
    for row in range(v.shape[0]):
        below = v[row] < kth[row]
        assert set(i[row][below]) == set(ji[row][below])
    # every returned id at its exact distance (ids are flat slots here)
    x = st["x"].reshape(-1, d)
    live = i >= 0
    dots = np.einsum("qkd,qd->qk", x[np.where(live, i, 0)], st["q"])
    want = (st["q_sq"][:, None] + (x * x).sum(1)[np.where(live, i, 0)]
            - 2 * dots) if metric == "l2" else -dots
    np.testing.assert_array_equal(v[live], want[live])
    # the case ties: some query returns equal distances
    ties = (v[:, :, None] == v[:, None, :]).sum(-1) > 1
    assert ties.any()
    monkeypatch.setattr(JT, "topk_smallest_fast",
                        lambda s, k, **_: JT.topk_smallest(s, k))
    jv2, ji2 = reference()
    np.testing.assert_array_equal(jv2, v)
    np.testing.assert_array_equal(ji2, i)
