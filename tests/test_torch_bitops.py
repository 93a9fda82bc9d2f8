"""Binary-vector ops: tpu_hnsw_torch.ops.bitops / ops.hamming against
tpu_hnsw.ops.bitops / ops.pallas_hamming.

Hamming counts are integers and jaccard is one f32 division of integers,
so distances are compared exactly. Hamming distances tie everywhere; the
flat top-k orders ties by id, as the reference's ``lax.top_k`` on the
negated distances does, so ids are compared exactly too.

JAX is imported inside the tests that compare against it, so the card's
machine (no JAX) can collect this file and run the card tests alone:
``python -m pytest --noconftest tests/test_torch_bitops.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.ops import bitops as B
from tpu_hnsw_torch.ops import hamming as H
from tpu_hnsw_torch.ops import topk as T
from tpu_hnsw_torch.ops.vector_ops import binary_quantize

torch.set_num_threads(1)


def _words(rng, shape):
    """Random uint32 words with the edge patterns mixed in."""
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    flat = w.reshape(-1)
    flat[::7] = 0xFFFFFFFF
    flat[1::11] = 0x80000000
    flat[2::13] = 0
    return w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(n, nbits, seed):
    return np.random.default_rng(seed).integers(0, 2, size=(n, nbits),
                                                dtype=np.uint8)


@pytest.mark.parametrize("nbits", [32, 256, 100, 1500])
def test_pack_bits_byte_equal_to_jax(nbits):
    from tpu_hnsw.ops import bitops as JB

    bits = _bits(37, nbits, seed=nbits)
    want = JB.pack_bits(bits)
    got = B.pack_bits(bits)
    assert got.dtype == np.uint32
    assert got.tobytes() == want.tobytes()
    # the tensor form: int32 words with the same bits
    gt = B.pack_bits(_t(bits))
    assert gt.dtype == torch.int32
    assert gt.numpy().view(np.uint32).tobytes() == want.tobytes()


def test_popcount_and_distances_equal_jax():
    """Exact: integer counts, and jaccard's one f32 division of integers."""
    import jax.numpy as jnp

    from tpu_hnsw.ops import bitops as JB

    rng = np.random.default_rng(1)
    a, b = _words(rng, (9, 5)), _words(rng, (9, 5))
    np.testing.assert_array_equal(
        H.popcount(_t(a)).numpy(), np.asarray(JB.popcount(jnp.asarray(a))))
    np.testing.assert_array_equal(
        B.hamming_distance(_t(a), _t(b)).numpy(),
        np.asarray(JB.hamming_distance(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        B.jaccard_distance(_t(a), _t(b)).numpy(),
        np.asarray(JB.jaccard_distance(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(
        B.pairwise_hamming(_t(a), _t(b)).numpy(),
        np.asarray(JB.pairwise_hamming(jnp.asarray(a), jnp.asarray(b))))


def test_jaccard_of_empty_rows_is_nan_like_the_reference():
    z = torch.zeros((1, 3), dtype=torch.int32)
    assert torch.isnan(B.jaccard_distance(z, z)).all()


@pytest.mark.parametrize("nbits", [256, 1500])  # W = 8, and a ragged W = 47
def test_hamming_scan_reference_equals_pallas_interpret(nbits):
    """The plain version against the Pallas kernel in interpret mode, as
    tests/test_pallas_kernels.py runs it: int32, exactly equal."""
    import jax.numpy as jnp

    from tpu_hnsw.ops.pallas_hamming import hamming_scan as pallas_scan

    rng = np.random.default_rng(nbits)
    W = -(-nbits // 32)
    q, x = _words(rng, (16, W)), _words(rng, (256, W))
    want = np.asarray(pallas_scan(jnp.asarray(q), jnp.asarray(x), tq=8,
                                  blk=128, interpret=True))
    before = H.LAUNCHES
    got = H.hamming_scan(_t(q), _t(x))  # CPU tensors: the plain version
    assert H.LAUNCHES == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # ragged Q and N are the caller's shape: no padding needed
    np.testing.assert_array_equal(
        H.hamming_scan(_t(q[:5]), _t(x[:77])).numpy(), want[:5, :77])


def _clustered_bits(n, nbits, nq, flip, seed):
    """Planted centers with ``flip``-rate bit noise: heavy ties at 0.02."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2, size=(8, nbits), dtype=np.uint8)
    base = centers[rng.integers(0, 8, n)] ^ (rng.random((n, nbits)) < flip)
    q = base[rng.integers(0, n, nq)] ^ (rng.random((nq, nbits)) < flip / 2)
    return base.astype(np.uint8), q.astype(np.uint8)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_binary_flat_index_matches_jax(metric):
    """Distances and ids exactly equal to the reference's: hamming counts,
    jaccard's own f32 division, ties ordered by id."""
    from tpu_hnsw.ops.bitops import BinaryFlatIndex as JFlat

    base, q = _clustered_bits(600, 200, 24, 0.1, seed=5)
    pq = B.pack_bits(q)
    jd, jids = JFlat.from_bits(base, metric=metric).search(pq, k=10)
    d, ids = B.BinaryFlatIndex.from_bits(base, metric=metric,
                                         device="cpu").search(pq, k=10)
    assert d.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(ids, jids)


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("nbits", [200, 1500])
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_binary_flat_index_ties_match_jax(metric, nbits, k):
    """Tie-heavy data (2% flips), an all-zero query and an all-zero row:
    the same ids and distances as the reference, at every k."""
    from tpu_hnsw.ops.bitops import BinaryFlatIndex as JFlat

    base, q = _clustered_bits(400, nbits, 12, 0.02, seed=nbits + k)
    base[7] = 0
    q[2] = 0
    pq = B.pack_bits(q)
    jd, jids = JFlat.from_bits(base, metric=metric).search(pq, k=k)
    d, ids = B.BinaryFlatIndex.from_bits(base, metric=metric,
                                         device="cpu").search(pq, k=k)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(ids, jids)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_hamming_topk_reference_equals_jax_search(metric):
    """The fused entry's plain version is the reference's flat search."""
    from tpu_hnsw.ops.bitops import BinaryFlatIndex as JFlat

    base, q = _clustered_bits(300, 100, 9, 0.02, seed=3)
    base[0] = 0
    q[0] = 0
    pb, pq = B.pack_bits(base), B.pack_bits(q)
    jd, jids = JFlat(pb, metric=metric).search(pq, k=20)
    qt, xt = _t(pq.view(np.int32)), _t(pb.view(np.int32))
    before = H.LAUNCHES
    d, ids = H.hamming_topk(qt, xt, H.row_popcount(qt), H.row_popcount(xt),
                            20, metric)  # CPU tensors: the plain version
    assert H.LAUNCHES == before
    assert d.dtype == torch.float32 and ids.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), jd)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_array_equal(
        d.numpy(), H.hamming_topk_reference(qt, xt, H.row_popcount(qt),
                                            H.row_popcount(xt), 20,
                                            metric)[0].numpy())


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_flat_search_above_the_fused_limit_agrees(metric):
    """k above hamming.TOPK_MAX_K takes the all-pairs branch; its first
    TOPK_MAX_K columns are the fused branch's results, ids included."""
    base, q = _clustered_bits(500, 96, 10, 0.02, seed=11)
    flat = B.BinaryFlatIndex.from_bits(base, metric=metric, device="cpu")
    pq = B.pack_bits(q)
    kmax = H.TOPK_MAX_K
    d_big, i_big = flat.search(pq, k=kmax + 50)
    d, ids = flat.search(pq, k=kmax)
    np.testing.assert_array_equal(d_big[:, :kmax], d)
    np.testing.assert_array_equal(i_big[:, :kmax], ids)
    assert (np.diff(d_big, axis=1) >= 0).all()


def test_binary_flat_index_defaults_to_the_card():
    """With no device the table goes to CUDA; without a card that raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        assert B.BinaryFlatIndex(_words(np.random.default_rng(0), (
            4, 2))).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        B.BinaryFlatIndex(_words(np.random.default_rng(0), (4, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        B.BinaryFlatIndex.from_bits(_bits(4, 40, seed=0), metric="jaccard")


def test_jaccard_identity_equals_and_or_form():
    """inter = (pa + pb - h) / 2 and union = (pa + pb + h) / 2 give the
    AND/OR form's distances exactly, all-zero rows included (0 / max(0, 1)
    -> distance 1, as the reference's flat index gives)."""
    rng = np.random.default_rng(9)
    x = _words(rng, (50, 4))
    x[3] = 0
    q = _words(rng, (6, 4))
    q[1] = 0
    flat = B.BinaryFlatIndex(x, metric="jaccard", device="cpu")
    d, ids = flat.search(q, k=50)
    qt, xt = _t(q.view(np.int32)), _t(x.view(np.int32))
    inter = H.popcount(qt[:, None] & xt[None]).sum(-1, dtype=torch.int32)
    union = H.popcount(qt[:, None] | xt[None]).sum(-1, dtype=torch.int32)
    want = (1.0 - inter.float() / torch.clamp_min(union, 1).float()).numpy()
    np.testing.assert_array_equal(
        np.take_along_axis(want, ids.astype(np.int64), axis=1), d)
    np.testing.assert_array_equal(np.sort(want, axis=1), d)
    assert (d[1] == 1.0).all()  # the zero query shares no bit with any row


def test_binary_quantize_matches_jax():
    import jax.numpy as jnp

    from tpu_hnsw.ops.vector_ops import binary_quantize as j_bq

    x = np.random.default_rng(2).normal(size=(7, 33)).astype(np.float32)
    x[0, :4] = 0.0
    got = binary_quantize(x)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_bq(jnp.asarray(x))))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 8, 47, 48, 2000])
def test_hamming_kernel_matches_reference_on_card(W):
    """The CUDA kernel against the plain version on the same card tensors,
    ragged Q and N (not multiples of the 64 x 128 tile): exactly equal."""
    dev = _card()
    rng = np.random.default_rng(W)
    Q, N = 37, 1000 if W < 2000 else 300
    q = _t(_words(rng, (Q, W))).to(dev)
    x = _t(_words(rng, (N, W))).to(dev)
    before = H.LAUNCHES
    got = H.hamming_scan(q, x)
    torch.cuda.synchronize()
    assert H.LAUNCHES == before + 1
    assert torch.equal(got, H.hamming_scan_reference(q, x))
    # a table 4 bytes off 16-byte alignment takes the 4-byte loads
    buf = torch.empty(N * W + 1, dtype=torch.int32, device=dev)
    xm = buf[1:].view(N, W)
    xm.copy_(x.view(torch.int32))
    assert torch.equal(H.hamming_scan(q, xm), got)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 8, 47, 48, 2000, 2048])
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_hamming_topk_matches_reference_on_card(metric, W):
    """The fused top-k against its plain version: the same distances and
    ids, exactly, at k in {1, 10, 100}; ragged Q and N, empty rows and an
    empty query (jaccard's max(union, 1)), tie-heavy rows, and a table 4
    bytes off alignment. W = 2048 (65,536 bits) is past the width where
    the jaccard prefilter's 32-bit products stay exact, so it is off."""
    dev = _card()
    rng = np.random.default_rng(100 + W)
    Q, N = 76, 1000 if W < 2000 else 300
    q = _t(_words(rng, (Q, W))).to(dev)
    x = _t(_words(rng, (N, W))).to(dev)
    x[5] = 0
    x[9] = 0
    q[3] = 0
    x[100:160] = x[20]  # 60 rows at one distance from every query
    buf = torch.empty(N * W + 1, dtype=torch.int32, device=dev)
    xm = buf[1:].view(N, W)
    xm.copy_(x)
    pq, px = H.row_popcount(q), H.row_popcount(x)
    for k in (1, 10, 100):
        want = H.hamming_topk_reference(q, x, pq, px, k, metric)
        for table in (x, xm):
            before = (H.LAUNCHES, H.TOPK_LAUNCHES)
            got = H.hamming_topk(q, table, pq, px, k, metric)
            torch.cuda.synchronize()
            assert (H.LAUNCHES, H.TOPK_LAUNCHES) == (before[0] + 1,
                                                     before[1] + 1)
            assert torch.equal(got[0], want[0]), (k, "distances")
            assert torch.equal(got[1], want[1]), (k, "ids")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [47, 2000])  # 4-byte loads; many chunks
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_hamming_topk_walks_many_tiles_on_card(metric, W):
    """Enough rows that each CTA walks about ten 128-row tiles, so the
    running lists carry across tiles (the strict first pass, the k-th key
    filter, staged keys merged later): exactly equal to the plain version
    at k in {10, 100}. Copies of one row sit in several tiles and CTA
    ranges, and queries near that row put them in the top-k as ties."""
    dev = _card()
    rng = np.random.default_rng(200 + W)
    Q, N = 2048, 20_000
    q = _t(_words(rng, (Q, W))).to(dev)
    x = _t(_words(rng, (N, W))).to(dev)
    for s in (130, 300, 1500, 2900, 9000, 19_950):
        x[s:s + 30] = x[20]
    x[40] = 0
    q[:8] = x[20]
    q[1, : W // 2 + 1] = 0  # near the copies, not equal to them
    q[2, W // 2:] = -1
    per, ns = H._splits(Q, N, dev)
    assert per // H._BN >= 8, (per, ns)
    pq, px = H.row_popcount(q), H.row_popcount(x)
    d_ref = H.distances(H.hamming_scan_reference(q, x), pq, px, metric)
    for k in (10, 100):
        want = T.topk_smallest_by_index(d_ref, k)
        got = H.hamming_topk(q, x, pq, px, k, metric)
        assert torch.equal(got[0], want[0]), (k, "distances")
        assert torch.equal(got[1], want[1].to(torch.int32)), (k, "ids")


@pytest.mark.cuda
def test_hamming_kernel_hand_computed_on_card():
    """Known answers, with each query's bits in another word than a row's,
    so operand fragments or bit order that disagree between the query and
    the table show; W = 1 and W = 3."""
    dev = _card()
    q1 = torch.tensor([[0xB]], dtype=torch.int32)
    x1 = torch.tensor([[0x1], [0xC], [-1], [-(1 << 31)], [0]],
                      dtype=torch.int32)  # -1: all bits; -(1<<31): bit 31
    want1 = torch.tensor([[2, 3, 29, 4, 3]], dtype=torch.int32)
    q3 = torch.tensor([[0xF, 0, 0], [0, 0, 1 << 30]], dtype=torch.int32)
    x3 = torch.tensor([[0, 0xF, 0], [0xF, 0, 0], [0, 0, 1 << 30],
                       [0, 1 << 30, 0]], dtype=torch.int32)
    want3 = torch.tensor([[8, 0, 5, 5], [5, 5, 0, 2]], dtype=torch.int32)
    for q, x, want in ((q1, x1, want1), (q3, x3, want3)):
        assert torch.equal(H.hamming_scan_reference(q, x), want)
        got = H.hamming_scan(q.to(dev), x.to(dev)).cpu()
        assert torch.equal(got, want)
    qd, xd = q3.to(dev), x3.to(dev)
    d, ids = H.hamming_topk(qd, xd, H.row_popcount(qd), H.row_popcount(xd),
                            4, "hamming")
    assert ids.cpu().tolist() == [[1, 2, 3, 0], [2, 3, 0, 1]]
    assert d.cpu().tolist() == [[0.0, 5.0, 5.0, 8.0], [0.0, 2.0, 5.0, 5.0]]
    d, ids = H.hamming_topk(qd, xd, H.row_popcount(qd), H.row_popcount(xd),
                            4, "jaccard")  # inter / union: 4/4, then 0/5s
    assert ids.cpu().tolist() == [[1, 0, 2, 3], [2, 0, 1, 3]]
    assert d.cpu().tolist() == [[0.0, 1.0, 1.0, 1.0], [0.0, 1.0, 1.0, 1.0]]
