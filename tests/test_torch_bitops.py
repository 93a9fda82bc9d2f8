"""Binary-vector ops: tpu_hnsw_torch.ops.bitops / ops.hamming against
tpu_hnsw.ops.bitops / ops.pallas_hamming.

Hamming counts are integers, so distances are compared exactly. Hamming
distances tie everywhere, and the two packages' top-k order tied ids
differently, so ids are compared tie-aware: a returned id counts when its
true distance is at most the true k-th distance.

JAX is imported inside the tests that compare against it, so the card's
machine (no JAX) can collect this file and run the card tests alone:
``python -m pytest --noconftest tests/test_torch_bitops.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from tpu_hnsw_torch.ops import bitops as B
from tpu_hnsw_torch.ops import hamming as H
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


def _tie_aware_recall(ids, q_packed, x_packed, true_kth):
    """Share of returned ids whose true hamming distance is <= the k-th."""
    d = B.pairwise_hamming(_t(q_packed), _t(x_packed)).numpy()
    got = np.take_along_axis(d, ids.astype(np.int64), axis=1)
    return float((got <= true_kth[:, None]).mean())


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_binary_flat_index_matches_jax(metric):
    """Distances exactly equal (hamming counts; jaccard from the hamming
    identity gives the reference's own f32 division); ids tie-aware."""
    from tpu_hnsw.ops.bitops import BinaryFlatIndex as JFlat

    rng = np.random.default_rng(5)
    centers = rng.integers(0, 2, size=(8, 200), dtype=np.uint8)
    base = centers[rng.integers(0, 8, 600)] ^ (rng.random((600, 200)) < 0.1)
    q = base[rng.integers(0, 600, 24)] ^ (rng.random((24, 200)) < 0.05)
    pb, pq = B.pack_bits(base), B.pack_bits(q)
    jd, jids = JFlat.from_bits(base, metric=metric).search(pq, k=10)
    d, ids = B.BinaryFlatIndex.from_bits(base, metric=metric).search(pq, k=10)
    assert d.dtype == np.float32 and ids.dtype == np.int32
    np.testing.assert_array_equal(d, jd)
    if metric == "hamming":
        assert _tie_aware_recall(ids, pq, pb, jd[:, -1]) == 1.0
    else:  # each returned id has the distance reported at its rank
        a = B.pack_bits(_t(q.astype(np.uint8)))[:, None, :]
        rows = _t(pb.view(np.int32))[ids.astype(np.int64)]
        true = B.jaccard_distance(a.expand_as(rows), rows).numpy()
        np.testing.assert_array_equal(true, d)


def test_jaccard_identity_equals_and_or_form():
    """inter = (pa + pb - h) / 2 and union = (pa + pb + h) / 2 give the
    AND/OR form's distances exactly, all-zero rows included (0 / max(0, 1)
    -> distance 1, as the reference's flat index gives)."""
    rng = np.random.default_rng(9)
    x = _words(rng, (50, 4))
    x[3] = 0
    q = _words(rng, (6, 4))
    q[1] = 0
    flat = B.BinaryFlatIndex(x, metric="jaccard")
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


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 3, 8, 47, 48, 2000])
def test_hamming_kernel_matches_reference_on_card(W):
    """The CUDA kernel against the plain version on the same card tensors,
    ragged Q and N (not multiples of the 32 x 256 tile): exactly equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
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
