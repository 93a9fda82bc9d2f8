"""tpu_hnsw_torch.ops.vector_ops against tpu_hnsw.ops.vector_ops: the
pgvector type surface on the same seeded inputs.

f32 reductions agree to rtol 1e-6 (plus the summation bound of their
absolute terms where a sum can cancel); elementwise, integer, text and
byte outputs are exactly equal; every invalid input raises the same
ValueError text; halfvec values are bit-equal (the reference's
``ml_dtypes.bfloat16`` against the port's ``torch.bfloat16``)."""

import numpy as np
import pytest
import torch

from tpu_hnsw.ops import vector_ops as RV
from tpu_hnsw_torch.ops import vector_ops as V

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
A = RNG.normal(size=(5, 17)).astype(np.float32)
B = RNG.normal(size=(5, 17)).astype(np.float32)
F32_EPS = float(np.finfo(np.float32).eps)


def _ref(x) -> np.ndarray:
    return np.asarray(x)


def _port(x) -> np.ndarray:
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    return x.numpy()


@pytest.mark.parametrize("name", [
    "l2_distance", "l2_squared_distance", "inner_product",
    "negative_inner_product", "cosine_distance", "l1_distance"])
@pytest.mark.parametrize("shapes", ["rows", "broadcast"])
def test_distances(name, shapes):
    a, b = (A, B) if shapes == "rows" else (A[0], B)
    want = _ref(getattr(RV, name)(a, b))
    got = _port(getattr(V, name)(a, b))
    assert got.dtype == np.float32 and got.shape == want.shape
    # the cancellation bound of an f32 sum of d terms of these sizes
    terms = np.abs(np.broadcast_to(a, B.shape) * B).sum(-1) \
        + (np.broadcast_to(a, B.shape) ** 2).sum(-1) + (B ** 2).sum(-1)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=0 if name.startswith("l") else
                               17 * F32_EPS * terms.max())


def test_cosine_of_a_zero_vector_is_nan_in_both():
    z = np.zeros((2, 4), np.float32)
    x = np.ones((2, 4), np.float32)
    assert np.isnan(_ref(RV.cosine_distance(z, x))).all()
    assert np.isnan(_port(V.cosine_distance(z, x))).all()


def test_a_tensor_keeps_its_dtype_and_device_and_lists_narrow():
    t = torch.from_numpy(A)
    assert V.l2_distance(t, t).device == t.device
    assert V.vector_add([1.0, 2.0], [3.0, 4.0]).dtype == torch.float32
    assert V.binary_quantize(np.array([1, -1], np.int64)).dtype == torch.uint8
    assert V.vector_dims(A) == RV.vector_dims(A) == 17
    assert V.vector_dims([1, 2, 3]) == RV.vector_dims([1, 2, 3]) == 3


@pytest.mark.parametrize("name", ["vector_add", "vector_sub", "vector_mul",
                                  "vector_concat"])
def test_elementwise_exact(name):
    np.testing.assert_array_equal(_port(getattr(V, name)(A, B)),
                                  _ref(getattr(RV, name)(A, B)))


def test_norms_normalize_subvector_quantize():
    x = A.copy()
    x[1] = 0.0  # upstream returns the zero vector unchanged
    np.testing.assert_allclose(_port(V.vector_norm(x)),
                               _ref(RV.vector_norm(x)), rtol=1e-6)
    np.testing.assert_allclose(_port(V.l2_normalize(x)),
                               _ref(RV.l2_normalize(x)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(_port(V.l2_normalize(x))[1], 0.0)
    np.testing.assert_array_equal(_port(V.subvector(A, 3, 5)),
                                  _ref(RV.subvector(A, 3, 5)))
    np.testing.assert_array_equal(_port(V.subvector(A, 15, 9)),
                                  _ref(RV.subvector(A, 15, 9)))
    np.testing.assert_array_equal(_port(V.binary_quantize(A)),
                                  _ref(RV.binary_quantize(A)))


@pytest.mark.parametrize("name", ["vector_avg", "vector_sum"])
@pytest.mark.parametrize("axis", [0, 1])
def test_aggregates(name, axis):
    want = _ref(getattr(RV, name)(A, axis=axis))
    got = _port(getattr(V, name)(A, axis=axis))
    bound = A.shape[axis] * F32_EPS * np.abs(A).sum(axis).max()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=bound)


def _raises_same(fn_name, *args):
    """Both packages raise ValueError with the same text."""
    with pytest.raises(ValueError) as ref:
        getattr(RV, fn_name)(*args)
    with pytest.raises(ValueError) as port:
        getattr(V, fn_name)(*args)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("fn_name,args", [
    ("l2_distance", (np.zeros(3), np.zeros(4))),
    ("inner_product", (np.zeros((2, 3)), np.zeros((2, 5)))),
    ("vector_add", (np.zeros(3), np.zeros(2))),
    ("vector_concat", (np.zeros(8001, np.float32),
                       np.zeros(8000, np.float32))),
    ("subvector", (np.arange(10, dtype=np.float32), 0, 0)),
    ("subvector", (np.arange(10, dtype=np.float32), 1, 0)),
    ("subvector", (np.arange(10, dtype=np.float32), 11, 1)),
    ("vector_in", ("1,2,3",)),
    ("vector_in", ("[1,,2]",)),
    ("vector_in", ("[1,two]",)),
    ("vector_in", ("[]",)),
    ("vector_in", ("[nan]",)),
    ("vector_in", ("[inf]",)),
    ("vector_in", ("[1e40]",)),
    ("vector_in", ("[" + ",".join(["0"] * 16001) + "]",)),
    ("vector_in", ("[1,2]", 3)),
    ("halfvec_in", ("[3.4e38]",)),
    ("vector_send", (np.zeros(16001, np.float32),)),
    ("vector_recv", (b"\x00\x01",)),
    ("vector_recv", (b"\x00\x02\x00\x00" + b"\x00" * 7,)),
    ("vector_recv", (b"\x00\x00\x00\x00",)),
    ("vector_recv", (b"\x00\x01\x00\x01" + b"\x00" * 4,)),
    ("vector_recv", (b"\x00\x02\x00\x00"
                     + np.asarray([np.nan, 1.0], ">f4").tobytes(),)),
    ("vector_recv", (b"\x00\x01\x00\x00"
                     + np.asarray([np.inf], ">f4").tobytes(),)),
    ("halfvec_recv", (b"\x00",)),
    ("halfvec_recv", (b"\x00\x02\x00\x00\x00",)),
    ("halfvec_recv", (b"\x00\x01\x00\x00"
                      + np.asarray([np.nan], ">f2").tobytes(),)),
    ("halfvec_recv", (b"\x00\x01\x00\x00"
                      + np.asarray([np.inf], ">f2").tobytes(),)),
])
def test_errors_word_for_word(fn_name, args):
    _raises_same(fn_name, *args)


def test_text_io():
    x = (RNG.normal(size=64) * 1e3).astype(np.float32)
    lit = RV.vector_out(x)
    assert V.vector_out(x) == lit
    assert V.vector_out(torch.from_numpy(x)) == lit
    for s in (lit, " [1, 2.5 ,-3e-2] ", "[1e-45]", "[-0.0,3]"):
        np.testing.assert_array_equal(V.vector_in(s), RV.vector_in(s))
    np.testing.assert_array_equal(V.vector_in(lit, dim=64), x)


def _bits(h) -> np.ndarray:
    if isinstance(h, torch.Tensor):
        assert h.dtype == torch.bfloat16
        return h.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(h).view(np.uint16)


def test_halfvec_bits_equal():
    # values that round in bf16, ties to even included
    x = np.concatenate([RNG.normal(size=40) * 300,
                        [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -0.0,
                         3.38e38]]).astype(np.float32)
    lit = RV.vector_out(x)
    ref_h, port_h = RV.halfvec_in(lit), V.halfvec_in(lit)
    np.testing.assert_array_equal(_bits(port_h), _bits(ref_h))
    assert V.halfvec_out(port_h) == RV.halfvec_out(ref_h)
    # fp16 on the wire, bf16 back (values within fp16's range)
    wire = RV.halfvec_send(ref_h[:-1])
    assert V.halfvec_send(port_h[:-1]) == wire
    np.testing.assert_array_equal(_bits(V.halfvec_recv(wire)),
                                  _bits(RV.halfvec_recv(wire)))
    # a float64 list is rounded to fp16 once, as the reference rounds it
    vals = [0.1, 1.0 / 3.0, 65504.0, 1e-7]
    assert V.halfvec_send(vals) == RV.halfvec_send(vals)


def test_vector_send_recv_bytes_equal():
    v = np.asarray([1.5, -2.25, 3e-7, 1e30], np.float32)
    wire = RV.vector_send(v)
    assert V.vector_send(v) == wire
    assert V.vector_send(torch.from_numpy(v)) == wire
    np.testing.assert_array_equal(V.vector_recv(wire), RV.vector_recv(wire))


CMP_CASES = [
    ([1, 2, 3], [1, 2, 4]), ([1, 2, 4], [1, 2, 3]), ([1, 2, 3], [1, 2, 3]),
    ([2], [1, 9, 9]), ([1, 2], [1, 2, 0]), ([1, 2, 0], [1, 2]),
    ([np.nan], [np.inf]), ([np.nan], [np.nan]), ([np.inf], [np.nan]),
    ([-0.0, 1.0], [0.0, 1.0]), ([-np.inf], [-1e30]), ([-2.0], [-1.0]),
    ([-1.0], [0.0]), ([1e-45], [0.0]), ([-1e-45], [0.0]),
]


@pytest.mark.parametrize("a,b", CMP_CASES)
def test_comparison_family(a, b):
    assert V.vector_cmp(a, b) == RV.vector_cmp(a, b)
    for op in ("lt", "le", "eq", "ne", "ge", "gt"):
        assert getattr(V, f"vector_{op}")(a, b) == \
            getattr(RV, f"vector_{op}")(a, b)


def test_sort_keys_equal():
    x = RNG.normal(size=(64, 4)).astype(np.float32)
    x[3, 1] = np.nan
    x[7, 0] = -0.0
    x[9, 2] = -np.inf
    keys = RV.vector_sort_keys(x)
    np.testing.assert_array_equal(V.vector_sort_keys(x), keys)
    np.testing.assert_array_equal(V.vector_sort_keys(torch.from_numpy(x)),
                                  keys)
    np.testing.assert_array_equal(V._cmp_keys(x[0]), RV._cmp_keys(x[0]))
