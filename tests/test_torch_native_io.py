"""tpu_hnsw_torch.io.native and the native-first readers against numpy and
against tpu_hnsw's own native library: fvecs, bvecs and blob round trips
equal, and the greedy capacity-balanced assignment gives the reference's
``assign`` and ``free`` on the same candidates. The port builds and loads
its own copy of the library, never the reference's."""

import os

import numpy as np
import pytest
import torch

from tpu_hnsw.io import datasets as RDS
from tpu_hnsw.io import native as RN
from tpu_hnsw_torch.io import datasets as DS
from tpu_hnsw_torch.io import native as N

torch.set_num_threads(1)


def test_the_library_loads_from_the_ports_build_dir():
    lib = N.load()
    assert lib is not None, "g++ is on this host: the library must load"
    path = os.path.realpath(lib._name)
    assert path.startswith(os.path.realpath(N.BUILD_DIR))
    assert path == os.path.realpath(N.library_path())
    ref = RN.load()
    assert ref is not None and os.path.realpath(ref._name) != path


def test_fvecs_round_trip(tmp_path):
    x = np.random.default_rng(0).normal(size=(500, 65)).astype(np.float32)
    p = str(tmp_path / "x.fvecs")
    DS.write_fvecs(p, x)
    nat = N.read_fvecs_native(p)
    assert nat is not None
    np.testing.assert_array_equal(nat, x)
    np.testing.assert_array_equal(DS.read_fvecs_numpy(p), x)
    np.testing.assert_array_equal(DS.read_fvecs(p), RDS.read_fvecs(p))
    for count in (0, 1, 100, 999):
        np.testing.assert_array_equal(DS.read_fvecs(p, count=count),
                                      x[:count])
    ii = np.random.default_rng(1).integers(-5, 1 << 30, size=(9, 4)).astype(
        np.int32)
    DS.write_ivecs(str(tmp_path / "i.ivecs"), ii)
    np.testing.assert_array_equal(DS.read_ivecs(str(tmp_path / "i.ivecs")),
                                  ii)


def test_bvecs_round_trip(tmp_path):
    u = np.random.default_rng(2).integers(0, 256, size=(300, 37)).astype(
        np.uint8)
    p = str(tmp_path / "u.bvecs")
    DS.write_bvecs(p, u)
    for got in (N.read_bvecs_native(p), DS.read_bvecs_numpy(p),
                DS.read_bvecs(p), RDS.read_bvecs(p)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, u)
    np.testing.assert_array_equal(DS.read_bvecs(p, count=7), u[:7])
    np.testing.assert_array_equal(DS.read_bvecs(p, count=0), u[:0])


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8])
def test_blob_round_trip(tmp_path, dtype):
    a = np.random.default_rng(3).integers(0, 120, size=(1000, 33)).astype(
        dtype)
    p = str(tmp_path / "a.blob")
    assert N.blob_write(p, a)
    np.testing.assert_array_equal(N.blob_read(p, a.shape, a.dtype), a)
    np.testing.assert_array_equal(RN.blob_read(p, a.shape, a.dtype), a)
    assert RN.blob_write(p, a[::-1])
    np.testing.assert_array_equal(N.blob_read(p, a.shape, a.dtype), a[::-1])


def test_balanced_assign_greedy_equals_reference():
    rng = np.random.default_rng(4)
    n, t, B, cap = 2000, 4, 24, 80
    cand_i = rng.integers(0, B, size=(n, t)).astype(np.int32)
    cand_i[rng.random((n, t)) < 0.05] = -1  # invalid choices keep rounds
    cand_d = rng.random((n, t)).astype(np.float32)
    cand_d[:50] = 0.5  # ties resolve by row
    out = {}
    for name, fn in (("port", N.balanced_assign_greedy_native),
                     ("ref", RN.balanced_assign_greedy_native)):
        assign = np.full(n, -1, np.int64)
        free = np.full(B, cap, np.int64)
        got = fn(cand_i, cand_d, B, assign, free)
        out[name] = (got, assign, free)
    assert out["port"][0] == out["ref"][0] > 0
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])
    np.testing.assert_array_equal(out["port"][2], out["ref"][2])
    assert (np.bincount(out["port"][1][out["port"][1] >= 0],
                        minlength=B) <= cap).all()


def test_balanced_assign_rejects_wrong_arrays():
    cand = np.zeros((4, 2), np.int64)  # int64 where the C side reads int32
    with pytest.raises(ValueError):
        N.balanced_assign_greedy_native(
            cand, np.zeros((4, 2), np.float32), 2, np.full(4, -1, np.int64),
            np.full(2, 4, np.int64))


def test_numpy_only_without_a_compiler(tmp_path, monkeypatch):
    """A host without g++ reads through numpy; a host with g++ whose
    build fails raises instead of passing silently."""
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    p = str(tmp_path / "x.fvecs")
    DS.write_fvecs(p, x)
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(N, "_TRIED", False)
    monkeypatch.setattr(N.shutil, "which", lambda name: None)
    assert N.load() is None
    np.testing.assert_array_equal(DS.read_fvecs(p), x)
    np.testing.assert_array_equal(DS.read_fvecs(p, count=2), x[:2])
    assert N.blob_write(str(tmp_path / "b"), x)
    np.testing.assert_array_equal(
        N.blob_read(str(tmp_path / "b"), x.shape, x.dtype), x)

    bad = tmp_path / "io_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.undo()
    monkeypatch.setattr(N, "_LIB", None)
    monkeypatch.setattr(N, "_TRIED", False)
    monkeypatch.setattr(N, "SOURCE", str(bad))
    monkeypatch.setattr(N, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.load()
