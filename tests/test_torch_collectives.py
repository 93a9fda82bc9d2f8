"""tpu_hnsw_torch.parallel.collectives against tpu_hnsw.parallel.collectives
on the same seeded lists (tests/torch_dist_worker.py's cases): small integer
distances with ties, replica ids repeated with equal distances, missing
results; and distinct floats.

The reference runs under ``shard_map`` on conftest's virtual CPU devices (4
along one axis; a (2, 2) mesh for the hierarchical merge); the port runs in
one spawned gloo group of 4 ranks that covers every case, rendezvous
through a FileStore under the test's tmp_path. The port's ring equals the
gather at ties and with replicas; the reference's does not (ROADMAP.md
queue 3).
"""

import sys
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from tpu_hnsw.parallel import collectives as JC
from tpu_hnsw_torch.parallel import collectives as C

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_worker as W  # noqa: E402

torch.set_num_threads(1)

CASES = [(name, dedup) for name in ("ties", "floats")
         for dedup in (False, True)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of the 4-rank gloo run."""
    return W.spawn("collectives", W.RANKS,
                   str(tmp_path_factory.mktemp("gloo")))


def _jax_merge(fn, mesh, spec, d, ids):
    """``fn(d, i)`` on each device of ``mesh`` over its rank's lists;
    returns every device's result, ``[RANKS, Q, K]`` each."""
    def body(d, i):
        v, j = fn(d[0], i[0])
        return v[None], j[None]

    run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(spec, spec),
                                out_specs=(spec, spec), check_vma=False))
    v, j = run(jnp.asarray(d), jnp.asarray(ids.astype(np.int32)))
    return np.asarray(v), np.asarray(j)


def _line():
    return Mesh(np.array(jax.devices()[:W.RANKS]), ("chip",)), P("chip")


def _square():
    devs = np.array(jax.devices()[:W.RANKS]).reshape(2, W.RANKS // 2)
    return Mesh(devs, ("slice", "chip")), P(("slice", "chip"))


def _jax_gather(d, ids, dedup):
    mesh, spec = _line()
    return _jax_merge(lambda a, b: JC.gather_merge_topk(
        a, b, W.K, "chip", dedup=dedup), mesh, spec, d, ids)


def _assert_rank_equal(ranks, key, want_d, want_i):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[key + "_d"], want_d[r])
        np.testing.assert_array_equal(out[key + "_i"], want_i[r])


@pytest.mark.parametrize("name,dedup", CASES)
def test_gather_matches_reference(ranks, name, dedup):
    """all_gather + keyed top-k: every rank's values and ids equal the
    reference's on every device, ties to the lower rank-major column."""
    d, ids = W.collective_cases()[name]
    jd, ji = _jax_gather(d, ids, dedup)
    _assert_rank_equal(ranks, f"gather_{name}_{int(dedup)}", jd, ji)


@pytest.mark.parametrize("name,dedup", CASES)
def test_ring_equals_gather(ranks, name, dedup):
    """The ring gives the gather's values and ids on every rank, ties and
    replicas included; the reference's ring agrees with it on distinct
    floats only."""
    d, ids = W.collective_cases()[name]
    jd, ji = _jax_gather(d, ids, dedup)
    _assert_rank_equal(ranks, f"ring_{name}_{int(dedup)}", jd, ji)
    mesh, spec = _line()
    rd, ri = _jax_merge(lambda a, b: JC.ring_merge_topk(
        a, b, W.K, "chip", dedup=dedup), mesh, spec, d, ids)
    if name == "floats":
        np.testing.assert_array_equal(ri, ji)
        np.testing.assert_array_equal(rd, jd)
    else:  # the reference defect the port repairs
        assert not np.array_equal(ri, ji)


@pytest.mark.parametrize("name,dedup", CASES)
def test_hierarchical_matches_reference(ranks, name, dedup):
    """Intra gather, then inter gather, over a (2, 2) DeviceMesh's groups:
    equal to the reference's on a (2, 2) mesh, and to the flat gather."""
    d, ids = W.collective_cases()[name]
    mesh, spec = _square()
    hd, hi = _jax_merge(lambda a, b: JC.hierarchical_merge_topk(
        a, b, W.K, "chip", "slice", dedup=dedup), mesh, spec, d, ids)
    _assert_rank_equal(ranks, f"hier_{name}_{int(dedup)}", hd, hi)
    jd, ji = _jax_gather(d, ids, dedup)
    np.testing.assert_array_equal(hi, ji)
    np.testing.assert_array_equal(hd, jd)


@pytest.mark.parametrize("name,dedup", CASES)
def test_device_mesh_dimension_is_a_group(ranks, name, dedup):
    """A 1-D DeviceMesh (one dimension of the (2, 2) mesh) merges over its
    own ranks: each slice's result is the local merge of that slice's two
    ranks' lists."""
    d, ids = W.collective_cases()[name]
    for r, out in enumerate(ranks):
        s = r // 2
        cat = lambda a: np.concatenate(list(a[2 * s:2 * s + 2]), axis=1)
        v, i = C.gather_merge_topk(torch.from_numpy(cat(d)),
                                   torch.from_numpy(cat(ids)), W.K,
                                   dedup=dedup)
        np.testing.assert_array_equal(out[f"chip_{name}_{int(dedup)}_d"],
                                      v.numpy())
        np.testing.assert_array_equal(out[f"chip_{name}_{int(dedup)}_i"],
                                      i.numpy())


@pytest.mark.parametrize("name,dedup", CASES)
@pytest.mark.parametrize("merge", ["gather", "ring", "hierarchical"])
def test_no_group_is_the_local_merge(merge, name, dedup):
    """Without a process group every merge is the local one over the
    rank-major concatenation: the reference's gather on the 4-device mesh
    (its one-device concat, dedup and top-k, partition.py:1386-1392)."""
    d, ids = W.collective_cases()[name]
    cat = lambda a: torch.from_numpy(np.concatenate(list(a), axis=1))
    fn = {"gather": C.gather_merge_topk, "ring": C.ring_merge_topk,
          "hierarchical": C.hierarchical_merge_topk}[merge]
    v, i = fn(cat(d), cat(ids), W.K, dedup=dedup)
    jd, ji = _jax_gather(d, ids, dedup)
    np.testing.assert_array_equal(v.numpy(), jd[0])
    np.testing.assert_array_equal(i.numpy(), ji[0])
