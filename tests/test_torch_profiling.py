"""The span recorder of ``tpu_hnsw_torch/utils/profiling.py`` on the CPU:
the span trees of a ``BlockHnswIndex`` search (exact and graph-routed),
a ``ShardedBlockSearcher`` search and a block build (names, parents,
roots, work counts, children inside their parents); results
bit-identical with a sink open and closed;
no sink, no record and the shared no-op; and, under ``trace()`` and
``record()`` together, each span within 1 ms of its ``record_function``
range on the exported trace's clock. ``test_expand_range_on_card``
checks on a card that the traced ``expand`` range still spans the
kernels of ``stage1`` and ``rerank``:
``python -m pytest --noconftest tests/test_torch_profiling.py -m cuda``."""

import json

import pytest
import torch

from tpu_hnsw_torch import BlockHnswIndex, HnswConfig, PartitionedHnswIndex
from tpu_hnsw_torch.io import datasets as DS
from tpu_hnsw_torch.utils import profiling

torch.set_num_threads(1)

DIM, BLOCK, PROBES, K = 8, 32, 4, 5


@pytest.fixture(scope="module")
def data():
    return DS.synthetic_clustered(900, DIM, n_queries=12, seed=3)


@pytest.fixture(scope="module")
def index(data):
    return BlockHnswIndex(HnswConfig(dim=DIM), block_size=BLOCK,
                          device="cpu").build(data[0])


@pytest.fixture(scope="module")
def stacked(data):
    part = PartitionedHnswIndex(HnswConfig(dim=DIM), n_partitions=4,
                                router="hash", engine="block",
                                block_size=BLOCK, device="cpu")
    return part.build(data[0]).sharded()


def _tree(spans):
    """{name: [spans]} after checking parents, roots and nesting."""
    by: dict = {}
    for i, s in enumerate(spans):
        by.setdefault(s.name, []).append(s)
        assert s.start <= s.end
        if s.parent < 0:
            assert s.root == i
        else:
            p = spans[s.parent]
            assert s.parent < i and s.root == p.root
            assert p.start <= s.start and s.end <= p.end
    return by


def _children(spans, parent_name):
    return sorted({spans[i].name for i, s in enumerate(spans)
                   if s.parent >= 0 and spans[s.parent].name == parent_name})


def test_block_search_span_tree(index, data):
    q = data[1]
    with profiling.record() as rec:
        index.search_device(torch.from_numpy(q), k=K, probes=PROBES)
        index.search_device(q[:3], k=K, probes=PROBES)
    spans = rec.spans
    by = _tree(spans)
    assert [s.name for s in spans if s.parent < 0] == ["search", "search"]
    assert _children(spans, "search") == ["expand", "queries", "route"]
    assert _children(spans, "expand") == ["rerank", "stage1"]
    assert len(by["stage1"]) == len(by["rerank"]) == 2
    # the two requests: distinct roots, each request's spans under its own
    assert len({s.root for s in spans}) == 2
    for name in ("search", "queries", "route", "expand"):
        assert [s.work for s in by[name]] == [len(q), 3]
    assert [s.work for s in by["stage1"]] == [len(q) * PROBES, 3 * PROBES]
    r = min(index.rerank_width, PROBES * BLOCK)
    assert [s.work for s in by["rerank"]] == [len(q) * r, 3 * r]


def test_stacked_search_span_tree(stacked, data):
    q = data[1]
    with profiling.record() as rec:
        stacked.search_device(q, k=K, probes=2)
    spans = rec.spans
    by = _tree(spans)
    assert [s.name for s in spans if s.parent < 0] == ["search"]
    assert _children(spans, "search") == ["expand", "ici_merge", "queries",
                                          "route"]
    assert _children(spans, "expand") == ["rerank", "stage1"]
    L = stacked.blocks.shape[0]
    assert by["search"][0].work == by["ici_merge"][0].work == len(q)
    assert by["stage1"][0].work == len(q) * L * 2


def test_graph_routed_search_records_route_and_expand(data):
    """Graph routing records the request's spans as the exact route does:
    ``route`` (the centroid graph's own search inside it) and ``expand``
    (with ``stage1`` and ``rerank``) under ``search``, each counting the
    queries."""
    idx = BlockHnswIndex(HnswConfig(dim=DIM), block_size=BLOCK,
                         routing="graph", device="cpu").build(data[0])
    q = data[1]
    with profiling.record() as rec:
        idx.search_device(q, k=K, probes=PROBES)
    spans = rec.spans
    by = _tree(spans)
    assert spans[0].name == "search" and spans[0].parent < 0
    assert sorted(s.name for s in spans if s.parent == 0) == [
        "expand", "queries", "route"]
    expand = spans.index(by["expand"][0])
    assert sorted(s.name for s in spans if s.parent == expand) == [
        "rerank", "stage1"]
    for name in ("route", "expand"):
        assert [s.work for s in by[name]] == [len(q)]


def test_build_span_tree_keeps_build_stats(data):
    def build():
        return BlockHnswIndex(HnswConfig(dim=DIM), block_size=BLOCK,
                              device="cpu").build(data[0])

    plain = build()
    with profiling.record() as rec:
        idx = build()
    spans = rec.spans
    by = _tree(spans)
    assert [s.name for s in spans if s.parent < 0] == [
        "kmeans", "balanced_assign", "install"]
    assert _children(spans, "kmeans") == ["kmeans_lloyd", "kmeans_refill",
                                          "kmeans_sample"]
    assert _children(spans, "balanced_assign") == ["assign_rounds",
                                                   "assign_topk"]
    assert len(by["kmeans_lloyd"]) == len(by["kmeans_refill"]) == 3
    n = len(data[0])
    for name in ("kmeans", "kmeans_sample", "kmeans_lloyd",
                 "balanced_assign", "assign_topk", "assign_rounds",
                 "install"):
        assert all(s.work == n for s in by[name]), name
    assert all(s.work >= 0 for s in by["kmeans_refill"])
    assert list(idx.build_stats) == list(plain.build_stats)
    torch.testing.assert_close(idx.blocks, plain.blocks, rtol=0, atol=0)
    assert torch.equal(idx.block_ids, plain.block_ids)


def test_results_equal_with_the_sink_open_and_closed(index, stacked, data):
    q = data[1]
    d0, i0 = index.search_device(q, k=K, probes=PROBES)
    s0, g0 = stacked.search_device(q, k=K, probes=2)
    with profiling.record():
        d1, i1 = index.search_device(q, k=K, probes=PROBES)
        s1, g1 = stacked.search_device(q, k=K, probes=2)
    for a, b in ((d0, d1), (i0, i1), (s0, s1), (g0, g1)):
        assert torch.equal(a, b)


def test_no_sink_records_nothing(index, data):
    assert profiling.annotate("search") is profiling.annotate("rerank", 3)
    with profiling.annotate("search") as span:
        span.work = 5  # dropped
    with profiling.record() as rec:
        pass
    index.search_device(data[1], k=K, probes=PROBES)
    assert rec.spans == []
    with profiling.record() as rec:
        with pytest.raises(RuntimeError):
            with profiling.record():
                pass
    assert profiling.annotate("search") is profiling.annotate("expand")


def test_spans_lie_on_the_trace_clock(index, data, tmp_path):
    q = data[1]
    with profiling.trace(str(tmp_path)):
        # the profiler's first ranges of a process open slowly
        index.search_device(q, k=K, probes=PROBES)
        with profiling.record() as rec:
            index.search_device(q, k=K, probes=PROBES)
            index.search_device(q, k=K, probes=PROBES)
    with open(tmp_path / profiling.TRACE_FILE) as f:
        doc = json.load(f)
    names = {s.name for s in rec.spans}
    ranges = sorted((ev["ts"], ev["ts"] + ev["dur"], ev["name"])
                    for ev in doc["traceEvents"]
                    if ev.get("cat") == "user_annotation"
                    and ev.get("name") in names)[len(names):]
    spans = sorted((s.start, s.end, s.name) for s in rec.spans)
    assert [r[2] for r in ranges] == [s[2] for s in spans]
    for (a0, a1, _), (b0, b1, _) in zip(ranges, spans):
        assert abs(a0 - b0) < 1e3 and abs(a1 - b1) < 1e3


@pytest.mark.cuda
def test_expand_range_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # d = 16: the int8 copy needs no padding, as at d = 128
    base, q = DS.synthetic_clustered(900, 16, n_queries=64, seed=4)
    idx = BlockHnswIndex(HnswConfig(dim=16), block_size=BLOCK,
                         device="cuda").build(base)
    qt = torch.from_numpy(q).cuda()
    idx.search_device(qt, k=K, probes=PROBES)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        idx.search_device(qt, k=K, probes=PROBES)
    names = ("route", "expand", "stage1", "rerank")
    r = profiling.range_times(str(tmp_path / profiling.TRACE_FILE), names)
    assert all(r[n]["span_ms"] > 0 and r[n]["count"] == 1 for n in names)
    assert r["expand"]["device_ms"] >= \
        r["stage1"]["device_ms"] + r["rerank"]["device_ms"]
