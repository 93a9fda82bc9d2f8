"""The harness's own arithmetic on the CPU: the roofline's byte count, the
trace's interval sums, the row generator, the plain reference, the
numbers that decide ``correct``, and the import check.

    python -m pytest hnswbench/tests -q
"""

import math
import subprocess
import sys

import pytest
import torch

from hnswbench import check, data, isolation, reference, roofline
from hnswbench.spec import ROOT
from hnswbench.trace import Trace, capture_device, gaps, span, union_length

torch.set_num_threads(1)


def test_expand_bytes_hand_counted():
    # B=10 blocks of S=4 int8 rows of 8 bytes; queries 2, probes 3; block
    # ids -1 and 12 are out of range, so blocks 0, 3 and 9 are read once
    bids = torch.tensor([[0, 3, -1], [3, 9, 12]])
    per_block = 4 * 8 + 8 * 4 + 4          # rows, norms and ids, scale
    want = (3 * per_block + 2 * 8           # blocks, int8 queries
            + 4 * 2 * 2 + 8 * 2 * 3         # query scales and norms, bids
            + 12 * 2 * 2)                   # r = 2 scores and positions
    got = roofline.expand_bytes((10, 4, 8), 1, bids, 10, scaled=True,
                                filtered=False, out_bytes=12 * 2 * 2)
    assert got == want == 332
    ms, by = roofline.expand_bound((10, 4, 8), torch.int8, bids,
                                   scaled=True, filtered=False,
                                   out_bytes=48)
    assert by == "bytes" and ms == pytest.approx(332 / 3.35e12 * 1e3)


def test_bound_picks_the_larger_term():
    assert roofline.bound(3.35e9, 1.0, "int8") == (pytest.approx(1.0),
                                                    "bytes")
    ms, by = roofline.bound(1.0, 67e9, "float32")
    assert by == "operations" and ms == pytest.approx(1.0)


def test_union_and_gaps():
    iv = [(5, 6), (0, 2), (1, 3)]
    assert union_length(iv) == 4
    assert gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert gaps(iv, 0.5, 2.5) == []


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    return Trace([
        _ev("user_annotation", "route", 5, 4),
        _ev("gpu_user_annotation", "route", 10, 10),
        _ev("kernel", "k1", 12, 3),
        _ev("kernel", "k2", 18, 7),
        _ev("gpu_memcpy", "copy", 30, 1),
        _ev("kernel", "k1", 95, 10),    # runs past the window's end
    ], 0, 100, [(0, 40, "dispatch"), (60, 90, "wait")])


def test_range_times_sums_device_time_inside_the_range():
    rec = _trace().range_times(["route", "expand"])
    assert rec["route"] == {"device_ms": pytest.approx(0.005),
                            "span_ms": pytest.approx(0.010),
                            "host_ms": pytest.approx(0.004), "count": 1}
    assert rec["expand"]["count"] == 0


def test_busy_idle_and_top_ops():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s() == pytest.approx(16e-6)   # 3 + 7 + 1 + 5 (clipped)
    assert tr.top_device_ops(2) == [["k1", pytest.approx(13e-6)],
                                    ["k2", pytest.approx(7e-6)]]
    idle = dict(tr.idle_by_host_span())
    # gaps 0-12 and 15-18 and 25-30 and 31-40 under dispatch, 40-60 and
    # 90-95 under none, 60-90 under wait
    assert idle["dispatch"] == pytest.approx(29e-6)
    assert idle["other"] == pytest.approx(25e-6)
    assert idle["wait"] == pytest.approx(30e-6)


def test_device_capture_maps_host_spans_onto_its_window():
    def window(host):
        with span("dispatch", host):
            sum(range(20_000))
        with span("wait", host):
            pass
        return "done"

    out, tr = capture_device(window)
    assert out == "done" and not tr.device_ops
    names = [name for _, _, name in tr.host_spans]
    assert names == ["dispatch", "wait"]
    first, last = tr.host_spans[0], tr.host_spans[-1]
    assert tr.start <= first[0] < first[1] <= last[0] <= last[1] <= tr.end
    assert tr.busy_s() == 0.0 and tr.window_s > 0
    idle = dict(tr.idle_by_host_span())
    assert sum(idle.values()) == pytest.approx(tr.window_s)
    assert span("x", None) is span("y", None)


def test_clustered_rows_follow_the_recipe():
    rows, q = data.clustered(20_000, 32, 500, seed=2**31 + 17, device="cpu")
    again, q2 = data.clustered(20_000, 32, 500, seed=2**31 + 17,
                               device="cpu")
    other, _ = data.clustered(20_000, 32, 500, seed=5, device="cpu")
    assert rows.shape == (20_000, 32) and q.shape == (500, 32)
    assert torch.equal(rows, again) and torch.equal(q, q2)
    assert not torch.equal(rows, other)
    # 16 centres of scale 4 plus unit noise: each coordinate's variance
    # about 17; each query lies 0.1 * sqrt(d) from its row
    assert 12 < float(rows.var(0).mean()) < 22
    near = torch.cdist(q, rows).min(1).values
    assert float(near.median()) == pytest.approx(0.1 * math.sqrt(32),
                                                 rel=0.2)
    unit, uq = data.clustered(5000, 8, 50, seed=1, device="cpu",
                              normalize=True)
    assert torch.allclose(unit.norm(dim=1), torch.ones(5000), atol=1e-6)
    assert torch.allclose(uq.norm(dim=1), torch.ones(50), atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_exact_topk_is_brute_force(monkeypatch, metric):
    monkeypatch.setattr(reference, "ROW_BLOCK", 700)
    monkeypatch.setattr(reference, "QUERY_BLOCK", 64)
    rows, q = data.clustered(3000, 16, 150, seed=3, device="cpu")
    sc, ids = reference.exact_topk(rows, q, 10, metric)
    x, qq = rows.double(), q.double()
    full = (torch.cdist(qq, x) ** 2 if metric == "l2" else -(qq @ x.T))
    want = torch.topk(full, 10, dim=1, largest=False)
    assert torch.equal(ids, want.indices)
    assert torch.allclose(sc.double(), want.values, rtol=1e-4, atol=1e-3)
    true, scale = reference.pair_scores(rows, q, ids, metric)
    assert torch.allclose(true, want.values, rtol=1e-12, atol=1e-9)
    assert bool((scale > 0).all())


def test_tf32_rounding():
    x = torch.randn(10_000) * 1e3
    t = reference.tf32(x)
    assert bool(((t.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((t - x).abs() <= x.abs() * 2.0 ** -11).all())
    assert float(reference.tf32(torch.tensor([1.0 + 2.0 ** -11]))) == 1.0
    # products of two rounded values are exact in f32
    a, b = reference.tf32(torch.randn(1000)), reference.tf32(torch.randn(1000))
    assert torch.equal((a * b).double(), a.double() * b.double())


def test_check_numbers():
    rows = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    q = rows[:2] + 0.5
    ids = torch.tensor([[0, 1, 2], [1, 2, 3]])
    true, _ = reference.pair_scores(rows, q, ids, "l2")
    dist = reference.scores_to_distances(true.float(), "l2")
    assert check.bad_rows(dist, ids, 10) == 0
    assert check.dist_gap(rows, q, dist, ids, "l2") < 1e-6
    bad = ids.clone()
    bad[0, 1] = 0
    assert check.bad_rows(dist, bad, 10) == 1              # id twice
    assert check.bad_rows(dist, torch.tensor([[0, 1, 10], [1, 2, -1]]),
                          10) == 2                          # out of range
    assert check.bad_rows(dist.flip(1), ids, 10) == 2       # not ascending
    assert check.dist_gap(rows, q, dist, ids.flip(1), "l2") > 1e-2
    assert check.recall(ids, torch.tensor([[0, 1, 9], [3, 2, 1]])) == 5 / 6
    got = check.results(rows, q, torch.tensor([[0, 1, 9], [3, 2, 1]]),
                        (torch.arange(2), dist, ids), "l2", 3)
    assert got["missed_at_10"] == pytest.approx(1 / 6)
    assert got["recall"] == pytest.approx(5 / 6)
    assert check.results(rows, q, ids, None, "l2", 3)["missed_at_10"] == 1
    assert check.rows_lost(torch.arange(10), rows, rows) == 0
    assert check.rows_lost(torch.arange(5), rows[:5], rows) == 5
    moved = rows.clone()
    moved[3, 0] += 1
    assert check.rows_lost(torch.arange(10), moved, rows) == 1
    assert check.rows_lost(torch.tensor([0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11]),
                           torch.cat([rows[:1], rows, rows[:1]]), rows) == 2
    ok, compared = check.judge({"dist_gap": 1e-7, "bad_rows": 0},
                               {"dist_gap": 1e-6, "bad_rows": 0})
    assert ok and compared["dist_gap"] == {"value": 1e-7, "limit": 1e-6}
    assert not check.judge({"dist_gap": math.nan}, {"dist_gap": 1e-6})[0]


def test_forbidden_modules_compares_top_level_names_whole():
    names = ["jax.numpy", "tpu_hnsw_torch.ops", "tpu_hnsw.index", "numpy",
             "jaxlib", "flaxen"]
    assert isolation.forbidden_modules(names) == ["jax.numpy", "jaxlib",
                                                  "tpu_hnsw.index"]


def test_a_run_imports_no_jax():
    code = ("import hnswbench.run, hnswbench.calibrate, tpu_hnsw_torch; "
            "from hnswbench import isolation, spec; "
            "[spec.module('engines', e) for e in ('block', "
            "'partitioned_block')]; "
            "print(isolation.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
