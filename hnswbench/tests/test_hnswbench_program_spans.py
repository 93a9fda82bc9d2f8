"""The program's spans in the harness (``hnswbench/program_spans.py``) on
the CPU: idle stretches go to the innermost span and each top-level span
keeps its total; ``launches.*`` counts the device operations launched
inside ``search`` spans and reads None where one is unmatched; the tiny
``interactive`` cell at ``--trace 1`` reads ``queries_ms.interactive``; a
window fixed in seconds records nothing. ``test_clock_on_card`` checks the
shared clock on a card and skips without one.

    python -m pytest hnswbench/tests -q
"""

import os
import sys
from types import SimpleNamespace

import pytest
import torch

from hnswbench import loop, program_spans, spec
from hnswbench.run import run_cell
from hnswbench.trace import Trace, capture_device

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_hnswbench_cells import tiny_cell  # noqa: E402

torch.set_num_threads(1)


def _ev(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _idle(host):
    tr = Trace([_ev("kernel", "k", 30, 20), _ev("kernel", "k", 70, 5)],
               0, 120, [(a, b, name) for name, a, b in host])
    return dict(tr.idle_by_host_span())


def test_idle_goes_to_the_innermost_span():
    # dispatch [10, 90] > search [20, 85] > route [25, 40], expand [45, 80]
    # > rerank [60, 78]; fetch [92, 95]; device busy [30, 50] and [70, 75]
    host = [("dispatch", 10, 90), ("fetch", 92, 95)]
    prog = [("search", -1, 20, 85), ("route", 0, 25, 40),
            ("expand", 0, 45, 80), ("rerank", 2, 60, 78)]
    old = _idle(host)
    new = _idle(program_spans.innermost(host, prog))
    assert new == pytest.approx({
        "dispatch": 15e-6, "search": 10e-6, "route": 5e-6, "expand": 12e-6,
        "rerank": 13e-6, "fetch": 3e-6, "other": 37e-6})
    tree = sum(new[n] for n in ("dispatch", "search", "route", "expand",
                                "rerank"))
    assert tree == pytest.approx(old["dispatch"])
    assert new["fetch"] == old["fetch"] and new["other"] == old["other"]


def test_innermost_stretches_are_disjoint():
    host = [("build", 0, 100)]
    prog = [("kmeans", -1, 5, 30), ("kmeans_lloyd", 0, 10, 20),
            ("balanced_assign", -1, 40, 90), ("assign_topk", 2, 40, 60),
            ("loose", -1, 150, 160)]
    out = program_spans.innermost(host, prog)
    assert [o[0] for o in out] == [
        "build", "kmeans", "kmeans_lloyd", "kmeans", "build", "assign_topk",
        "balanced_assign", "build", "loose"]
    assert all(a[2] <= b[1] for a, b in zip(out, out[1:]))
    assert sum(b - a for _, a, b in out if _ != "loose") == 100


def _launch_run(extra_events=()):
    spans = [SimpleNamespace(name="search", parent=-1, root=0, start=100,
                             end=200, work=4),
             SimpleNamespace(name="route", parent=0, root=0, start=110,
                             end=150, work=4),
             SimpleNamespace(name="search", parent=-1, root=2, start=300,
                             end=400, work=4)]
    events = [
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 2, corr=1),
        _ev("kernel", "gemm", 130, 5, corr=1),
        _ev("cuda_driver", "cuLaunchKernel", 160, 2, corr=2),
        _ev("kernel", "topk", 170, 5, corr=2),
        _ev("cuda_runtime", "cudaMemcpyAsync", 310, 2, corr=3),
        _ev("gpu_memcpy", "Memcpy HtoD", 315, 1, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 320, 2, corr=4),
        _ev("kernel", "gemm", 330, 5, corr=4),
        # outside every search span: the reply's copy
        _ev("cuda_runtime", "cudaMemcpyAsync", 450, 2, corr=5),
        _ev("gpu_memcpy", "Memcpy DtoH", 455, 1, corr=5),
        # host calls that launch nothing
        _ev("cuda_runtime", "cudaEventRecord", 460, 1, corr=6),
        _ev("cuda_runtime", "cudaStreamSynchronize", 462, 1, corr=7),
        *extra_events]
    return SimpleNamespace(
        devtraced=SimpleNamespace(program=SimpleNamespace(spans=spans)),
        devtrace=Trace(events, 0, 500, []))


def test_launches_count_the_operations_launched_inside_search(capsys):
    assert program_spans.launches_per_request(_launch_run()) == 2.0
    err = capsys.readouterr().err
    assert "4 device operations launched inside 2 search spans; 0 " in err
    # by the innermost span: the route's kernel, and three under search
    assert "{'route': [0.5, 2.5], 'search': [1.5, 5.5]}" in err
    # a device operation with no launch record, or a launch with no device
    # operation, reads None and says so
    lost_launch = _launch_run([_ev("kernel", "lost", 340, 1, corr=99)])
    assert program_spans.launches_per_request(lost_launch) is None
    lost_op = _launch_run([_ev("cuda_runtime", "cudaLaunchKernel", 330, 2,
                               corr=8)])
    assert program_spans.launches_per_request(lost_op) is None
    err = capsys.readouterr().err
    assert "1 device operations without a launch record" in err
    assert "1 launch calls without a device operation" in err
    # nothing to read: no program spans (a program without record())
    run = _launch_run()
    run.devtraced = SimpleNamespace()
    assert program_spans.launches_per_request(run) is None


def test_tiny_interactive_reads_queries_ms():
    cell = tiny_cell("interactive")
    out = run_cell(cell, 2**31 + 3, 0.3, True, torch.device("cpu"))
    ms = out["metrics"]["queries_ms.interactive"]
    assert ms["unit"] == "ms" and 0 < ms["value"] < 100
    if not torch.cuda.is_available():
        # with a card, this CPU run's device window is two marker fills
        names = {n for n, _ in out["breakdown"]["idle_gaps"]}
        assert {"search", "queries", "route", "stage1", "rerank"} <= names


def test_only_windows_fixed_by_count_record():
    program_spans.install()
    cell = tiny_cell("bulk")
    engine = spec.module("engines", cell["config"]["engine"])
    from hnswbench import data

    rows, pool = data.of_config(cell["config"], 1, torch.device("cpu"))
    index = engine.build(cell["config"], rows)
    client = loop.SearchClient(engine, index, pool, cell["traffic"], 10, 4)
    timed = client.window(seconds=0.05)
    assert not hasattr(timed, "program")
    counted = client.window(requests=2)
    assert [s.name for s in counted.program.spans
            if s.parent < 0] == ["search", "search"]
    program_spans.pause()
    try:
        assert not hasattr(client.window(requests=1), "program")
    finally:
        program_spans.resume()


@pytest.mark.cuda
def test_clock_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    program_spans.install()
    dev = torch.device("cuda")
    cell = tiny_cell("bulk")
    engine = spec.module("engines", cell["config"]["engine"])
    from hnswbench import data

    rows, pool = data.of_config(cell["config"], 1, dev)
    index = engine.build(cell["config"], rows)
    client = loop.SearchClient(engine, index, pool, cell["traffic"], 10, 4)
    client.window(requests=2)
    window, trace = capture_device(
        lambda host: client.window(requests=4, spans=host))
    launch = {ev["args"]["correlation"]: ev for ev in trace.events
              if ev.get("cat") in program_spans.LAUNCH_CATS
              and "correlation" in ev.get("args", {})}
    ops = sorted(trace.device_ops, key=lambda ev: ev["ts"])
    marker = ops[0]  # the window's first marker fill
    lag = marker["ts"] - launch[marker["args"]["correlation"]]["ts"]
    assert 0 <= lag <= 50
    searches = [s for s in window.program.spans if s.name == "search"]
    assert len(searches) == 4
    inside = 0
    for op in ops:
        at = launch[op["args"]["correlation"]]["ts"]
        for s in searches:
            if s.start <= at <= s.end:
                assert op["ts"] >= s.start
                inside += 1
    assert inside >= 4 * 10


def test_tracing_cost_on_cpu():
    from hnswbench import tracing_cost

    out = tracing_cost.measure(tiny_cell("bulk"), 9, 1, torch.device("cpu"))
    assert [(w["sink"], w["device_trace"]) for w in out["windows"]] == [
        (False, False), (True, False), (True, True)]
    # search, queries, route, expand, stage1, rerank
    assert out["spans_per_request"] == 6
    assert out["span_ns_open"] > 0
    assert all(w["search_ms"] > 0 for w in out["windows"] if w["sink"])
    assert out["launches_per_request"] is None  # no device operation
