"""The harness end to end on the CPU at a tiny size, and ``BENCHMARK.json``
against the benchmark's contract.

A tiny configuration (``tiny.json``) goes through every traffic mix, with
and without a trace, and the result line's keys are checked; the control
(:mod:`hnswbench.control`) and faults planted under the timed path must
make ``correct`` false. ``test_cells_on_card`` runs the same on a card and
skips without one.

    python -m pytest hnswbench/tests -q
"""

import json
import math
import os
import re

import pytest
import torch

from hnswbench import control, spec
from hnswbench.faults import Faulty
from hnswbench.run import _finite, run_cell

torch.set_num_threads(1)

TINY = os.path.join(spec.HERE, "tests", "tiny.json")
MIXES = ("bulk", "interactive", "ingest")
#: the mixes' sizes cut to the tiny pool
SHRINK = {"request_rows": 64, "warmup_requests": 2, "trace_requests": 4,
          "span_requests": 4, "check_rows": 512, "span_builds": 2}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def tiny_cell(mix: str, **config) -> dict:
    cell = spec.cell(spec.load_benchmark(), f"sift1m.{mix}")
    cell["config"] = {**spec.load_json(TINY), **config}
    cell["traffic"] = {k: min(v, SHRINK[k]) if k in SHRINK else v
                       for k, v in cell["traffic"].items()}
    return cell


def _one_line(out: dict) -> dict:
    line = json.dumps(_finite(out))
    assert "\n" not in line
    return json.loads(line)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("mix", MIXES)
def test_tiny_cell_result_line(mix, trace):
    cell = tiny_cell(mix)
    # long enough for a tiny build to finish inside it on a busy host
    seconds = 3.0 if mix == "ingest" else 0.3
    out = _one_line(run_cell(cell, 2**31 + 99, seconds, bool(trace),
                             torch.device("cpu")))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True, out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert DEVICE_KEYS <= set(out["device"])
    declared = {m["name"]: m["unit"]
                for m in cell["per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= set(declared)
    for name, m in out["metrics"].items():
        assert m["unit"] == declared[name] and math.isfinite(m["value"])
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        # host-clock readers read on the CPU too; device ones find nothing
        host = {m["name"] for m in cell["per_layer"]
                if m["source"] != "device_trace"}
        assert host <= set(out["metrics"])
    else:
        assert set(out["metrics"]) == set(declared)
    for c in out["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("mix", ["bulk", "ingest"])
def test_control_is_not_correct(mix):
    out = run_cell(tiny_cell(mix), 7, 0.3, False, torch.device("cpu"),
                   engine=control)
    assert out["correct"] is False
    assert out["compared"]["dist_gap"]["value"] > 30 * \
        out["compared"]["dist_gap"]["limit"]


@pytest.mark.parametrize("mix,fault", [
    ("bulk", "stale"), ("bulk", "half_batch"), ("bulk", "altered_answer"),
    ("bulk", "route_one_probe"), ("bulk", "stage1_quarter"),
    ("interactive", "stale"), ("interactive", "half_batch"),
    ("interactive", "altered_answer"), ("interactive", "route_one_probe"),
    ("interactive", "stage1_quarter"),
    ("ingest", "unchanged"), ("ingest", "half_rows"),
    ("ingest", "altered_row"), ("ingest", "altered_answer"),
    ("ingest", "route_one_probe"), ("ingest", "stage1_quarter")])
def test_a_broken_timed_path_is_not_correct(mix, fault):
    cell = tiny_cell(mix)
    out = run_cell(cell, 11, 0.3, False, torch.device("cpu"),
                   engine=Faulty(fault, cell["config"]))
    assert out["correct"] is False
    if fault in ("route_one_probe", "stage1_quarter"):
        # distinct ids at exact distances: only the ids' check sees it
        c = out["compared"]
        assert c["bad_rows"]["value"] == 0
        assert c["dist_gap"]["value"] <= c["dist_gap"]["limit"]
        assert c["missed_at_10"]["value"] > c["missed_at_10"]["limit"]


def test_benchmark_json_keeps_the_contract():
    path = os.path.join(spec.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits the check's time
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in b["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, p))
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        spec.module("engines", cfg["engine"])
        assert {"bad_rows", "dist_gap", "missed_at_10"} <= set(cfg["limits"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    chips4 = 0
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
        chips4 += w["chips"] == 4
        cell = spec.cell(b, w["name"])
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported
    assert chips4 <= max(1, len(b["workloads"]) // 4)
    for m in b["end_to_end"] + b["per_layer"]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if m in b["end_to_end"] else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert hasattr(spec.module("metrics", m["name"]), "read")
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25
            assert m["source"] in ("host_clock", "device_trace")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}


@pytest.mark.cuda
@pytest.mark.parametrize("mix", MIXES)
def test_cells_on_card(mix):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    for trace in (False, True):
        out = run_cell(tiny_cell(mix), 5, 0.5, trace, dev)
        assert out["correct"] is True, out["compared"]
    out = run_cell(tiny_cell(mix), 5, 0.5, False, dev, engine=control)
    assert out["correct"] is False
