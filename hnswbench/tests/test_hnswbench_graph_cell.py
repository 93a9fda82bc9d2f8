"""The graph engine's cell (``engines/graph.py``, ``sift1m-graph.bulk``'s
readers) through the harness on the CPU at the tiny size: the result line
is ``correct`` with and without a trace, the host-clock and program
readers read numbers, and the beam at ef = k (``route_one_probe``) misses
more of the exact top-10 than the beam at the configuration's ef.

    python -m pytest hnswbench/tests -q
"""

import math
import os

import pytest
import torch

from hnswbench import spec
from hnswbench.faults import Faulty
from hnswbench.run import run_cell

torch.set_num_threads(1)

TINY = os.path.join(spec.HERE, "tests", "tiny.json")
SHRINK = {"request_rows": 64, "warmup_requests": 2, "trace_requests": 4,
          "span_requests": 4, "check_rows": 512}


def graph_cell() -> dict:
    """The cell at the tiny size, on a sparse graph (m 4), where a beam at
    ef = k loses answers that ef 40 finds."""
    cell = spec.cell(spec.load_benchmark(), "sift1m-graph.bulk")
    cell["config"] = {**spec.load_json(TINY), "engine": "graph",
                      "probes": 40, "m": 4, "ef_construction": 16}
    cell["traffic"] = {k: min(v, SHRINK[k]) if k in SHRINK else v
                       for k, v in cell["traffic"].items()}
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_graph_cell_is_correct(trace):
    cell = graph_cell()
    out = run_cell(cell, 2**31 + 77, 0.3, bool(trace), torch.device("cpu"))
    assert out["correct"] is True, out["compared"]
    declared = {m["name"]: m["unit"]
                for m in cell["per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= set(declared)
    for name, m in out["metrics"].items():
        assert m["unit"] == declared[name] and math.isfinite(m["value"])
    if trace:
        # read off the host clock and the program's counter on the CPU too
        assert {"dispatch_ms.graph", "beam_steps"} <= set(out["metrics"])
        assert out["metrics"]["beam_steps"]["value"] >= 10
    else:
        assert {"qps", "recall_at_10", "setup_s"} == set(out["metrics"])


def test_a_beam_at_ef_k_misses_more():
    cell = graph_cell()
    sound = run_cell(cell, 13, 0.3, False, torch.device("cpu"))
    one = run_cell(cell, 13, 0.3, False, torch.device("cpu"),
                   engine=Faulty("route_one_probe", cell["config"]))
    miss = [o["compared"]["missed_at_10"]["value"] for o in (sound, one)]
    assert sound["correct"] is True
    assert miss[1] > miss[0], miss
    c = one["compared"]
    assert c["bad_rows"]["value"] == 0
    assert c["dist_gap"]["value"] <= c["dist_gap"]["limit"]
