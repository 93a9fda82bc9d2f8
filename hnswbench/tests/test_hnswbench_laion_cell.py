"""The bf16 partitioned cell (``engines/partitioned_bf16.py``,
``laion12m5.bulk``'s readers) through the harness on the CPU at a tiny
size: the result line is ``correct`` with and without a trace, and one
precision below the stated storage (:mod:`hnswbench.faults_bf16`: the
reference in fp8 e4m3, and the program's rerank on fp8-rounded rows)
fails ``dist_gap``, whose limit lies between the program's reading and
theirs.

    python -m pytest hnswbench/tests -q
"""

import math

import pytest
import torch

from hnswbench import faults_bf16, spec
from hnswbench.run import run_cell

torch.set_num_threads(1)

SHRINK = {"request_rows": 64, "warmup_requests": 2, "trace_requests": 4,
          "span_requests": 4, "check_rows": 512}


def laion_cell() -> dict:
    """The cell cut to 4,096 rows of 512 in four partitions of 36 blocks
    of 32, probed 8 deep; every other setting, the limits too, as the
    configuration file states them but ``missed_at_10``, whose limit is
    set at the cell's size."""
    cell = spec.cell(spec.load_benchmark(), "laion12m5.bulk")
    cfg = cell["config"]
    cell["config"] = {**cfg, "rows": 4096, "queries": 200, "block_size": 32,
                      "probes": 8,
                      "limits": {**cfg["limits"], "missed_at_10": 0.3}}
    cell["traffic"] = {k: min(v, SHRINK[k]) if k in SHRINK else v
                       for k, v in cell["traffic"].items()}
    return cell


@pytest.mark.parametrize("trace", [0, 1])
def test_laion_cell_is_correct(trace):
    cell = laion_cell()
    out = run_cell(cell, 2**31 + 21, 0.3, bool(trace), torch.device("cpu"))
    assert out["correct"] is True, out["compared"]
    declared = {m["name"]: m["unit"]
                for m in cell["per_layer" if trace else "end_to_end"]}
    assert set(out["metrics"]) <= set(declared)
    for name, m in out["metrics"].items():
        assert m["unit"] == declared[name] and math.isfinite(m["value"])
    if trace:
        assert "dispatch_ms.laion" in out["metrics"]
    else:
        assert {"qps", "recall_at_10", "setup_s"} == set(out["metrics"])


@pytest.mark.parametrize("rerank", [False, True])
def test_fp8_is_not_correct(rerank):
    cell = laion_cell()
    cfg = cell["config"]
    sound = run_cell(cell, 21, 0.3, False, torch.device("cpu"))
    side = (faults_bf16.Fp8Rerank(cfg) if rerank
            else faults_bf16.Fp8Reference())
    fp8 = run_cell(cell, 21, 0.3, False, torch.device("cpu"), engine=side)
    gap = [o["compared"]["dist_gap"]["value"] for o in (sound, fp8)]
    limit = cfg["limits"]["dist_gap"]
    assert sound["correct"] is True and fp8["correct"] is False
    assert gap[0] < limit < gap[1], gap
    assert fp8["compared"]["bad_rows"]["value"] == 0
