"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` takes its configuration from the file the
configuration's entry names (``configs/<config>.json``), its traffic mix
from ``traffic/<traffic>.json``, its system under test from
``engines/<engine>.py`` (the configuration's ``engine``), and each metric
from a reader ``metrics/<metric name>.py``. Adding a cell, a mix or a
metric adds files; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """The Python file ``<kind>/<name>.py`` under the harness, imported
    once (names may hold dots)."""
    key = f"hnswbench._{kind}_" + name.replace(".", "__")
    mod = sys.modules.get(key)
    if mod is None:
        path = os.path.join(HERE, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(key, path)
        if spec is None or not os.path.exists(path):
            raise FileNotFoundError(f"no {kind} file {path}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether a metric is reported in ``cell``: its ``workloads`` list
    names the cell, or, without one, every cell does (an end-to-end
    metric) or every cell that reports what it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(bench: dict, name: str) -> dict:
    """Everything a run of the cell ``name`` needs: its ``workload`` entry,
    ``config`` and ``traffic`` dicts, ``chips``, and the ``end_to_end``
    and ``per_layer`` metric entries it reports."""
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    centry = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    return {
        "name": name,
        "workload": work,
        "chips": work["chips"],
        "config": load_json(os.path.join(ROOT, centry["file"])),
        "traffic": load_json(os.path.join(HERE, "traffic",
                                          f"{work['traffic']}.json")),
        "end_to_end": e2e,
        "per_layer": [m for m in bench["per_layer"]
                      if _applies(m, name, reported)],
    }
