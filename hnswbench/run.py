"""Runs one cell of ``BENCHMARK.json`` and prints its result line.

    python3 -m hnswbench.run --workload sift1m.bulk --seed 7 --seconds 10 \\
        --trace 0

From the root of a checkout that holds ``tpu_hnsw_torch``. The run makes
its rows and query pool on the card from ``--seed``, builds the cell's
index, warms the cell's shapes (all of it set-up), then measures:

- ``--trace 0``: a window of ``--seconds``; the cell's end-to-end metrics;
- ``--trace 1``, early in the process: a short untraced window for the
  host spans, a short window traced on the device alone (``busy_s``,
  ``window_s``, the idle share and the ``breakdown``), then a short
  window under the program's own trace of host and device (device time
  under the program's ranges, the kernels); the cell's per-layer
  metrics.

After the window it reads the device's memory peak, frees the program's
state, computes the plain reference (:mod:`hnswbench.reference`) and
judges what the window returned (:mod:`hnswbench.check`). The last lines
of standard error give each number compared beside its limit; the last
line of standard output is one JSON object. Without a card, or with JAX
or ``tpu_hnsw`` loaded, it prints no result and exits with another code
than 0.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

_IMPORTED = time.time()

import torch  # noqa: E402  (after _IMPORTED: its import is set-up too)


def process_start() -> float:
    """The process's start on the epoch clock, from ``/proc`` (10 ms
    resolution); the harness's import time where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return _IMPORTED


class Run:
    """What a run measured, for the metric readers: the cell's ``config``,
    ``setup_s``, the measured ``window`` (``--trace 0``); with ``--trace
    1`` the untraced ``spans`` window, the device-traced window
    ``devtraced`` and its ``devtrace``, and the program-traced window
    ``traced`` and its ``trace``; the correctness ``numbers``, and
    ``extra``, a dict that readers' ``before``/``after`` hooks may
    fill."""

    def __init__(self, config: dict):
        self.config = config
        self.setup_s = None
        self.window = self.spans = None
        self.devtraced = self.devtrace = self.traced = self.trace = None
        self.numbers: dict = {}
        self.extra: dict = {}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             engine=None, started: float | None = None) -> dict:
    """Runs a cell on ``device`` and returns its result line as a dict.
    ``engine`` replaces the configuration's system under test (the
    control, or a test's broken copy)."""
    from hnswbench import check, data, loop, reference, spec
    from hnswbench.trace import capture, capture_device

    started = process_start() if started is None else started
    config, traffic = cell["config"], cell["traffic"]
    engine = engine or spec.module("engines", config["engine"])
    k, probes, metric = config["k"], config["probes"], config["metric"]
    readers = {m["name"]: spec.module("metrics", m["name"])
               for m in (cell["per_layer"] if trace else cell["end_to_end"])}
    run = Run(config)
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # the context exists before the reset
        torch.cuda.reset_peak_memory_stats(device)
    rows, pool = data.of_config(config, seed, device)
    values = {}

    def traced(fn):
        for r in readers.values():
            getattr(r, "before", lambda _run: None)(run)
        try:
            return capture(fn)
        finally:
            for r in readers.values():
                getattr(r, "after", lambda _run: None)(run)

    if traffic["mode"] == "search":
        index = engine.build(config, rows)
        del rows
        client = loop.SearchClient(engine, index, pool, traffic, k, probes)
        client.window(requests=traffic["warmup_requests"])
        _sync(device)
        keep = loop.Reservoir(traffic["check_rows"] // client.rows, seed)
        run.setup_s = time.time() - started
        if trace:  # host spans first: a profiler leaves launches slower
            run.spans = client.window(requests=traffic["span_requests"],
                                      reservoir=keep)
            run.devtraced, run.devtrace = capture_device(
                lambda host: client.window(
                    requests=traffic["trace_requests"], spans=host,
                    reservoir=keep))
            run.traced, run.trace = traced(lambda: client.window(
                requests=traffic["trace_requests"], reservoir=keep))
        else:
            run.window = client.window(seconds=seconds, reservoir=keep)
        peak = _peak(device)
        sample = keep.sample(pool.shape[0])
        del client, index
    elif traffic["mode"] == "build":
        loop.build_window(engine, config, rows,
                          builds=traffic["warmup_builds"])
        _sync(device)
        run.setup_s = time.time() - started
        if trace:
            run.spans = loop.build_window(engine, config, rows,
                                          builds=traffic["span_builds"])[1]
            (_, run.devtraced), run.devtrace = capture_device(
                lambda host: loop.build_window(
                    engine, config, rows, builds=traffic["trace_builds"],
                    spans=host))
            (index, run.traced), run.trace = traced(
                lambda: loop.build_window(engine, config, rows,
                                          builds=traffic["trace_builds"]))
        else:
            index, run.window = loop.build_window(engine, config, rows,
                                                  seconds=seconds)
        peak = _peak(device)
        try:
            values["rows_lost"] = check.rows_lost(*engine.stored(index),
                                                  rows)
            sample = loop.serve_all(engine, index, pool, k, probes,
                                    traffic["serve_rows"])
        except (AttributeError, TypeError, ValueError, RuntimeError) as e:
            # an index that cannot be read or served holds no row
            print(f"hnswbench: the built index fails: {e!r}", file=sys.stderr)
            values["rows_lost"], sample = config["rows"], None
        del index, rows
    else:
        raise ValueError(f"unknown traffic mode {traffic['mode']!r}")
    _free(device)

    # the plain reference, on rows drawn again from the seed
    rows, pool = data.of_config(config, seed, device)
    _, truth = reference.exact_topk(rows, pool, k, metric)
    got = check.results(rows, pool, truth, sample, metric, k)
    del rows, pool, truth
    _free(device)
    run.numbers = got
    values = {"bad_rows": got["bad_rows"], "dist_gap": got["dist_gap"],
              "missed_at_10": got["missed_at_10"], **values}
    correct, compared = check.judge(values, config["limits"])

    windows = [w for w in (run.window, run.spans, run.devtraced,
                           run.traced) if w]
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else device.type),
           "count": cell["chips"], "memory_peak_bytes": peak}
    # a request or build that raises ends the run, so none that was sent
    # failed
    out = {"correct": correct,
           "attempted": sum(len(w.records) for w in windows), "failed": 0,
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.devtrace.busy_s()
        dev["window_s"] = run.devtrace.window_s
        out["breakdown"] = {"device_ops": run.devtrace.top_device_ops(),
                            "idle_gaps": run.devtrace.idle_by_host_span()}
    out["compared"] = compared
    return out


def _peak(device) -> int:
    _sync(device)
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _finite(x):
    """``x`` with every infinite or NaN float replaced by the largest
    float, so that the line is strict JSON."""
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return sys.float_info.max
    return x


def main(argv=None) -> int:
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hnswbench import isolation, spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("hnswbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"hnswbench: the cell needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), started=started)
    found = isolation.forbidden_modules()
    if found:
        print(f"hnswbench: the run loaded {found}", file=sys.stderr)
        return 4
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(_finite(out)), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
