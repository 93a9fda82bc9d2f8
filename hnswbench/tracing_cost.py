"""What tracing costs the host a request, on one search cell's index.

    python3 -m hnswbench.tracing_cost --workload sift1m.bulk --seed 7 \\
        --pairs 3

Builds and warms the cell's index as ``hnswbench.run`` does, then runs
windows of the mix's ``span_requests`` requests: ``--pairs`` without and
with the program's ``record()`` sink, in turns (off, on, on, off, ...),
then one window traced on the device alone with the sink open. Prints one
JSON line: for each window the median host ms of the call into the search
entry (``dispatch``, the benchmark's own span) and of the program's
``search`` span; the sink's cost (median ``dispatch`` with it less
without it); the device-only trace's cost (median ``search`` in that
window less in the untraced windows with the sink); and the launches a
request there (:func:`hnswbench.program_spans.launches_per_request`,
whose counts go to standard error). Last, the host ns of one empty region
with no sink and with one open, times the spans a request records: the
sink's cost a request, which the windows' own spread may hide.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from types import SimpleNamespace

import torch


def _dispatch_ms(window) -> float:
    return statistics.median((r[2] - r[1]) * 1e3 for r in window.records)


def measure(cell: dict, seed: int, pairs: int, device) -> dict:
    """The windows and costs of the module's docstring, on ``device``."""
    from hnswbench import data, loop, program_spans, spec

    config, traffic = cell["config"], cell["traffic"]
    if traffic["mode"] != "search":
        raise ValueError(f"{cell['name']} is not a search mix")
    engine = spec.module("engines", config["engine"])
    rows, pool = data.of_config(config, seed, device)
    index = engine.build(config, rows)
    del rows
    client = loop.SearchClient(engine, index, pool, traffic, config["k"],
                               config["probes"])
    program_spans.pause()  # this module opens its own sinks
    try:
        return _windows(cell, seed, pairs, device, client)
    finally:
        program_spans.resume()


def _windows(cell, seed, pairs, device, client) -> dict:
    from tpu_hnsw_torch.utils import profiling

    from hnswbench import program_spans
    from hnswbench.trace import capture_device

    traffic = cell["traffic"]
    client.window(requests=traffic["warmup_requests"])
    n = traffic["span_requests"]
    windows = []

    def untraced(sink: bool):
        if not sink:
            w = client.window(requests=n)
            windows.append({"sink": False, "device_trace": False,
                            "dispatch_ms": _dispatch_ms(w),
                            "search_ms": None})
            return
        with profiling.record() as rec:
            w = client.window(requests=n)
        w.program = rec
        windows.append({"sink": True, "device_trace": False,
                        "dispatch_ms": _dispatch_ms(w),
                        "search_ms": program_spans.span_ms(w, "search")})

    for i in range(pairs):
        for sink in ((False, True) if i % 2 == 0 else (True, False)):
            untraced(sink)
    with profiling.record() as rec:
        w, tr = capture_device(lambda host: client.window(requests=n,
                                                          spans=host))
    w.program = rec
    windows.append({"sink": True, "device_trace": True,
                    "dispatch_ms": _dispatch_ms(w),
                    "search_ms": program_spans.span_ms(w, "search")})
    launches = program_spans.launches_per_request(
        SimpleNamespace(devtraced=w, devtrace=tr))
    per_request = len(rec.spans) / n
    off_ns, on_ns = zip(*(_span_ns(profiling) for _ in range(3)))

    def med(key, **where):
        return statistics.median(x[key] for x in windows
                                 if all(x[k] == v for k, v in where.items()))

    return {
        "workload": cell["name"], "seed": seed, "requests": n,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else device.type),
        "windows": windows,
        "sink_cost_ms": (med("dispatch_ms", sink=True, device_trace=False)
                         - med("dispatch_ms", sink=False)),
        "device_trace_cost_ms": (windows[-1]["search_ms"]
                                 - med("search_ms", sink=True,
                                       device_trace=False)),
        "launches_per_request": launches,
        "spans_per_request": per_request,
        "span_ns_closed": statistics.median(off_ns),
        "span_ns_open": statistics.median(on_ns),
        "sink_cost_by_span_ms": per_request * (statistics.median(on_ns)
                                               - statistics.median(off_ns))
        / 1e6,
    }


def _span_ns(profiling, calls: int = 100_000) -> tuple:
    """Host ns of one empty region, with no sink and with one open."""
    def one():
        t0 = time.perf_counter_ns()
        for _ in range(calls):
            with profiling.annotate("x", 1):
                pass
        return (time.perf_counter_ns() - t0) / calls

    closed = one()
    with profiling.record():
        opened = one()
    return closed, opened


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)

    from hnswbench import spec

    if not torch.cuda.is_available():
        print("hnswbench: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(spec.load_benchmark(), args.workload)
    out = measure(cell, args.seed, args.pairs, torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
