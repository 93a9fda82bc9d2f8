"""Traced windows and what the benchmark reads from them.

Two captures, each of one window:

- :func:`capture` runs a window inside the program's own trace (host and
  CUDA activity, the program's ranges on) and a host range named
  :data:`WINDOW`: the device time under the program's ranges (a copy of
  ``tpu_hnsw_torch/utils/profiling.py``'s ``range_times`` arithmetic) and
  kernels by name. Recording every host operation costs the host about
  as much as a small request's own dispatch, so this window is not the
  one to read the device's idle share from.
- :func:`capture_device` traces device activity alone, with a marker
  operation on the device at each end, and records the benchmark's own
  host spans (:func:`span`) on the host's clock: the window's extent, the
  union of device-operation intervals inside it, and the idle gaps named
  by those spans.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
import time

import torch

#: the host range around a window of :func:`capture`
WINDOW = "hnswbench.window"
#: trace categories of device operations
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_NULL = contextlib.nullcontext()


class _Timed:
    """A host span recorded on the host's clock into a list."""

    __slots__ = ("out", "name", "t0")

    def __init__(self, out: list, name: str):
        self.out, self.name = out, name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.out.append((self.name, self.t0, time.perf_counter()))


def span(name: str, out: list | None):
    """The benchmark's host span ``name`` (dispatch, fetch, wait, build):
    a ``(name, start, end)`` record on the host's clock appended to
    ``out`` (inside :func:`capture_device`), or a shared no-op where
    ``out`` is None."""
    return _NULL if out is None else _Timed(out, name)


def _complete_events(prof) -> list:
    tmp = tempfile.mkdtemp(prefix="hnswbench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [ev for ev in json.load(f)["traceEvents"]
                    if ev.get("ph") == "X"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def capture(fn):
    """Runs ``fn()`` inside the program's own trace
    (``tpu_hnsw_torch.utils.profiling.trace``: ``torch.profiler`` over host
    and CUDA activity, with the program's ranges switched on) and inside the
    :data:`WINDOW` range, synchronising the device before the range closes.
    Returns (``fn``'s result, :class:`Trace`)."""
    from tpu_hnsw_torch.utils import profiling

    tmp = tempfile.mkdtemp(prefix="hnswbench-trace-")
    try:
        with profiling.trace(tmp):
            with torch.profiler.record_function(WINDOW):
                out = fn()
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        with open(os.path.join(tmp, profiling.TRACE_FILE)) as f:
            events = [ev for ev in json.load(f)["traceEvents"]
                      if ev.get("ph") == "X"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    win = [ev for ev in events if ev.get("name") == WINDOW
           and ev.get("cat") == "user_annotation"]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} range")
    return out, Trace(events, win[0]["ts"], win[0]["ts"] + win[0]["dur"],
                      [])


def capture_device(fn):
    """Runs ``fn(spans)`` under ``torch.profiler`` with device activity
    only (host activity where there is no card, which then records no
    device operation), ``spans`` a list that :func:`span` fills on the
    host's clock. The device is idle when the window opens; a one-element
    fill is launched at its start and again once the window's work is done
    and synchronised, so the window on the device's timeline runs from
    the first marker's start to the second's end, and a host time maps to
    the timeline by the first marker's offset. Returns (``fn``'s result,
    :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    marker = torch.zeros(1, device="cuda") if cuda else None
    if cuda:
        torch.cuda.synchronize()
    host: list = []
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        if cuda:
            marker.zero_()
        out = fn(host)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if cuda:
            marker.zero_()
            torch.cuda.synchronize()
    events = _complete_events(prof)
    dev = [ev for ev in events if ev.get("cat") in DEVICE_CATS]
    if dev:
        start = min(ev["ts"] for ev in dev)
        end = max(ev["ts"] + ev["dur"] for ev in dev)
    else:
        start, end = 0.0, (t1 - t0) * 1e6
    at = start - t0 * 1e6  # host seconds -> the timeline's microseconds
    spans = [(a * 1e6 + at, b * 1e6 + at, name) for name, a, b in host]
    return out, Trace(events, start, end, spans)


def union_length(intervals) -> float:
    """Length covered by the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The ``(start, end)`` stretches of ``[lo, hi]`` that no interval
    covers."""
    out, at = [], lo
    for a, b in sorted(intervals):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Trace:
    """Complete (``"ph": "X"``) events of one captured window, its extent
    ``[start, end]`` and the benchmark's host spans ``(start, end, name)``
    in it; times in microseconds as the trace has them."""

    def __init__(self, events: list, start: float, end: float,
                 host_spans: list):
        self.events = events
        self.start, self.end = start, end
        self.host_spans = sorted(host_spans)
        self.device_ops = [ev for ev in events
                           if ev.get("cat") in DEVICE_CATS]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def device_intervals(self) -> list:
        """Device operations' intervals clipped to the window."""
        out = []
        for ev in self.device_ops:
            a = max(ev["ts"], self.start)
            b = min(ev["ts"] + ev["dur"], self.end)
            if b > a:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        return union_length(self.device_intervals()) / 1e6

    def range_times(self, names) -> dict:
        """``range_times``' arithmetic: for each named program range, the
        device busy ms inside its extents on the device timeline
        (``device_ms``), those extents (``span_ms``), its host ms and its
        count of calls. Kernels are matched by time, so kernels launched
        outside torch count too; one stream is assumed."""
        out = {n: {"device_ms": 0.0, "span_ms": 0.0, "host_ms": 0.0,
                   "count": 0} for n in names}
        spans = []
        for ev in self.events:
            rec = out.get(ev.get("name"))
            if rec is None:
                continue
            if ev.get("cat") == "user_annotation":
                rec["host_ms"] += ev["dur"] / 1e3
                rec["count"] += 1
            elif ev.get("cat") == "gpu_user_annotation":
                rec["span_ms"] += ev["dur"] / 1e3
                spans.append((rec, ev["ts"], ev["ts"] + ev["dur"]))
        busy = sorted((ev["ts"], ev["ts"] + ev["dur"])
                      for ev in self.device_ops)
        starts = [s for s, _ in busy]
        reach, top = [], float("-inf")  # the latest end so far
        for _, e in busy:
            top = max(top, e)
            reach.append(top)
        for rec, a, b in spans:
            lo = bisect.bisect_right(reach, a)
            hi = bisect.bisect_left(starts, b)
            rec["device_ms"] += sum(min(e, b) - max(s, a)
                                    for s, e in busy[lo:hi]
                                    if s < b and e > a) / 1e3
        return out

    def kernels(self, substrings) -> list:
        """Kernel events whose name holds one of ``substrings``."""
        return [ev for ev in self.device_ops if ev.get("cat") == "kernel"
                and any(s in ev.get("name", "") for s in substrings)]

    def top_device_ops(self, n: int = 10, width: int = 120) -> list:
        """``[[name, seconds], ...]``: the ``n`` device operations (by
        name) that took the most time in the window."""
        by: dict = {}
        for ev in self.device_ops:
            key = ev.get("name", "?")[:width]
            by[key] = by.get(key, 0.0) + ev["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_host_span(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the window's device idle time by
        what the host was doing, each stretch of a gap given to the
        benchmark's host span that covers it, or to ``other``; the ``n``
        names with the most idle time."""
        host = self.host_spans
        ends = [h[1] for h in host]
        by: dict = {}
        for a, b in gaps(self.device_intervals(), self.start, self.end):
            covered = 0.0
            for s, e, name in host[bisect.bisect_right(ends, a):]:
                if s >= b:
                    break
                part = min(e, b) - max(s, a)
                if part > 0:
                    by[name] = by.get(name, 0.0) + part / 1e6
                    covered += part
            by["other"] = by.get("other", 0.0) + (b - a - covered) / 1e6
        return [[k, v] for k, v in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:n]
                if v > 0]
