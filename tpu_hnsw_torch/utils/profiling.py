"""Profiling hooks — the EXPLAIN ANALYZE / pg_stat analogue (port of
``tpu_hnsw/utils/profiling.py``).

:func:`trace` captures a ``torch.profiler`` trace (host ops and, on a
card, CUDA kernels) and writes it as a Chrome/Perfetto trace file;
:func:`annotate` names a region of the serving code ("route", "expand",
"descend", "beam_level0", "route_scan", "ici_merge") so the timeline and
``key_averages()`` carry index semantics instead of raw kernel names.

Outside an active :func:`trace` an annotation is a no-op: it records
nothing, launches nothing and costs one flag test, so the serving path
keeps its ranges at no cost.

Usage::

    from tpu_hnsw_torch.utils.profiling import trace
    with trace("/tmp/tpu_hnsw_torch_trace") as prof:
        idx.search(queries, k=10)
    # open /tmp/tpu_hnsw_torch_trace/trace.json in Perfetto or
    # chrome://tracing, read prof.key_averages(), or sum it by range with
    # range_times(".../trace.json", ("route", "expand"))
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

#: the file name :func:`trace` writes under its ``logdir``
TRACE_FILE = "trace.json"

_active = 0  # open trace() regions; annotate records only inside one
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed block and write it to
    ``logdir/trace.json``. Yields the ``torch.profiler.profile`` object.

    CUDA activity is traced when a card is present; the block is
    synchronised before the capture ends, so trailing asynchronous work
    lands inside it.
    """
    from torch.profiler import ProfilerActivity, profile

    global _active
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        _active += 1
        try:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        finally:
            _active -= 1
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def _range(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def annotate(name: str):
    """Name a region (``jax.named_scope``'s counterpart): a
    ``record_function`` range plus an NVTX range on a card, inside an
    active :func:`trace`; a shared no-op context outside one."""
    if not _active:
        return _NULL
    return _range(name)


def range_times(trace_file: str, names) -> dict:
    """Milliseconds under each named range of a trace written by
    :func:`trace`, summed over its calls: ``{name: {"device_ms",
    "span_ms", "host_ms", "count"}}``. ``device_ms`` is the device busy
    time (kernels, copies, memsets) inside the range's extent on the
    device timeline, ``span_ms`` that extent (0 without a card),
    ``host_ms`` the range's host time and ``count`` its calls. Kernels are
    matched by time, so kernels launched outside torch (the ``ctypes``
    libraries of ``csrc/``) count too; one stream is assumed."""
    with open(trace_file) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X"]
    out = {n: {"device_ms": 0.0, "span_ms": 0.0, "host_ms": 0.0, "count": 0}
           for n in names}
    spans = []
    for ev in events:
        rec = out.get(ev.get("name"))
        if rec is None:
            continue
        if ev.get("cat") == "user_annotation":
            rec["host_ms"] += ev["dur"] / 1e3
            rec["count"] += 1
        elif ev.get("cat") == "gpu_user_annotation":
            rec["span_ms"] += ev["dur"] / 1e3
            spans.append((rec, ev["ts"], ev["ts"] + ev["dur"]))
    busy = [(ev["ts"], ev["ts"] + ev["dur"]) for ev in events
            if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    for rec, a, b in spans:
        rec["device_ms"] += sum(min(e, b) - max(s, a) for s, e in busy
                                if s < b and e > a) / 1e3
    return out
