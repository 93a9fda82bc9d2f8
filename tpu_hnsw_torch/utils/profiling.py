"""Profiling hooks — the EXPLAIN ANALYZE / pg_stat analogue (port of
``tpu_hnsw/utils/profiling.py``), and the port's one span recorder.

:func:`annotate` names a region of the serving and build code. The
regions, each a span inside its caller's (work done is counted in
brackets):

- search: ``search`` (queries) around the whole of
  ``BlockHnswIndex.search_device`` and ``ShardedBlockSearcher.
  search_device``; inside it ``queries`` (queries: validation and the
  upload), ``route`` (queries) with ``route_chain`` (queries: the GEMM +
  top-k chain of ``ops/route.py``, where the route kernel does not take
  the call; ``ROUTE_LAUNCHES["gemm_topk"]`` counts its calls), ``expand``
  (queries) with ``stage1`` ((query, block) pairs: the stage-1 kernel) and
  ``rerank`` (candidates: the f32 gather, re-score and top-k), and
  ``ici_merge`` (the stacked searcher's merge);
- build: ``partition_build`` (rows) around each partition's build in
  ``PartitionedHnswIndex.build``; ``kmeans`` (rows sampled) with
  ``kmeans_sample``,
  ``kmeans_lloyd`` (one segment of Lloyd iterations) and
  ``kmeans_refill`` (the empty-cluster re-seed and its host read);
  ``balanced_assign`` (rows) with ``assign_topk`` and ``assign_rounds``;
  ``install`` (rows);
- the graph engine: ``search`` (queries) around the whole of
  ``HnswIndex.search_device``, and inside it ``queries`` (queries:
  validation and the upload), then ``route_scan`` (queries: the dense
  scan of the level >= 1 elements) or ``descend`` (queries: the greedy
  upper-level descent), and ``beam_level0`` (queries: the level-0 beam:
  one kernel launch, or the lockstep torch loop; ``ops/beam.py``'s
  ``BEAM_LAUNCHES`` counts the beams by path, ``"kernel"``, ``"loop"``,
  ``"plain"``). ``index/search.py`` counts the level-0 beam's work in
  module ints: on the loop, always, ``BEAM_STEPS`` (lockstep steps run)
  and ``BEAM_SYNCS`` (termination tests that read the device; the kernel
  has none); and, only while a :func:`trace` is open (:func:`tracing`),
  with one host read after ``beam_level0`` closes, the beam's least
  work: ``BEAM_ROWS`` ((query, expanded node) adjacency rows),
  ``BEAM_VECTORS`` (distinct vectors the seeds and those rows name) and
  ``BEAM_COUNTED`` (beams so counted), and on the kernel ``BEAM_STEPS``
  (its longest query's steps, read in that host read).

Two things record them:

- :func:`record` opens an in-memory sink: each region becomes a
  :class:`Span` (name, parent, root, start, end, work). The spans of one
  request share their root, which serves as its id. Stamps are taken
  with ``time.perf_counter_ns`` and put, once, when the sink closes, on
  the clock of ``torch.profiler``'s exported trace (epoch microseconds
  less its ``baseTimeNanoseconds``), so a span lines up with the trace's
  kernels and launches without a marker.
- :func:`trace` captures a ``torch.profiler`` trace (host ops and, on a
  card, CUDA kernels) and writes it as a Chrome/Perfetto trace file, in
  which each region is a ``record_function`` range; :func:`range_times`
  sums device time by range. The profiler gives a kernel to the innermost
  range open at its launch, and a range its device extent from the first
  to the last kernel so given: a region whose kernels all lie in its
  children has no extent, so ``expand`` launches the query's quantisation
  and the id gather itself, around ``stage1`` and ``rerank``. Where a
  region would launch nothing of its own before or after a child (a bf16
  copy needs no quantisation; ``route`` around ``route_chain``),
  :func:`mark` launches a one-element fill there, under a trace alone.

With neither open, :func:`annotate` is a shared no-op after one flag
test: it records nothing and launches nothing, so the serving path keeps
its regions at no cost.

Usage::

    from tpu_hnsw_torch.utils import profiling
    with profiling.record() as rec:
        idx.search_device(queries, k=10)
    [(s.name, s.end - s.start, s.work) for s in rec.spans]

    with profiling.trace("/tmp/tpu_hnsw_torch_trace") as prof:
        idx.search(queries, k=10)
    # open /tmp/tpu_hnsw_torch_trace/trace.json in Perfetto or
    # chrome://tracing, read prof.key_averages(), or sum it by range with
    # range_times(".../trace.json", ("route", "expand"))
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

import torch

#: the file name :func:`trace` writes under its ``logdir``
TRACE_FILE = "trace.json"
#: the exported trace's ``baseTimeNanoseconds`` is the epoch floored to
#: intervals of this many seconds (libkineto's ``ChromeTraceBaseTime``)
TRACE_BASE_PERIOD_S = 7889238

_active = 0    # open trace() regions
_sink = None   # the open record() sink
_on = False    # either of the two: annotate's one flag test


class Span(NamedTuple):
    """One region recorded by :func:`record`: ``parent`` and ``root`` are
    indices into :attr:`Recorder.spans` (``parent`` -1 at a root, a root
    its own ``root``); ``start`` and ``end`` in microseconds on the
    exported trace's clock; ``work`` the count the region was given, or
    None."""

    name: str
    parent: int
    root: int
    start: float
    end: float
    work: int | None


class Recorder:
    """The sink of :func:`record`. While it is open, ``raw`` holds the
    finished regions as (entry number, name, parent's entry number or -1,
    start, end, work) on the ``perf_counter_ns`` clock; once it is closed,
    :attr:`spans` holds them in entry order, and :attr:`offset_us` maps a
    ``time.perf_counter()`` second ``t`` to the trace's clock as
    ``t * 1e6 + offset_us``."""

    def __init__(self):
        self.raw: list = []
        self.stack: list = []   # entry numbers of the open regions
        self.entered = 0
        self.spans: list = []
        self.offset_us = 0.0
        self._clock = (time.perf_counter_ns(), time.time_ns())

    def close(self) -> None:
        pc0, tn0 = self._clock
        base = tn0 // 10**9 // TRACE_BASE_PERIOD_S * TRACE_BASE_PERIOD_S
        off_ns = tn0 - pc0 - base * 10**9
        self.offset_us = off_ns / 1e3
        at: dict = {}  # entry number -> index in spans
        spans = self.spans = []
        for i, name, parent, t0, t1, work in sorted(self.raw):
            p = at.get(parent, -1)  # a parent still open at close: a root
            at[i] = len(spans)
            spans.append(Span(name, p, spans[p].root if p >= 0 else at[i],
                              (t0 + off_ns) / 1e3, (t1 + off_ns) / 1e3,
                              work))
        self.raw = []


@contextlib.contextmanager
def record():
    """Record every region the enclosed block enters into a new
    :class:`Recorder`, yielded; its spans are readable once the block
    ends. One sink at a time, on the thread that opened it."""
    global _sink, _on
    if _sink is not None:
        raise RuntimeError("a record() sink is already open")
    rec = Recorder()
    _sink, _on = rec, True
    try:
        yield rec
    finally:
        _sink, _on = None, bool(_active)
        rec.close()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the enclosed block and write it to
    ``logdir/trace.json``. Yields the ``torch.profiler.profile`` object.

    CUDA activity is traced when a card is present; the block is
    synchronised before the capture ends, so trailing asynchronous work
    lands inside it.
    """
    from torch.profiler import ProfilerActivity, profile

    global _active, _on
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        _active += 1
        _on = True
        try:
            yield prof
            if cuda:
                torch.cuda.synchronize()
        finally:
            _active -= 1
            _on = bool(_active) or _sink is not None
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class _Range:
    """One region while a sink or a trace is open: a record in the sink
    and a ``record_function`` range in the trace. ``work`` may be set
    inside the region; it is read when the region ends."""

    __slots__ = ("name", "work", "_sink", "_i", "_parent", "_t0", "_rf")

    def __init__(self, name: str, work):
        self.name, self.work = name, work

    def __enter__(self):
        if _active:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        sink = self._sink = _sink
        if sink is not None:
            st = sink.stack
            self._parent = st[-1] if st else -1
            self._i = i = sink.entered
            sink.entered = i + 1
            st.append(i)
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        sink = self._sink
        if sink is not None:
            t1 = time.perf_counter_ns()
            sink.stack.pop()
            sink.raw.append((self._i, self.name, self._parent, self._t0, t1,
                             self.work))
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class _Off:
    """The shared no-op region: ``work`` may be set and is dropped."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    work = property(lambda self: None, lambda self, value: None)


_OFF = _Off()


def tracing() -> bool:
    """Whether a :func:`trace` is open: work that only a trace's readers
    need (a count that reads the device) runs only then."""
    return bool(_active)


def mark(device) -> None:
    """Inside an open :func:`trace`, a one-element fill on ``device``: a
    kernel of the innermost open region, which fixes an end of that
    region's device extent where only its children would launch. Outside a
    trace it launches nothing."""
    if _active:
        torch.zeros(1, device=device)


def annotate(name: str, work: int | None = None):
    """Name a region (``jax.named_scope``'s counterpart), with the work it
    does (a count known on the host, or None): a :class:`Span` in an open
    :func:`record` sink and a ``record_function`` range inside an active
    :func:`trace`; a shared no-op context outside both."""
    if not _on:
        return _OFF
    return _Range(name, work)


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
