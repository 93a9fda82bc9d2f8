"""Arithmetic the metric readers (``metrics/<name>.py``) share. Each
takes the :class:`hnswbench.run.Run` and returns a number, or None where
the run holds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import numpy as np


def qps(run):
    """Queries whose replies reached host memory in the window, over the
    window's seconds."""
    w = run.window
    return len(w.done_in_window()) * w.rows / w.seconds


def latency_ms(run, q: float):
    """The ``q``-th percentile of the window's request latencies, from
    when a request was due (its query rows handed over) to its reply in
    host memory."""
    done = run.window.done_in_window()
    if not done:
        return None
    return float(np.percentile([(r[3] - r[0]) * 1e3 for r in done], q))


def build_vps(run):
    """Rows indexed by builds completed in the window, over the time to
    the last completion."""
    w = run.window
    done = w.done_in_window()
    if not done:
        return None
    return len(done) * run.config["rows"] / (done[-1][1] - w.begin)


def dispatch_ms(run):
    """Median host ms from the call into the search entry to its return
    (no synchronisation), over the untraced span window."""
    recs = run.spans.records
    return float(np.median([(r[2] - r[1]) * 1e3 for r in recs])) \
        if recs else None


def range_ms_per_1k(run, name: str):
    """Device ms under the program's range ``name`` in the traced window,
    per 1,000 queries; None where the trace holds no device extent of it."""
    rec = run.trace.range_times([name])[name]
    if rec["span_ms"] <= 0:
        return None
    queries = len(run.traced.records) * run.traced.rows
    return rec["device_ms"] / (queries / 1e3)


def idle_pct(run):
    """Share of the window traced on the device alone in which no device
    operation ran."""
    t = run.devtrace
    if not t.device_ops:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def build_stat(run, key: str):
    """Median of a ``build_stats`` entry over the untraced builds."""
    vals = [r[2][key] for r in run.spans.records if key in r[2]]
    return float(np.median(vals)) if vals else None
