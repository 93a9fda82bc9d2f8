"""The program's own spans (``tpu_hnsw_torch.utils.profiling.record``) in
the windows of a ``--trace 1`` run, and what the readers take from them.

:func:`install` wraps the load generator's two windows
(``loop.SearchClient.window`` and ``loop.build_window``) so that each
window fixed by its count of requests or builds runs inside a ``record()``
sink: the untraced span window, the window traced on the device alone, and
the warm-up. A window fixed in seconds (the measured window of ``--trace
0``) records nothing, and nor does the window under the program's own
trace, which the readers' ``before``/``after`` hooks bracket with
:func:`pause` and :func:`resume`. The sink's ``Recorder`` is kept on the
window's :class:`hnswbench.loop.Window` as ``program``.

In the device-only window the benchmark's own host spans (dispatch, fetch,
wait, build) become the parents of the program's spans, and the window's
list of host spans is replaced by the innermost span of each stretch
(:func:`innermost`): ``hnswbench.trace.Trace.idle_by_host_span`` then
gives each idle stretch to the innermost span covering it, the self time
of a parent to the parent, and the stretches of one top-level span sum to
what that span alone was given.

A metric reader that needs the spans calls :func:`install` when it is
imported: the harness imports the per-layer readers of a ``--trace 1`` run
before its first window and offers no earlier hook. Against a program
without ``record()`` nothing is wrapped and the readers read None.

    python3 -m hnswbench.program_spans --workload sift1m.ingest --seed 7 \\
        --seconds 51 --trace 1

runs ``hnswbench.run`` with the spans installed whatever the cell's
metrics, so that its ``breakdown`` names the program's spans.
"""

from __future__ import annotations

import bisect
import collections
import functools
import math
import re
import statistics
import sys

from hnswbench import loop
from hnswbench.trace import gaps

#: trace categories of host calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: host calls that should each have put an operation on the device
LAUNCH_CALL = re.compile(r"Launch|Memcpy|Memset")

_state = {"installed": False, "paused": False}


def _profiling():
    """The program's profiling module where it has ``record()``, else
    None."""
    from tpu_hnsw_torch.utils import profiling

    return profiling if hasattr(profiling, "record") else None


def pause(_run=None) -> None:
    """No sink in the windows that follow (a reader's ``before``)."""
    _state["paused"] = True


def resume(_run=None) -> None:
    """Sinks again (a reader's ``after``)."""
    _state["paused"] = False


def install() -> None:
    """Wraps the load generator's windows, once per process."""
    if _state["installed"] or _profiling() is None:
        return
    _state["installed"] = True
    loop.SearchClient.window = _recorded(loop.SearchClient.window,
                                         lambda out: out)
    loop.build_window = _recorded(loop.build_window, lambda out: out[1])


def _recorded(fn, window_of):
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if _state["paused"] or math.isfinite(kw.get("seconds", math.inf)):
            return fn(*args, **kw)
        with _profiling().record() as rec:
            out = fn(*args, **kw)
        window_of(out).program = rec
        host = kw.get("spans")
        if host is not None:
            host[:] = innermost(host, program_spans(rec))
        return out

    return wrapper


def program_spans(rec) -> list:
    """The recorder's spans as ``(name, parent, start, end)`` on the
    host's ``time.perf_counter()`` clock in seconds."""
    off = rec.offset_us
    return [(s.name, s.parent, (s.start - off) / 1e6, (s.end - off) / 1e6)
            for s in rec.spans]


def innermost(host: list, program: list) -> list:
    """The host spans ``(name, start, end)`` (top-level, disjoint) and the
    program's spans ``(name, parent, start, end)`` as disjoint stretches
    ``(name, start, end)``, each named by the innermost span over it. A
    program root lies under the host span that covers its start, or at
    the top level."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    nodes = [(name, a, b) for name, a, b in host]
    kids: list = [[] for _ in nodes]
    first = len(nodes)
    for name, parent, a, b in program:
        i = len(nodes)
        nodes.append((name, a, b))
        kids.append([])
        if parent >= 0:
            kids[first + parent].append(i)
            continue
        j = bisect.bisect_right(starts, a) - 1
        if j >= 0 and a < host[j][2]:
            kids[j].append(i)
    out = []
    for i, (name, a, b) in enumerate(nodes):
        inner = [(nodes[c][1], nodes[c][2]) for c in kids[i]]
        out.extend((name, s, e) for s, e in gaps(inner, a, b))
    return sorted(out, key=lambda h: h[1])


def span_ms(window, name: str):
    """Median host ms a request (a root span) spends in the program's span
    ``name`` over ``window``, or None where the window holds no such
    span."""
    rec = getattr(window, "program", None)
    if rec is None:
        return None
    per: dict = {}
    for s in rec.spans:
        if s.name == name:
            per[s.root] = per.get(s.root, 0.0) + (s.end - s.start) / 1e3
    return statistics.median(per.values()) if per else None


def launches_per_request(run):
    """Device operations (kernels, copies, memsets) whose launch record
    (a ``cuda_runtime`` or ``cuda_driver`` event of the same correlation
    id) lies inside one of the program's ``search`` spans, per request, in
    the window traced on the device alone. None where the window holds no
    such span or no device operation, or where a device operation has no
    launch record or a launch call has no device operation: the counts of
    each go to standard error."""
    rec = getattr(run.devtraced, "program", None)
    trace = run.devtrace
    if rec is None or not trace.device_ops:
        return None
    searches = sorted((s.start, s.end) for s in rec.spans
                      if s.name == "search" and s.parent < 0)
    if not searches:
        return None
    starts = [a for a, _ in searches]
    # the innermost program span over each stretch of the trace's clock
    where = innermost([], [(s.name, s.parent, s.start, s.end)
                           for s in rec.spans])
    where_at = [a for _, a, _ in where]
    launched: dict = {}  # correlation id -> (launch time, call name)
    for ev in trace.events:
        if ev.get("cat") in LAUNCH_CATS:
            c = ev.get("args", {}).get("correlation")
            if c is not None:
                launched[c] = (ev["ts"], ev.get("name", ""))
    inside = no_launch = 0
    seen = set()
    by_span: dict = {}  # innermost span -> [operations, device us]
    for op in trace.device_ops:
        c = op.get("args", {}).get("correlation")
        if c not in launched:
            no_launch += 1
            continue
        seen.add(c)
        ts = launched[c][0]
        j = bisect.bisect_right(starts, ts) - 1
        if j < 0 or ts > searches[j][1]:
            continue
        inside += 1
        k = bisect.bisect_right(where_at, ts) - 1
        name = where[k][0] if k >= 0 and ts <= where[k][2] else "search"
        tally = by_span.setdefault(name, [0, 0.0])
        tally[0] += 1
        tally[1] += op["dur"]
    n = len(searches)
    print("hnswbench: a request's device operations and device us by the "
          "innermost span that launched them: "
          + str({k: [v[0] / n, round(v[1] / n, 3)]
                 for k, v in sorted(by_span.items())}), file=sys.stderr)
    no_op = collections.Counter(
        name for c, (_, name) in launched.items()
        if c not in seen and LAUNCH_CALL.search(name))
    print(f"hnswbench: {inside} device operations launched inside "
          f"{len(searches)} search spans; {no_launch} device operations "
          f"without a launch record; {sum(no_op.values())} launch calls "
          f"without a device operation {dict(no_op)}", file=sys.stderr)
    if no_launch or no_op:
        return None
    return inside / len(searches)


def main(argv=None) -> int:
    # the module as the readers import it, not this ``__main__`` copy
    from hnswbench import program_spans, run

    program_spans.install()
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
