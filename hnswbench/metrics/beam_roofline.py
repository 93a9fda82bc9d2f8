"""beam_roofline: the level-0 beam's share of its roofline.

The least time of the bytes the traced window's beams had to read
(:func:`hnswbench.roofline_graph.beam_least_ms`: the program's counters
``tpu_hnsw_torch.index.search.BEAM_ROWS``, the expanded nodes' adjacency
rows of the level-0 degree 2m, and ``BEAM_VECTORS``, the distinct vectors
of the configuration's dim those rows and the seeds name), over the device
time under the program's `beam_level0` range in that window. ``before``
and ``after`` read the counters around the traced window; the share is
given only when the counters counted one beam for each request and the
trace holds one `beam_level0` range with a device extent for each.
"""

from __future__ import annotations

from hnswbench import roofline_graph

_NAMES = ("BEAM_ROWS", "BEAM_VECTORS", "BEAM_COUNTED")


def _counters():
    from tpu_hnsw_torch.index import search

    got = [getattr(search, n, None) for n in _NAMES]
    return None if None in got else got


def before(run):
    run.extra["beam_counters0"] = _counters()


def after(run):
    c0 = run.extra.pop("beam_counters0", None)
    if c0 is not None:
        run.extra["beam_counters"] = [b - a for a, b in zip(c0, _counters())]


def read(run):
    counted = run.extra.get("beam_counters")
    n = len(run.traced.records)
    if not counted or counted[2] != n or not run.trace.device_ops:
        return None
    rec = run.trace.range_times(["beam_level0"])["beam_level0"]
    if rec["count"] != n or rec["span_ms"] <= 0 or rec["device_ms"] <= 0:
        return None  # the ranges and the counters disagree
    cfg = run.config
    least = roofline_graph.beam_least_ms(counted[0], counted[1],
                                         2 * cfg["m"], cfg["dim"])
    return 100.0 * least / rec["device_ms"]
