"""route_roofline.laion: the stacked route's share of its roofline where
the GEMM + top-k chain serves it (bf16 centroids).

The least time of each traced chain call (:func:`hnswbench.roofline_route.
route_bound`: ``2 Q C d`` operations at the centroids' dtype's peak, or
their bytes over 3.35 TB/s, whichever is larger), summed over the traced
window, over the device time under the program's `route_chain` range in
that window. ``before`` wraps the program's ``route_topk`` for the traced
window only, to keep each chain call's shape; the share is given only when
the chain ran once a request, the program's ``ROUTE_LAUNCHES["gemm_topk"]``
counted each call, and the trace holds a `route_chain` range with a device
extent for each.
"""

from __future__ import annotations

from hnswbench import roofline_route


def before(run):
    from tpu_hnsw_torch.ops import route as R

    calls = run.extra.setdefault("route_calls", [])
    inner = R.route_topk

    def recorded(centroids, c_sq, q, q_sq, p, metric, **kw):
        if not R.fused(centroids, p):
            calls.append((q.shape[0], centroids.numel() // centroids.shape[-1],
                          centroids.shape[-1], str(centroids.dtype),
                          centroids.element_size(), p))
        return inner(centroids, c_sq, q, q_sq, p, metric, **kw)

    run.extra["route_inner"] = inner
    run.extra["route_chains0"] = R.ROUTE_LAUNCHES.get("gemm_topk", 0)
    R.route_topk = recorded


def after(run):
    from tpu_hnsw_torch.ops import route as R

    R.route_topk = run.extra.pop("route_inner")
    run.extra["route_chains"] = (R.ROUTE_LAUNCHES.get("gemm_topk", 0)
                                 - run.extra.pop("route_chains0"))


def read(run):
    calls = run.extra.get("route_calls")
    if not calls or not run.trace.device_ops:
        return None
    rec = run.trace.range_times(["route_chain"])["route_chain"]
    if not (len(calls) == run.extra["route_chains"] == rec["count"]
            == len(run.traced.records)) or rec["span_ms"] <= 0 \
            or rec["device_ms"] <= 0:
        return None  # the ranges, the counter and the calls disagree
    least_ms = sum(roofline_route.route_bound(*c)[0] for c in calls)
    return 100.0 * least_ms / rec["device_ms"]
