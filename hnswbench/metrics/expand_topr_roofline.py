"""expand_topr_roofline: the fused stage-1 kernel's share of its roofline.

The least time of each traced stage-1 call (:func:`hnswbench.roofline.
expand_bound`: the distinct probed blocks' bytes over 3.35 TB/s, or its
int8 operations over the peak, whichever is larger), summed over the
traced window, over the device time of the stage-1 kernels of
``csrc/expand_score.cu`` in that window. ``before`` wraps the program's
``expand_topr`` for the traced window only, to keep each call's block
ids; the share is given only when the trace holds every launch that the
program's ``ops/expand.py`` counters count.
"""

from __future__ import annotations

from hnswbench import roofline

#: the kernels of one fused stage-1 launch: the grouping kernel, the scorer
#: (grouped route, or the TMA ring), and the merge or select
GROUP = ("group_kernel",)
SCORERS = ("grouped_kernel", "stage_kernel")
STAGE1 = GROUP + SCORERS + ("merge_kernel", "select_kernel")


def before(run):
    from tpu_hnsw_torch.ops import expand as X

    calls = run.extra.setdefault("stage1_calls", [])
    inner = X.expand_topr

    def recorded(blocks, blocks_sq, block_ids, q, q_sq, bids, metric, r,
                 **kw):
        out = inner(blocks, blocks_sq, block_ids, q, q_sq, bids, metric, r,
                    **kw)
        calls.append((tuple(blocks.shape), blocks.dtype, bids,
                      kw.get("score_scale") is not None,
                      kw.get("allowed") is not None, out[0].shape))
        return out

    run.extra["stage1_inner"] = inner
    run.extra["stage1_launches0"] = X.LAUNCHES
    X.expand_topr = recorded


def after(run):
    from tpu_hnsw_torch.ops import expand as X

    X.expand_topr = run.extra.pop("stage1_inner")
    run.extra["stage1_launches"] = X.LAUNCHES - run.extra["stage1_launches0"]


def read(run):
    calls = run.extra.get("stage1_calls")
    if not calls or not run.trace.device_ops:
        return None
    launches = run.extra["stage1_launches"]
    if not (launches == len(calls) == len(run.trace.kernels(GROUP))
            == len(run.trace.kernels(SCORERS))):
        return None  # the trace lost kernels, or another entry ran
    least_ms = 0.0
    for shape, dtype, bids, scaled, filtered, (Q, rq) in calls:
        least_ms += roofline.expand_bound(
            shape, dtype, bids, scaled=scaled, filtered=filtered,
            out_bytes=12 * Q * rq)[0]
    device_ms = sum(ev["dur"] for ev in run.trace.kernels(STAGE1)) / 1e3
    return 100.0 * least_ms / device_ms
