"""Top-k merge collectives for partitioned search (port of
``tpu_hnsw/parallel/collectives.py``) over ``torch.distributed``.

Where the reference names a ``shard_map`` axis, these take a process group:
a ``torch.distributed.ProcessGroup``, a 1-D
``torch.distributed.device_mesh.DeviceMesh``, or one dimension of a larger
mesh (``mesh.get_group("chip")``). ``None`` (or a group of one process
outside any collective) is the local merge: the concat, dedup and top-k the
reference runs when one device holds every partition.

- :func:`gather_merge_topk`: one ``all_gather`` of each rank's ``[Q, c]``
  lists and a local top-k; every rank receives P*c candidates.
- :func:`ring_merge_topk`: P-1 steps, each forwarding the lists received in
  the step before to the next rank (``batch_isend_irecv``) and merging them
  into a running top-k; the live buffer is k + c columns. The same ids as
  the gather.
- :func:`hierarchical_merge_topk`: a gather over the intra group, then one
  over the inter group: only k candidates a rank cross the second.

Every merge orders like ``lax.top_k``: the candidates stand rank-major in
one row (``moveaxis(all_gather(d), 0, 1).reshape(q, -1)``), and ties go to
the lower column. Distances must be ascending-comparable (operator units
are, for every metric, and so are raw scores); ids ride along.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_hnsw_torch.ops import topk as T


def resolve_group(group):
    """(process group, its size) with ``None`` for no collective; a
    DeviceMesh stands for its only dimension's group."""
    if group is None:
        return None, 1
    if hasattr(group, "get_group"):  # DeviceMesh
        group = group.get_group()
    return group, dist.get_world_size(group)


def _local_topk(d, i, k: int, dedup: bool):
    """The merge of one row of candidates: dedup, then the keyed top-k;
    with ``dedup`` an id whose distance is +inf becomes -1."""
    if dedup:
        d = T.mask_duplicate_ids(d, i)
    vals, sel = T.topk_smallest_by_index(d, min(k, d.shape[1]))
    ids = torch.gather(i, 1, sel)
    if dedup:
        ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals, ids


def gather_merge_topk(d, i, k: int, group=None, dedup: bool = False):
    """``all_gather`` over ``group`` and a local top-k (collectives.py:
    33-47). ``d``/``i``: ``[Q, c]`` on every rank. ``dedup`` drops repeated
    ids before the top-k (replicas arrive from two partitions with equal
    distances). Returns ``[Q, k]`` (values ascending, ids) on every rank."""
    group, n = resolve_group(group)
    if group is not None:
        d_all = [torch.empty_like(d) for _ in range(n)]
        i_all = [torch.empty_like(i) for _ in range(n)]
        dist.all_gather(d_all, d.contiguous(), group=group)
        dist.all_gather(i_all, i.contiguous(), group=group)
        d = torch.stack(d_all, dim=1).reshape(d.shape[0], -1)
        i = torch.stack(i_all, dim=1).reshape(i.shape[0], -1)
    return _local_topk(d, i, k, dedup)


def ring_merge_topk(d, i, k: int, group=None, dedup: bool = False):
    """Ring merge (collectives.py:50-75): each of P-1 steps sends the lists
    received in the step before (first the rank's own) to the next rank and
    merges what arrives from the previous one, so every rank merges every
    other rank's original candidates once.

    Each candidate keeps its column in the gather's rank-major row, and
    every merge orders by it before the dedup and the top-k: ties and
    duplicates resolve as in :func:`gather_merge_topk`, so every rank
    returns the gather's ids. The reference's ring keeps the rank's own
    candidates first, so it agrees with its gather only where no distance
    ties, and it cuts the rank's own list to k before its dedup, so a
    replica within one rank can cost a result. Without a group, or in a
    group of one, it is the local merge. Duplicate ids must carry equal
    distances (replicas do)."""
    group, n = resolve_group(group)
    if group is None or n == 1:
        return _local_topk(d, i, k, dedup)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    c = d.shape[1]
    cols = torch.arange(c, device=d.device).expand(d.shape[0], c)
    # the rank's own list is deduplicated before it is cut to k: a copy
    # kept there would hold a place its masking later leaves empty
    vals, sel = T.topk_smallest_by_index(
        T.mask_duplicate_ids(d, i) if dedup else d, min(k, c))
    acc_d, acc_i = vals, torch.gather(i, 1, sel)
    acc_o = torch.gather(cols, 1, sel) + me * c
    send_d, send_i = d.contiguous(), i.contiguous()
    for step in range(1, n):
        recv_d, recv_i = torch.empty_like(send_d), torch.empty_like(send_i)
        ops = [dist.P2POp(dist.isend, send_d, nxt, group),
               dist.P2POp(dist.isend, send_i, nxt, group),
               dist.P2POp(dist.irecv, recv_d, prv, group),
               dist.P2POp(dist.irecv, recv_i, prv, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        send_d, send_i = recv_d, recv_i
        origin = cols + ((me - step) % n) * c
        o = torch.cat([acc_o, origin], 1)
        order = torch.argsort(o, dim=1)
        md = torch.gather(torch.cat([acc_d, recv_d], 1), 1, order)
        mi = torch.gather(torch.cat([acc_i, recv_i], 1), 1, order)
        mo = torch.gather(o, 1, order)
        if dedup:
            md = T.mask_duplicate_ids(md, mi)
        acc_d, sel = T.topk_smallest_by_index(md, min(k, md.shape[1]))
        acc_i = torch.gather(mi, 1, sel)
        acc_o = torch.gather(mo, 1, sel)
        if dedup:
            acc_i = torch.where(torch.isfinite(acc_d), acc_i, -1)
    return acc_d, acc_i


def hierarchical_merge_topk(d, i, k: int, intra_group=None, inter_group=None,
                            dedup: bool = False):
    """Two-level merge (collectives.py:78-86): a gather over ``intra_group``
    (the ranks of one host), then over ``inter_group`` (one rank of each
    host); only k candidates a rank cross the second. Equal to one flat
    merge over both, as top-k is associative."""
    d, i = gather_merge_topk(d, i, k, intra_group, dedup=dedup)
    return gather_merge_topk(d, i, k, inter_group, dedup=dedup)
