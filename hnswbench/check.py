"""How ``correct`` is decided: the numbers compared, each beside its limit.

The program's answers (a sample of a window's results, drawn from the
seed, or every pool query served by an index a window built) are judged
against the plain reference (:mod:`hnswbench.reference`):

- ``bad_rows``: result rows that break the result contract: an id outside
  ``[0, n)`` (a missing result is -1), an id twice, a distance that is not
  finite or is smaller than the one before it. Exact: limit 0.
- ``dist_gap``: the widest gap between a returned distance and the
  reference's float64 distance of the same (query, id) pair, as a share of
  the pair's rounding scale ``|q|^2 + |x|^2`` (scores: squared L2, or the
  negated inner product).
- ``missed_at_10``: the share of the reference's exact top-k ids that the
  answers miss (1 - recall@10). It holds the route and stage 1, which
  choose the ids, where ``dist_gap`` holds the rerank's arithmetic: a
  route that probes too few blocks, or a stage 1 that drops candidates,
  answers distinct ids at exact distances, and only this number sees it.
- ``rows_lost`` (an index built in the window): rows of the input that the
  built index does not hold exactly once and bit for bit. Exact: limit 0.

Recall@10 itself is also reported as a metric, held to a bound, so that a
loss of answers smaller than ``missed_at_10``'s limit still shows.
"""

from __future__ import annotations

import math

import torch

from hnswbench import reference as R

#: rows compared at once
CHECK_BLOCK = 1 << 16


def bad_rows(dist: torch.Tensor, ids: torch.Tensor, n: int) -> int:
    """Rows of ``(dist, ids) [m, k]`` that break the result contract."""
    bad = ((ids < 0) | (ids >= n)).any(1)
    srt = torch.sort(ids, dim=1).values
    bad |= (srt[:, 1:] == srt[:, :-1]).any(1)
    bad |= ~torch.isfinite(dist).all(1)
    bad |= (dist[:, 1:] < dist[:, :-1]).any(1)
    return int(bad.sum())


def dist_gap(rows, queries, dist, ids, metric: str) -> float:
    """The widest gap of a returned distance (pairs with an id in range)
    from the reference's, over the pair's rounding scale."""
    n = rows.shape[0]
    worst = 0.0
    for s in range(0, ids.shape[0], CHECK_BLOCK):
        i = ids[s:s + CHECK_BLOCK]
        ok = (i >= 0) & (i < n)
        true, scale = R.pair_scores(rows, queries[s:s + CHECK_BLOCK],
                                    torch.clamp(i, 0, n - 1), metric)
        got = R.distances_to_scores(dist[s:s + CHECK_BLOCK], metric)
        gap = torch.where(ok, (got - true).abs() / scale, 0.0)
        top = float(gap.max()) if gap.numel() else 0.0
        if math.isnan(top):
            return math.inf
        worst = max(worst, top)
    return worst


def recall(ids: torch.Tensor, truth: torch.Tensor) -> float:
    """Share of ``truth [m, k]``'s ids found in ``ids [m, k]``'s rows."""
    hits = 0
    for s in range(0, ids.shape[0], CHECK_BLOCK):
        a, t = ids[s:s + CHECK_BLOCK], truth[s:s + CHECK_BLOCK]
        hits += int((a[:, :, None] == t[:, None, :]).any(1).sum())
    return hits / max(truth.numel(), 1)


def rows_lost(stored_ids: torch.Tensor, stored: torch.Tensor,
              rows: torch.Tensor) -> int:
    """Input rows not held exactly once and bit for bit by an index whose
    live slots hold ids ``stored_ids [m]`` and rows ``stored [m, d]``; an
    out-of-range id counts once too."""
    n = rows.shape[0]
    ok = (stored_ids >= 0) & (stored_ids < n)
    lost = int((~ok).sum())
    ids = stored_ids[ok]
    counts = torch.bincount(ids, minlength=n)
    lost += int((counts == 0).sum()) + int(torch.clamp_min(counts - 1,
                                                           0).sum())
    held = stored[ok]
    for s in range(0, ids.shape[0], CHECK_BLOCK):
        lost += int((held[s:s + CHECK_BLOCK]
                     != rows[ids[s:s + CHECK_BLOCK]]).any(1).sum())
    return lost


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, ``{name: {"value", "limit"}}``)."""
    compared = {name: {"value": v, "limit": limits[name]}
                for name, v in values.items()}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared


def results(rows, pool, truth_ids, sample, metric: str, k: int) -> dict:
    """Numbers of a sample ``(pool rows [m], dist [m, k], ids [m, k])``
    (None: nothing came back): ``bad_rows``, ``dist_gap``,
    ``missed_at_10`` and ``recall``."""
    if sample is None:  # nothing was returned
        return {"bad_rows": math.inf, "dist_gap": math.inf,
                "missed_at_10": 1.0, "recall": 0.0}
    qrows, dist, ids = sample
    dev = rows.device
    qrows, dist, ids = qrows.to(dev), dist.to(dev), ids.to(dev).long()
    if dist.shape[1] != k or ids.shape[1] != k:
        return {"bad_rows": ids.shape[0], "dist_gap": math.inf,
                "missed_at_10": 1.0, "recall": 0.0}
    got = recall(ids, truth_ids[qrows])
    return {"bad_rows": bad_rows(dist, ids, rows.shape[0]),
            "dist_gap": dist_gap(rows, pool[qrows], dist, ids, metric),
            "missed_at_10": 1.0 - got, "recall": got}
