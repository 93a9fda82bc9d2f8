"""The graph engine's answers against pgvector's walk over the same graph.

    python3 -m hnswbench.compare_graph --workload sift1m-graph.bulk \\
        --seed 7 [--queries 1024]

Draws the cell's rows and query pool from ``--seed``, builds its index
through the configuration's engine, serves the first request of the
cell's traffic (its ``request_rows`` consecutive pool rows) through the
timed path, and walks the first ``--queries`` of those queries one at a
time with :func:`hnswbench.reference_graph.walk_all` over the built
graph's tensors. Prints one JSON line: the mean overlap of the two
top-10s, each one's recall@10 against the exact top-10
(:func:`hnswbench.reference.exact_topk`), the share of queries whose
beam was still expanding at the step cap, the walk's level-0 expansions
and the port's steps, and the same readings of the port without the cap
and with pgvector's greedy descent in place of the dense route.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from hnswbench import check, data, reference, spec
from hnswbench import reference_graph as RG


def _port(index, q, k: int, ef: int, max_steps: int = 0,
          route: str = "auto"):
    """The program's answers with per-query steps: (ids ``[Q, k]``, steps
    that expanded a candidate ``[Q]``), a missing id -1."""
    _, ids, hops, _ = index._search(q, k, ef, None, None, max_steps, route,
                                    None, True)
    return torch.where(ids == index.graph.sentinel, -1, ids).long(), hops


def compare(config: dict, traffic: dict, seed: int, device,
            n_queries: int) -> dict:
    engine = spec.module("engines", config["engine"])
    k, ef, metric = config["k"], config["probes"], config["metric"]
    rows, pool = data.of_config(config, seed, device)
    t0 = time.perf_counter()
    index = engine.build(config, rows)
    build_s = time.perf_counter() - t0
    request = pool[:traffic["request_rows"]]
    _, served = engine.search(index, request, k, ef)
    served = served[:n_queries].long().cpu()
    q = request[:n_queries]
    ids, hops = _port(index, q, k, ef)
    if not torch.equal(ids.cpu(), served):
        raise RuntimeError("the counted search differs from the timed path")
    cap = max(ef, k) + 16  # search.search's default: ef / expand + 16
    free, free_hops = _port(index, q, k, ef, max_steps=10 * cap)
    descent, _ = _port(index, q, k, ef, route="descent")
    g = index.graph
    walker = RG.graph(g.vectors.cpu(), g.neighbors0, g.upper_nbrs,
                      g.upper_slot)
    t0 = time.perf_counter()
    _, walked, expanded = RG.walk_all(walker, index.entry, index.entry_level,
                                      q.cpu(), k, ef, metric)
    walk_s = time.perf_counter() - t0
    _, truth = reference.exact_topk(rows, q, k, metric)
    truth = truth.cpu()
    ids, free, descent = ids.cpu(), free.cpu(), descent.cpu()
    hops, free_hops = hops.cpu(), free_hops.cpu()
    ex = expanded.double()
    return {
        "queries": n_queries, "build_s": build_s, "walk_s": walk_s,
        "max_steps": cap,
        # the overlap: the share of the walk's ids that the port's hold
        "overlap": check.recall(ids, walked),
        "recall_port": check.recall(ids, truth),
        "recall_walk": check.recall(walked, truth),
        "at_cap_share": float((hops >= cap).double().mean()),
        "port_steps_mean": float(hops.double().mean()),
        "walk_expanded": {"mean": float(ex.mean()),
                          "p50": float(ex.quantile(0.5)),
                          "p99": float(ex.quantile(0.99)),
                          "max": int(expanded.max())},
        "uncapped": {"overlap": check.recall(free, walked),
                     "recall": check.recall(free, truth),
                     "steps_max": int(free_hops.max()),
                     "steps_mean": float(free_hops.double().mean())},
        "descent": {"overlap": check.recall(descent, walked),
                    "recall": check.recall(descent, truth)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hnswbench: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(spec.load_benchmark(), args.workload)
    out = compare(cell["config"], cell["traffic"], args.seed,
                  torch.device("cuda", 0), args.queries)
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
