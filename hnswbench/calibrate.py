"""Readings that the limits of ``correct`` are set from.

    python3 -m hnswbench.calibrate --workload sift1m.bulk --seeds 1,2,3 \\
        [--sides program,control,route_one_probe] [--seconds 2] \\
        [--control-seconds 4] [--out FILE]

For each seed, in one process, a run of each side, each judged as a
benchmark run judges its window: ``program`` (a window of ``--seconds``),
``control`` (:mod:`hnswbench.control`, a window of ``--control-seconds``)
and any fault of :mod:`hnswbench.faults` by its name (a window of
``--seconds``). Prints one JSON line per run with the numbers compared
and the recall; ``--out`` appends them to a file too. The largest reading
of sound runs over a dozen seeds or more, and the smallest of the control
or a fault, are the two readings a limit lies between.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from hnswbench import control, spec
from hnswbench.faults import Faulty
from hnswbench.run import run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hnswbench: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(spec.load_benchmark(), args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        for side in args.sides.split(","):
            if side == "program":
                engine, secs = None, args.seconds
            elif side == "control":
                engine, secs = control, args.control_seconds
            else:
                engine, secs = Faulty(side, cell["config"]), args.seconds
            out = run_cell(cell, seed, secs, False, dev, engine=engine)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "side": side, "correct": out["correct"],
                               "compared": out["compared"],
                               "metrics": out["metrics"],
                               "device": out["device"]})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
