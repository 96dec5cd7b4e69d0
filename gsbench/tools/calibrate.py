"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size, in one process.  Each run is ``harness.run``, the
set-up, window and check of ``gsbench/run.py`` itself:

  * the program on each of ``--seeds`` (set-up, a short window, the
    comparison with the reference): the lower readings;
  * the control on each of ``--control-seeds``: the reference computed
    in TF32 in the program's place, compared with the float32 reference;
  * each fault the cell can have (``--faults``), planted in the timed
    path, on each of ``--fault-seeds``.

    python3 gsbench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --fault-seeds 4,5,6 --faults alter \
        --seconds 2 --out <dir>/calibrate_<cell>.json

Writes one JSON object: per seed the numbers compared, and the
instances, capacity and rate of the short window.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def one(bench, cell_name, seed, seconds, fault, control):
    """One run of ``harness.run`` (the runs' own runner and check) ->
    its record."""
    import torch
    from gsbench.common import harness
    t0 = time.perf_counter()
    out = harness.run(bench, cell_name, seed, seconds, False, "cuda", t0,
                      fault=fault, control=control)
    rec = {"seed": seed, "fault": fault, "correct": out["correct"],
           "attempted": out["attempted"], "failed": out["failed"]}
    rec.update(out["probe"])
    rec["checks"] = {n: v for n, v, _ in out["checks"]}
    if control:
        rec["control"] = {n: v for n, v, _ in out["control"]}
    rec["run_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, default=[])
    p.add_argument("--control-seeds", type=ints, default=[])
    p.add_argument("--fault-seeds", type=ints, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gsbench.common import registry
    bench = registry.load(ROOT)
    runs = []
    todo = [(s, None, s in args.control_seeds) for s in args.seeds]
    todo += [(s, None, True) for s in args.control_seeds
             if s not in args.seeds]
    todo += [(s, f, False) for f in args.faults.split(",") if f
             for s in args.fault_seeds]
    for seed, fault, control in todo:
        rec = one(bench, args.workload, seed, args.seconds, fault, control)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "runs": runs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
