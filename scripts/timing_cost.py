"""What the port's tracing (saro_gs_torch/timing.py) costs in one cell of
the benchmark, on the card:

    python3 scripts/timing_cost.py --workload <cell> --seed <n> \
        --seconds <s> [--rounds <r>]

One process, one seed: the cell's set-up, then ``rounds`` pairs of timed
windows of ``seconds`` each, in turns (off, on; on, off; ...), with no
recorder and with one recorder over the whole window; then 4 x ``rounds``
pairs of the traced run's marks segment, in turns, with the spans and
counters on and off (marks alone, as before the spans), to show what
they add to the stages' stream ms; then the benchmark's traced segments,
from which the ``saro/`` ranges a unit under the profiler are counted.
Prints one JSON line: the card, the windows' rates, the stages' medians
a unit with spans on and off, the ranges a unit by name.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from gsbench.common import drive, registry
    from saro_gs_torch import timing
    bench = registry.load(ROOT)
    cell = registry.cell(bench, args.workload)
    tr = registry.traffic(cell["traffic"])
    drv = registry.runner(tr["entry"])(
        cell, registry.config(bench, cell["config"]), tr,
        registry.limits(args.workload), args.seed, torch.device(args.device))
    drv.setup()
    rates = {"off": [], "on": []}
    for r in range(args.rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            if on:
                with timing.record() as rec:
                    w = drv.window(args.seconds)
                units = len(rec.units())
            else:
                w = drv.window(args.seconds)
                units = 0
            rates["on" if on else "off"].append(
                {"rate": w.attempted / w.seconds, "units": w.attempted,
                 "recorded_units": units})
    n = int(tr["trace_units"])
    if tr["entry"] == "test_render":
        def one():
            timing.mark("frame")
            drv.frame()
    else:
        one = drv.step
    stages = {"on": [], "off": []}
    null = {"span": lambda name, view=None: timing._NULL,
            "unit": lambda name: timing._NULL}
    keep = {k: getattr(timing, k) for k in null}
    for r in range(8 * args.rounds):
        on = r % 4 in (1, 2)
        for k in null:
            setattr(timing, k, keep[k] if on else null[k])
        drive.sync(drv.dev)
        with timing.record() as rec:
            for _ in range(n):
                one()
        stages["on" if on else "off"].append(
            {k: v / n for k, v in rec.stages().items()})
    for k in null:
        setattr(timing, k, keep[k])
    _, record = drv.traced(n)
    ranges = collections.Counter(name for name, _, _ in record["host"]
                                 if name.startswith("saro/"))
    off = statistics.median(x["rate"] for x in rates["off"])
    on = statistics.median(x["rate"] for x in rates["on"])
    dev = torch.device(args.device)
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "seconds": args.seconds,
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "rates": rates, "median_off": off, "median_on": on,
        "on_over_off": on / off,
        "stage_ms": {mode: {k: statistics.median(s[k] for s in segs)
                            for k in segs[0]}
                     for mode, segs in stages.items()},
        "saro_ranges_per_unit": sum(ranges.values()) / n,
        "by_name_per_unit": {k: v / n for k, v in sorted(ranges.items())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
