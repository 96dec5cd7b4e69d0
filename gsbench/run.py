"""The benchmark of saro_gs_torch, the PyTorch/CUDA port, on NVIDIA GPUs.

    python3 gsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  One run of one cell (``BENCHMARK.json``'s
``workloads``): the inputs are made from the seed on the card, the cell's
shapes warmed up, the window measured for ``--seconds``; with ``--trace
1`` a short segment after the window is profiled and the cell's
per-layer metrics read from it.  Then what the window produced is
compared with the plain reference (``gsbench/reference/``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines of standard error repeat.

Exits 3, printing no result, without a card (or fewer cards than the
cell asks for), and 4 if JAX or the JAX package was loaded.  Kernel
builds and caches stay inside the checkout, under ``build/``.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_age() -> float:
    """Seconds since this process started (0 where /proc is missing)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def parse(argv=None):
    p = argparse.ArgumentParser(prog="gsbench/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device="cuda", started=None, fault=None) -> int:
    """``device`` "cpu" (tests only) skips the look for a card."""
    if started is None:
        age = process_age()
        started = time.perf_counter() - age if age > 0 else STARTED
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    # caches of compilers the port or torch may use, at fixed paths in
    # the checkout (the port's nvcc builds go to build/saro_gs_torch/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, "build", "gsbench", sub)
    from gsbench.common import registry
    bench = registry.load(ROOT)
    cell = registry.cell(bench, args.workload)
    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"gsbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from gsbench.common import harness
    out = harness.run(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, started, fault=fault)
    found = harness.forbidden_modules()
    if found:
        print("gsbench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(harness.result_line(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
