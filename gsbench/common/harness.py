"""One run of one cell, as ``gsbench/run.py`` makes it: set-up, the
window, in a traced run the traced segment and the per-layer readers,
then the comparison with the reference, and the result.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from . import registry, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "saro_gs_tpu")


def forbidden_modules() -> list:
    """The JAX modules loaded in this process, by whole top-level name."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def device_info(dev: torch.device, chips: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        traced: bool, device, started: float, fault=None,
        control=False) -> dict:
    """-> the result's fields, with ``checks`` [(name, value, limit)].
    ``started`` is the process's start on the ``time.perf_counter``
    clock, from which set-up is counted.  ``fault`` plants one of the
    runner's faults in the timed path; ``control`` adds the control's
    numbers (``control``), for the calibration of the limits, which also
    reads ``probe``: the window's rate and the capacity probe's sizes."""
    cell = registry.cell(bench, cell_name)
    cfg = registry.config(bench, cell["config"])
    tr = registry.traffic(cell["traffic"])
    lim = registry.limits(cell_name)
    dev = torch.device(device)
    drv = registry.runner(tr["entry"])(cell, cfg, tr, lim, seed, dev)
    drv.fault = fault
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    drv.setup()
    setup_s = time.perf_counter() - started
    w = drv.window(seconds)
    # the peak of set-up and the window, before the traced segments
    dinfo = device_info(dev, int(cell["chips"]))
    values = drv.end_to_end(w)
    values["setup_s"] = setup_s
    out = {"attempted": w.attempted, "failed": w.failed}
    if traced:
        units = int(tr["trace_units"])
        stages, record = drv.traced(units)
        ctx = SimpleNamespace(
            cell=cell, cfg=cfg, traffic=tr, stages=stages, units=units,
            trace=record, counts=drv.counts(),
            window={"units": w.attempted, "seconds": w.seconds,
                    "latencies": w.latencies})
        metrics = {}
        for m in registry.per_layer(bench, cell_name):
            v = registry.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dinfo["busy_s"] = trace.busy_s(record)
        dinfo["window_s"] = trace.window_s(record)
        out["breakdown"] = {"device_ops": trace.device_ops(record),
                            "idle_gaps": trace.idle_gaps(record)}
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]}
                   for m in registry.end_to_end(bench, cell_name)}
    drv.after_window()
    out["probe"] = {"rate": w.attempted / w.seconds,
                    "setup_s": setup_s, "need": drv.need,
                    "max_instances": drv.max_instances,
                    "window_peak": getattr(drv, "peak", None),
                    "memory_peak_bytes": dinfo["memory_peak_bytes"]}
    drv.release()
    checks = drv.check()
    if control:
        out["control"] = drv.control()
    checks.append(("failed_units", w.failed, 0))
    out["correct"] = bool(w.attempted > 0 and all(
        v <= lim for _, v, lim in checks))
    out["metrics"] = metrics
    out["device"] = dinfo
    out["checks"] = checks
    return out


def result_line(out: dict) -> dict:
    """The last line's object: the contract's keys, then the compared
    numbers with their limits under ``checks``, last."""
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in out["checks"]}
    return line
