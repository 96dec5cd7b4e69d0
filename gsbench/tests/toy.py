"""A toy copy of the benchmark for the CPU tests: the same files, with
each configuration cut to a size a CPU runs in seconds (frames of 64x48,
a few hundred points, 16x16 planes, few cameras), in a directory of its
own that stands for a checkout's root."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
SHRINK = {
    "n3d_flame_steak": {"points": 300, "capacity": 300, "cameras": 5},
    "dnerf_standup": {"points": 200, "capacity": 256, "cameras": 8},
}


def make(tmp: str) -> str:
    """Copy BENCHMARK.json and gsbench/ to ``tmp`` with toy
    configurations; returns the toy root."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp)
    shutil.copytree(BENCH, os.path.join(tmp, "gsbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(tmp, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        path = os.path.join(tmp, c["file"])
        with open(path) as f:
            cfg = json.load(f)
        cut = SHRINK[c["name"]]
        cfg["kplanes_config"]["resolution"] = [16, 16, 16, 8]
        r = int(cfg.get("resolution", 1))
        cfg["bench"]["source_size"] = [64 * r, 48 * r]
        cfg["bench"]["cloud"]["points"] = cut["points"]
        cfg["bench"]["cloud"]["capacity"] = cut["capacity"]
        cfg["bench"]["cameras"]["count"] = cut["cameras"]
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(tmp, "gsbench", "traffic")):
        path = os.path.join(tmp, "gsbench", "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        tr.update({k: v for k, v in (("sweep_frames", 12),
                                     ("schedule_steps", 16),
                                     ("warmup_frames", 1),
                                     ("check_frames", 2)) if k in tr})
        with open(path, "w") as f:
            json.dump(tr, f)
    return tmp


def use(monkeypatch, tmp: str) -> dict:
    """Point the registry at the toy copy; returns its BENCHMARK.json."""
    from gsbench.common import registry
    root = make(tmp)
    monkeypatch.setattr(registry, "ROOT", root)
    monkeypatch.setattr(registry, "BENCH_DIR", os.path.join(root, "gsbench"))
    return registry.load()
