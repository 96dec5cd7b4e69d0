"""Finding a cell's pieces by name, with no per-cell code.

  * the cell: ``BENCHMARK.json``'s ``workloads`` entry of that name;
  * its configuration: the ``file`` of the ``configs`` entry it names;
  * its traffic mix: ``gsbench/traffic/<traffic>.json``;
  * the runner of the mix's ``entry`` (the port's entry point that the
    window drives): the class ``Runner`` of
    ``gsbench/runners/<entry>.py``;
  * its limits (what ``correct`` compares against):
    ``gsbench/limits/<cell>.json``;
  * each per-layer metric: the reader ``gsbench/metrics/<metric>.py``.

A later cell, configuration, mix, runner or metric is a new file and a
new entry.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str = None) -> dict:
    return _json(os.path.join(root or ROOT, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                   + ", ".join(w["name"] for w in bench["workloads"]) + ")")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(ROOT, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def limits(cell_name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "limits", f"{cell_name}.json"))


def _for_cell(entries, cell_name: str, reported=None) -> list:
    out = []
    for e in entries:
        if "workloads" in e:
            if cell_name in e["workloads"]:
                out.append(e)
        elif reported is None or e["moves"] in reported:
            out.append(e)
    return out


def end_to_end(bench: dict, cell_name: str) -> list:
    return _for_cell(bench["end_to_end"], cell_name)


def per_layer(bench: dict, cell_name: str) -> list:
    reported = {e["name"] for e in end_to_end(bench, cell_name)}
    return _for_cell(bench["per_layer"], cell_name, reported)


_LOADED = {}


def _module(sub: str, name: str):
    """gsbench/<sub>/<name>.py, loaded once a process."""
    path = os.path.join(BENCH_DIR, sub, f"{name}.py")
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"gsbench_{sub}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def runner(entry: str):
    """The ``Runner`` class of gsbench/runners/<entry>.py."""
    return _module("runners", entry).Runner


def reader(metric: str):
    """The ``read(ctx)`` of gsbench/metrics/<metric>.py."""
    return _module("metrics", metric).read
