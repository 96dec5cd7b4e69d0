"""Whole runs: no card means no result; the port's plain path agrees with
the reference at a toy size; each fault that a cell can have, planted in
the timed path under the rest of a run, turns ``correct`` false."""
import json
import os
import subprocess
import sys

import pytest

from gsbench import run
from gsbench.common import registry
from gsbench.tests import toy

CELLS = ("n3d_flame_steak.view_sweep", "dnerf_standup.train_b4",
         "n3d_flame_steak.train_b4")
FAULTS = {"n3d_flame_steak.view_sweep": ("alter",),
          "dnerf_standup.train_b4": ("unchanged", "half_batch"),
          "n3d_flame_steak.train_b4": ("unchanged", "half_batch")}


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, os.path.join(toy.BENCH, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=toy.ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout == ""
    assert "CUDA" in res.stderr


def _run(capsys, cell, trace=0, fault=None):
    rc = run.main(["--workload", cell, "--seed", "4000000003", "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu", started=0.0,
                  fault=fault)
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert err.strip().splitlines()[-1].startswith("check failed_units")
    return line


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_at_toy_size(cell, tmp_path, monkeypatch, capsys):
    toy.use(monkeypatch, str(tmp_path))
    line = _run(capsys, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {
        m["name"] for m in registry.end_to_end(registry.load(), cell)}
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run(cell, tmp_path, monkeypatch, capsys):
    toy.use(monkeypatch, str(tmp_path))
    line = _run(capsys, cell, trace=1)
    assert line["correct"]
    assert "window_s" in line["device"] and "breakdown" in line
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]])
def test_fault_is_caught(cell, fault, tmp_path, monkeypatch, capsys):
    toy.use(monkeypatch, str(tmp_path))
    line = _run(capsys, cell, fault=fault)
    assert not line["correct"], line["checks"]
