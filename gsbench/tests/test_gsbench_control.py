"""The control: the reference computed in TF32 in the program's place
fails a cell's comparison, in a whole run of ``harness.run``.  TF32
exists on the card only, so this runs there (``-m cuda``) and skips
here."""
import time

import pytest
import torch

from gsbench.common import harness
from gsbench.tests import toy

CELLS = ("n3d_flame_steak.view_sweep", "dnerf_standup.train_b4",
         "n3d_flame_steak.train_b4")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists on the card only: run on the H100")
    bench = toy.use(monkeypatch, str(tmp_path))
    out = harness.run(bench, cell, 11, 0.5, False, "cuda",
                      time.perf_counter(), control=True)
    assert out["correct"], out["checks"]
    assert any(v > lim for _, v, lim in out["control"])
