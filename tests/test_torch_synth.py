"""The port's synthetic-scene builder (saro_gs_torch/data/synth.py) against
scripts/make_synth_scene.py, on the CPU: the ground-truth arrays and the
init cloud to the bit, and the two writers' datasets at 32x24.

The script renders with the JAX package's rasterizer.  On the CPU that is
the pure-JAX compositor, which walks at most ``max_slots`` (2048, the
script's setting) instances a tile; at 32x24 the one tile holds every
splat in view, up to 46,000.  The Pallas compositor the script runs on the
TPU has no such cap, and neither has the port's.  So the script's run here
lifts the cap to cover the tile (``_MAX_SLOTS``), and nothing else of it
changes.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from saro_gs_torch.data import synth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "make_synth_scene.py")
FLAGS = ["--width", "32", "--height", "24", "--frames", "3", "--cams", "3",
         "--init_points", "2000"]
_MAX_SLOTS = 1 << 16


def _script_module():
    import importlib.util
    spec = importlib.util.spec_from_file_location("make_synth_scene", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_gt_matches_script():
    """build_gt(7)'s arrays and gt_at(t) equal the script's to the bit."""
    theirs = _script_module().build_gt(7)
    mine = synth.build_gt(7)
    assert mine["base"].shape == (46000, 3)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        if k != "gt_at":
            assert mine[k].dtype == v.dtype and np.array_equal(mine[k], v), k
    for t in (0.0, 0.37, 1.0):
        x, y = theirs["gt_at"](t), mine["gt_at"](t)
        assert x.dtype == y.dtype == np.float32
        assert np.array_equal(x, y), t


def _run(cmd, env):
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    return res.stdout


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The script's dataset (JAX on the CPU, the tile cap lifted) and the
    port's (``python -m saro_gs_torch.data.synth --device cpu``), written
    with the same flags side by side."""
    out = tmp_path_factory.mktemp("synth")
    theirs, mine = str(out / "script"), str(out / "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    lift = ("import runpy, sys\n"
            "import saro_gs_tpu.ops.rasterize as r\n"
            "base = r.RasterConfig\n"
            f"r.RasterConfig = lambda **k: base(**dict(k, max_slots="
            f"{_MAX_SLOTS}))\n"
            f"sys.argv = [{SCRIPT!r}] + sys.argv[1:]\n"
            f"runpy.run_path({SCRIPT!r}, run_name='__main__')\n")
    log_theirs = _run([sys.executable, "-c", lift, "--out", theirs] + FLAGS,
                      env)
    # one intra-op thread: the plain compositor walks 46,000 instances of
    # one tile in small steps, where more threads only contend
    log_mine = _run([sys.executable, "-m", "saro_gs_torch.data.synth",
                     "--out", mine, "--device", "cpu"] + FLAGS,
                    dict(env, OMP_NUM_THREADS="1"))
    return theirs, mine, log_theirs, log_mine


def test_writer_matches_script(datasets):
    """The same files; the transforms JSONs equal to the byte;
    points3d.ply equal to the bit; every PNG within 1/255 per value (the
    count of values that differ is printed); the logs' coverage lines
    equal."""
    theirs, mine, log_theirs, log_mine = datasets
    names = sorted(os.listdir(theirs))
    assert names == sorted(os.listdir(mine))
    pngs = [f for f in names if f.endswith(".png")]
    assert len(pngs) == 9 and "r_00_002.png" in pngs
    for split in ("train", "test"):
        path = f"transforms_{split}.json"
        with open(os.path.join(theirs, path), "rb") as a, \
                open(os.path.join(mine, path), "rb") as b:
            raw_a, raw_b = a.read(), b.read()
        assert raw_a == raw_b, split
        frames = json.loads(raw_a)["frames"]
        assert [f["time"] for f in frames[:3]] == [0.0, 0.5, 1.0]
    with open(os.path.join(theirs, "points3d.ply"), "rb") as a, \
            open(os.path.join(mine, "points3d.ply"), "rb") as b:
        assert a.read() == b.read()
    differ = total = 0
    for f in pngs:
        x = np.asarray(Image.open(os.path.join(theirs, f)), np.int32)
        y = np.asarray(Image.open(os.path.join(mine, f)), np.int32)
        assert x.shape == y.shape == (24, 32, 3), f
        assert np.abs(x - y).max() <= 1, f
        differ += int((x != y).sum())
        total += x.size
    print(f"{differ} of {total} PNG values differ (by at most 1/255)")

    def coverage(log):
        return [ln for ln in log.splitlines() if "coverage" in ln]
    assert coverage(log_theirs) == coverage(log_mine)
    assert len(coverage(log_mine)) == 2


def test_init_cloud_matches_script(datasets):
    """init_cloud's points, colours and times are what the script stored
    in points3d.ply (times j / frames, colours truncated to uint8)."""
    from saro_gs_torch.data import ply
    theirs = datasets[0]
    pts, cols, times = synth.init_cloud(synth.build_gt(7), 3, 2000, 7)
    assert pts.dtype == times.dtype == np.float32
    p, c, t = ply.fetch_point_cloud(os.path.join(theirs, "points3d.ply"))
    assert np.array_equal(p, pts.astype(np.float64))
    assert np.array_equal(t, times.astype(np.float64))
    assert np.array_equal(c, (cols * 255).astype(np.uint8) / 255.0)
    assert set(np.unique(times * 3)) <= {0.0, 1.0, 2.0}
