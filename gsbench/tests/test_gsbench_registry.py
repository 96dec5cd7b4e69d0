"""The harness finds every piece of a cell by name, and picks up an added
cell, configuration, traffic mix and per-layer metric with no edit."""
import json
import os
import shutil

from gsbench.common import harness, registry
from gsbench.tests import toy


def test_every_cell_resolves():
    bench = registry.load()
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        assert cfg["bench"]["cloud"]["points"] > 0
        assert registry.traffic(w["traffic"])["entry"]
        assert registry.limits(w["name"])
        for m in registry.per_layer(bench, w["name"]):
            assert callable(registry.reader(m["name"]))
        assert {m["name"] for m in registry.end_to_end(bench, w["name"])} \
            >= {"setup_s"}


def test_added_cell_needs_no_edit(tmp_path, monkeypatch):
    bench = toy.use(monkeypatch, str(tmp_path))
    root = registry.ROOT
    # a new configuration, traffic mix, limits and metric: files and
    # entries only
    src = os.path.join(root, "gsbench", "configs", "dnerf_standup.json")
    new_cfg = os.path.join(root, "gsbench", "configs", "dnerf_small.json")
    shutil.copy(src, new_cfg)
    with open(os.path.join(root, "gsbench", "traffic", "view_sweep.json")) \
            as f:
        tr = json.load(f)
    tr["check_frames"] = 1
    with open(os.path.join(root, "gsbench", "traffic", "view_one.json"),
              "w") as f:
        json.dump(tr, f)
    with open(os.path.join(root, "gsbench", "limits",
                           "dnerf_small.view_one.json"), "w") as f:
        json.dump({"frame_mae": 1e-6}, f)
    with open(os.path.join(root, "gsbench", "metrics",
                           "frames_traced.view.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx.units\n")
    bench["configs"].append({"name": "dnerf_small", "source": "x",
                             "file": "gsbench/configs/dnerf_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dnerf_small.view_one",
                               "config": "dnerf_small",
                               "traffic": "view_one", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_fps":
            m["workloads"].append("dnerf_small.view_one")
    bench["per_layer"].append({"name": "frames_traced.view", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "render_fps",
                               "workloads": ["dnerf_small.view_one"]})
    out = harness.run(bench, "dnerf_small.view_one", 7, 0.2, True, "cpu",
                      0.0)
    assert out["correct"]
    assert out["metrics"]["frames_traced.view"]["value"] == \
        registry.traffic("view_one")["trace_units"]


def test_added_runner_needs_no_edit(tmp_path, monkeypatch):
    """A mix that drives another entry point brings a runner file of its
    own, found by the mix's ``entry``: here ``test_render`` held at one
    time, as a viewer paused on a frame."""
    bench = toy.use(monkeypatch, str(tmp_path))
    bench_dir = registry.BENCH_DIR
    with open(os.path.join(bench_dir, "runners", "test_render_paused.py"),
              "w") as f:
        f.write(
            "from gsbench.common import registry\n\n\n"
            "class Runner(registry.runner('test_render')):\n"
            "    poses = []\n\n"
            "    def pose(self, i):\n"
            "        k, _ = super().pose(i)\n"
            "        Runner.poses.append((k, 0.5))\n"
            "        return k, 0.5\n")
    with open(os.path.join(bench_dir, "traffic", "view_sweep.json")) as f:
        tr = json.load(f)
    tr["entry"] = "test_render_paused"
    with open(os.path.join(bench_dir, "traffic", "paused.json"), "w") as f:
        json.dump(tr, f)
    shutil.copy(os.path.join(bench_dir, "limits",
                             "n3d_flame_steak.view_sweep.json"),
                os.path.join(bench_dir, "limits",
                             "n3d_flame_steak.paused.json"))
    bench["workloads"].append({"name": "n3d_flame_steak.paused",
                               "config": "n3d_flame_steak",
                               "traffic": "paused", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "render_fps":
            m["workloads"].append("n3d_flame_steak.paused")
    out = harness.run(bench, "n3d_flame_steak.paused", 7, 0.2, False, "cpu",
                      0.0)
    assert out["correct"] and out["attempted"] > 0
    poses = registry.runner("test_render_paused").poses
    assert len(poses) >= out["attempted"]
    assert {ts for _, ts in poses} == {0.5}
