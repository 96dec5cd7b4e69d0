"""The train runner's views: a DyNeRF rig's steps draw distinct (camera,
frame) pairs out of every camera's every frame, a D-NeRF capture's draws
are those the benchmark has always made, and the traced steps keep the
state each step starts from."""
import hashlib

import torch

from gsbench.common import harness, registry
from gsbench.tests import toy

RUNNER = registry._module("runners", "train_step_core")
TRAFFIC = registry.traffic("train_b4")
# sha256 of the D-NeRF capture's schedule, pool indices, the scheduled
# views' times and the probe's views for seed 0, as drawn before a rig's
# views existed (one pose a frame, frame j at time j/149)
HEMISPHERE_SEED0 = \
    "4e156e680a375dd9e18f9a4dbf745c1c4eaf7c7f037057d9d66e3ec3cb108376"


def _views(name, seed):
    cfg = registry.config(registry.load(), name)
    count = cfg["bench"]["cameras"]["count"]
    cam, times, probe = RUNNER.capture_views(cfg, count, "cpu")
    views, pool = RUNNER.draw(len(cam), TRAFFIC, seed)
    return cfg, count, cam, times, probe, torch.as_tensor(views), \
        torch.as_tensor(pool)


def test_rig_draws_distinct_pairs_from_every_camera_and_frame():
    cfg, count, cam, times, probe, views, _ = _views("n3d_flame_steak",
                                                     2 ** 31 + 99)
    d = cfg["duration"]
    b, checked = TRAFFIC["batch"], TRAFFIC["check_steps"]
    assert (count, d, len(cam)) == (19, 300, 19 * 300)
    assert views.shape == (checked + TRAFFIC["schedule_steps"], b)
    assert all(len(set(row.tolist())) == b for row in views)
    assert len(set(views[:checked].flatten().tolist())) == b * checked
    frames = views // count
    assert torch.equal(cam[views], views % count)
    assert torch.equal(times[views], frames.to(torch.float32) / d)
    assert set(cam[views].flatten().tolist()) == set(range(count))
    assert set(frames.flatten().tolist()) == set(range(d))
    # the probe: every camera at the first, middle and last frame
    assert len(probe) == 3 * count
    assert {(int(cam[v]), round(float(times[v]) * d)) for v in probe} == {
        (c, f) for c in range(count) for f in (0, d // 2, d - 1)}


def test_hemisphere_draws_unchanged():
    _, count, cam, times, probe, views, pool = _views("dnerf_standup", 0)
    assert torch.equal(cam, torch.arange(count))
    h = hashlib.sha256()
    for t in (views, pool, times[views], torch.tensor(probe)):
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == HEMISPHERE_SEED0


def test_traced_steps_keep_each_steps_start(tmp_path, monkeypatch):
    """Each traced step's snapshot is the state that step started from, to
    the bit, though the nets change in place under it."""
    bench = toy.use(monkeypatch, str(tmp_path))
    cell = registry.cell(bench, "n3d_flame_steak.train_b4")
    cfg = registry.config(bench, cell["config"])
    drv = registry.runner("train_step_core")(
        cell, cfg, registry.traffic("train_b4"),
        registry.limits(cell["name"]), 5, torch.device("cpu"))
    drv.setup()
    starts, step = [], drv.step

    def recording_step():
        starts.append((drv.s, {k: v.clone() for k, v in
                               RUNNER.port.leaves(drv.state).items()}))
        return step()
    drv.step = recording_step
    drv.traced(2)
    assert [s for s, _ in drv.traced_steps] == [s for s, _ in starts[-2:]]
    for (_, snap), (_, start) in zip(drv.traced_steps, starts[-2:]):
        assert snap.keys() == start.keys()
        assert all(torch.equal(snap[k], start[k]) for k in start)
    moved = [k for k in drv.state.nets.leaf_names()
             if not torch.equal(drv.traced_steps[0][1][k],
                                RUNNER.port.leaves(drv.state)[k])]
    assert moved
    drv.release()
    assert harness.forbidden_modules() == []
