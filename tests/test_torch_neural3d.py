"""The Neural3D training mode in both packages, on the CPU, on a toy scene
in the Neural3D on-disk layout (tests/torch_n3d_scene.py: 4 rig cameras x 6
frames, 64x48 sources read at resolution 2, per-frame COLMAP clouds with
near and far floaters).

configs/neural_3D/flame_steak.json with only its widths and schedule cut
(TOY): the ``colmap`` reader, ``preprocesspoints`` 31 (and 3 for the
scene), densify mode 2 with its z prunes, a black background.  Held to
the JAX package: the Scene (merged and preprocessed clouds, capacity,
aabb, extent, splits, the 300 spiral val cameras); the CLI's z < 4.5
prune; both CLIs' trainers from the JAX Scene's initial state, with the
port's densify passes given the JAX run's split draws, so that every
loss, every pass's counts (a capacity growth included) and the journal
are held, not only those up to the first pass; ``grow_state``;
``_zprune_real_xyz``; ``_density_control``'s schedule over iterations 1 to
1,502; and ``cli.test_main``'s 300 val renders against the JAX
``Evaluator.render_set("val", ...)`` on the same checkpoint.
"""
import concurrent.futures
import dataclasses
import json
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import cli as tcli
from saro_gs_torch import config as tconfig
from saro_gs_torch import convert
from saro_gs_torch import eval as teval
from saro_gs_torch import scene as tscene
from saro_gs_torch.models import densify as tdens
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.train import lpips as tlpips
from saro_gs_torch.train import trainer as ttrainer
from saro_gs_tpu import cli as jcli
from saro_gs_tpu import config as jconfig
from saro_gs_tpu import eval as jeval
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.train import lpips as jlpips
from saro_gs_tpu.train import trainer as jtrainer
from tests import torch_n3d_scene as n3d
from tests.test_torch_data import _same_cameras, _same_point_clouds
from tests.test_torch_step import _jax_state_np
from tests.torch_parity import n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAME = os.path.join(ROOT, "configs", "neural_3D", "flame_steak.json")
# flame_steak.json cut to the toy: 6 frames, planes 16^3 x 8 of 8
# channels, 8 iterations with densify passes at 3 and 6 (the first one
# overflows the 512 slots and grows them to 1,024), the pure-JAX
# compositor without a per-tile cap (max_slots is the grown capacity: no
# tile holds more instances than there are Gaussians)
TOY = dict(
    duration=n3d.TOY_FRAMES, iterations=8, densify_from_iter=2,
    densification_interval=3, densify_until_iter=7, test_iteration=8,
    position_lr_max_steps=8, capacity=512, raster_backend="jax",
    max_instances=4096, max_slots=1024,
    kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                    "output_coordinate_dim": 8,
                    "resolution": [16, 16, 16, 8]})
ITERS = TOY["iterations"]


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The toy layout, written once; each package reads its own copy."""
    root = str(tmp_path_factory.mktemp("n3d") / "scene")
    meta = n3d.toy_scene(root)
    return dict(root=root, **meta)


def _copy(layout, dst) -> str:
    """A copy of the layout; the reader's ``source_path`` in it."""
    shutil.copytree(layout["root"], str(dst))
    return os.path.join(str(dst), "colmap_0")


def _config_dict(**over):
    with open(FLAME) as f:
        cfg = json.load(f)
    cfg.update(TOY, **over)
    return cfg


def test_layout_files(layout, tmp_path):
    """The layout's points3D.bin are colmap.write_points3d_binary's bytes;
    the prep path's poses (llff_poses_to_colmap) read back to the
    poses_bounds.npy centres."""
    from saro_gs_torch.data import colmap, readers
    xyz, rgb = layout["clouds"][2]
    colmap.write_points3d_binary(xyz, rgb, str(tmp_path / "p.bin"))
    with open(tmp_path / "p.bin", "rb") as a, open(os.path.join(
            layout["root"], "colmap_2", "sparse", "0", "points3D.bin"),
            "rb") as b:
        assert a.read() == b.read()
    info = readers.read_colmap_scene(_copy(layout, tmp_path / "s"),
                                     duration=n3d.TOY_FRAMES, resolution=2)
    cams = info.test_cameras + info.train_cameras
    assert len(cams) == n3d.TOY_CAMS * n3d.TOY_FRAMES
    assert (cams[0].width, cams[0].height) == (n3d.TOY_W // 2,
                                               n3d.TOY_H // 2)
    centers = layout["poses_bounds"][:, :15].reshape(-1, 3, 5)[:, :, 3]
    for cam in cams:
        k = int(cam.image_name[3:])
        np.testing.assert_allclose(cam.camera_center, centers[k], atol=1e-5)


@pytest.mark.parametrize("mode", [31, 3])
def test_scene_matches_jax(layout, tmp_path, mode):
    """Scene in both packages from the toy layout with preprocesspoints 31
    and 3: the merged cloud (every frame's points), the preprocessed cloud
    (the port's rows equal the JAX rows, the frame-0 floaters in it and
    nothing at or past the mode's height), the capacity, the field's aabb
    from the cloud before the preprocess, the cameras' extent, the
    train/test split and the 300 val cameras."""
    cfg = _config_dict(preprocesspoints=mode)
    jc = jconfig.load_config(source_path=_copy(layout, tmp_path / "a"),
                             model_path=str(tmp_path / "mj"), **cfg)
    tc = tconfig.load_config(source_path=_copy(layout, tmp_path / "b"),
                             model_path=str(tmp_path / "mt"), **cfg)
    js = jscene.Scene(jc)
    ts = tscene.Scene(tc, device="cpu")
    _same_point_clouds(js.info.point_cloud, ts.info.point_cloud)
    merged = ts.info.point_cloud.points
    assert merged.shape[0] == sum(c[0].shape[0] for c in layout["clouds"])
    # the merged ply holds float32 positions
    np.testing.assert_array_equal(merged, np.concatenate(
        [c[0] for c in layout["clouds"]]).astype(np.float32))
    for k in ("aabb_min", "aabb_max", "duration"):
        np.testing.assert_array_equal(n(getattr(js.fstatic, k)),
                                      n(getattr(ts.fstatic, k)), k)
    np.testing.assert_array_equal(n(ts.fstatic.aabb_max),
                                  merged.max(0).astype(np.float32))
    assert js.cameras_extent == ts.cameras_extent
    alive = n(ts.alive) > 0
    np.testing.assert_array_equal(n(js.alive), n(ts.alive))
    assert js.params.xyz.shape == ts.params.xyz.shape
    cap = ts.params.xyz.shape[0]
    assert cap == max(tc.capacity, 1 << int(alive.sum() - 1).bit_length())
    # (the temporal positions are U(0, 1) draws of each package's RNG)
    for k in ("xyz", "features_dc"):
        np.testing.assert_array_equal(n(getattr(js.params, k))[alive],
                                      n(getattr(ts.params, k))[alive], k)
    # the knn scales in float32, by two implementations
    np.testing.assert_allclose(n(js.params.scaling)[alive],
                               n(ts.params.scaling)[alive], rtol=1e-5,
                               atol=1e-6)
    z = n(ts.params.xyz)[alive, 2]
    assert z.max() < (200.0 if mode == 31 else 300.0)
    assert (z < 4.5).sum() >= 3          # frame 0's near floaters stay
    assert merged[:, 2].max() > 200.0    # until the CLI's prune
    for split in ("train_cameras", "test_cameras"):
        _same_cameras(getattr(js.info, split), getattr(ts.info, split),
                      with_paths=False)
    assert {c.image_name for c in ts.info.test_cameras} == {"cam00"}
    assert len(ts.info.train_cameras) == (n3d.TOY_CAMS - 1) * n3d.TOY_FRAMES
    _same_cameras(js.info.val_cameras, ts.info.val_cameras)
    assert len(ts.info.val_cameras) == 300


def test_lpips_too_small_is_nan_as_in_jax():
    """An image too small for AlexNet's pooling (the toy's 32x24) has the
    JAX package's distance, NaN, where the port's pooling used to raise; a
    64x64 one the same number."""
    rng = np.random.RandomState(0)
    net = "alex"
    params = {k: jnp.asarray(v) for k, v in jlpips.init_random_weights(
        jax.random.PRNGKey(0), net).items()}
    for hw in ((24, 32), (64, 64)):
        x = rng.uniform(0, 1, (3,) + hw).astype(np.float32)
        y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(
            np.float32)
        theirs = float(jlpips.lpips_from_params(params, jnp.asarray(x),
                                                jnp.asarray(y), net))
        mine = float(tlpips.lpips(torch.as_tensor(x), torch.as_tensor(y),
                                  net))
        if hw == (64, 64):
            assert np.isfinite(mine) and mine == pytest.approx(theirs,
                                                               rel=1e-5)
        else:
            assert np.isnan(mine) and np.isnan(theirs)


@pytest.fixture(scope="module")
def runs(layout, tmp_path_factory):
    """``cli.train_main`` of both packages on their own copies of the
    layout, 8 iterations logged each, one intra-op thread for the port's
    plain compositors.  The port's trainer starts from the JAX Scene's
    initial state (carried by convert.py), and each of its densify passes
    takes the split draws the JAX pass made from its key (in the same
    order: the overflowing first attempt, then the pass on the grown
    capacity).  Records the alive masks both trainers start from, after
    the CLI's prune, and the JAX passes' counts."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("n3d_runs")
    cfg_path = str(tmp / "flame_toy.json")
    with open(cfg_path, "w") as f:
        json.dump(_config_dict(), f)
    rec = {"draws": [], "jax_passes": []}
    j_cls, t_cls = jtrainer.Trainer, ttrainer.Trainer
    densify = tdens.densify_pruneclone

    class JT(j_cls):
        def __init__(self, cfg, scene):
            rec["init"] = dict(
                params={k: n(v) for k, v in scene.params._asdict().items()},
                leaves=[n(x) for x in jax.tree_util.tree_leaves(scene.nets)],
                alive=n(scene.alive),
                fstatic={k: n(v) for k, v in scene.fstatic._asdict()
                         .items()})
            super().__init__(cfg, scene)

        def _densify(self, state, key, *, with_size_threshold):
            # densify_pruneclone's draws: normal(k1), normal(k2) of one
            # split of the pass's key
            rec["draws"].append([
                torch.tensor(n(jax.random.normal(
                    k, state.points.xyz.shape)))
                for k in jax.random.split(key)])
            st, res = super()._densify(
                state, key, with_size_threshold=with_size_threshold)
            rec["jax_passes"].append(
                [int(res.n_cloned), int(res.n_split), int(res.n_pruned),
                 bool(res.overflowed)])
            return st, res

        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            rec["jax_alive"] = n(self.state.alive)
            return super().run(max_iterations, 1, eval_fn)

    class TT(t_cls):
        def __init__(self, cfg, scene):
            init = rec["init"]
            scene.params, scene.nets, _ = convert.jax_to_torch(
                init["params"], init["leaves"], init["fstatic"],
                cfg.model_config(), device="cpu")
            scene.alive = torch.as_tensor(init["alive"].copy())
            super().__init__(cfg, scene)

        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            rec["torch_alive"] = n(self.state.alive)
            return super().run(max_iterations, 1, eval_fn)

    def with_jax_draws(params, mu, nu, alive, aux, samples, **kw):
        draws = rec["draws"][rec.setdefault("n_port_passes", 0)]
        rec["n_port_passes"] += 1
        assert draws[0].shape == samples[0].shape
        return densify(params, mu, nu, alive, aux, draws, **kw)

    jtrainer.Trainer, ttrainer.Trainer = JT, TT
    tdens.densify_pruneclone = with_jax_draws
    try:
        jtr = jcli.train_main(["-s", _copy(layout, tmp / "a"), "--config",
                               cfg_path, "-m", str(tmp / "jax")])
        ttr = tcli.train_main(["-s", _copy(layout, tmp / "b"), "--config",
                               cfg_path, "-m", str(tmp / "torch"),
                               "--device", "cpu"])
    finally:
        jtrainer.Trainer, ttrainer.Trainer = j_cls, t_cls
        tdens.densify_pruneclone = densify
        torch.set_num_threads(threads)
    yield dict(rec=rec, jtr=jtr, ttr=ttr, tmp=tmp)


def test_cli_zprune_matches_jax(runs):
    """The CLI's initial z < 4.5 prune (densify modes 1, 2 and 4) leaves
    the same alive mask in both packages: the JAX Scene's initial mask
    without the rows whose z is below 4.5, the frame-0 floaters among
    them."""
    rec = runs["rec"]
    init = rec["init"]
    expect = (init["alive"] > 0) & ~(init["params"]["xyz"][:, 2] < 4.5)
    np.testing.assert_array_equal(rec["jax_alive"], rec["torch_alive"])
    np.testing.assert_array_equal(rec["torch_alive"] > 0, expect)
    assert (init["alive"] > 0).sum() - expect.sum() >= 3


def _journal(path):
    """(iteration, note, points) of each exp_log.txt record."""
    with open(os.path.join(path, "exp_log.txt")) as f:
        lines = f.read().split("\n")
    return [(int(a.split()[-1]),) + tuple(b.rsplit(" pointsnumber ", 1))
            for a, b in zip(lines[::2], lines[1::2])]


def test_mode2_trainer_matches_jax(runs):
    """Densify mode 2 with prune_z (the loader is colmap), every iteration
    dynamic, on a black background: with the split draws shared, every
    logged loss within 1e-5 relative of the JAX run's and the live points
    equal at every iteration; both passes' clone, split and prune counts
    equal (clones, splits and z prunes all nonzero), the first one
    overflowing its 512 slots and growing them to 1,024 in both; the
    journals and the eval at 8 equal."""
    rec, jtr, ttr = runs["rec"], runs["jtr"], runs["ttr"]
    cfg = ttr.cfg
    assert cfg.densify == 2 and cfg.loader == "colmap"
    assert not cfg.white_background and float(ttr.bg.abs().sum()) == 0.0
    jh, th = jtr.history, ttr.history
    assert [h["it"] for h in jh] == [h["it"] for h in th] == list(
        range(1, ITERS + 1))
    assert all(h["stage"] == "dynamatic" for h in jh + th)
    assert not any("bad_step" in h for h in jh + th)
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=1e-5)
    assert [h["points"] for h in th] == [h["points"] for h in jh]
    # the JAX passes, the overflowing attempt included, against the port's
    # log (one record a pass, the grown attempt's counts)
    jp = rec["jax_passes"]
    assert rec["n_port_passes"] == len(jp) == 3 and jp[0][3] and not jp[1][3]
    got = [[d["cloned"], d["split"], d["pruned"]] for d in ttr.densify_log]
    assert got == [p[:3] for p in jp[1:]]
    assert [d["it"] for d in ttr.densify_log] == [3, 6]
    assert [d["grew"] for d in ttr.densify_log] == [True, False]
    assert ttr.state.alive.shape[0] == int(jtr.state.alive.shape[0]) == 1024
    print("passes (cloned, split, pruned):", got)
    assert all(max(c) > 0 for c in zip(*got))
    for d in ttr.densify_log:
        assert d["after"] == d["before"] + d["cloned"] + d["split"] \
            - d["pruned"], d
    tj, jj = _journal(runs["tmp"] / "torch"), _journal(runs["tmp"] / "jax")
    assert tj == jj and len(tj) == 5
    reports = []
    for pkg in ("jax", "torch"):
        with open(runs["tmp"] / pkg / f"{ITERS}_runtimeresults.json") as f:
            reports.append(json.load(f))
    for k in ("PSNR", "SSIM", "MS-SSIM", "L1"):
        assert reports[1][k] == pytest.approx(reports[0][k], rel=1e-5), k


def _port_state(d, jtr):
    """convert.py's dict of a JAX state -> the port's TrainState."""
    fstatic = {k: n(v) for k, v in jtr.scene.fstatic._asdict().items()}
    state, _ = convert.train_state_from_numpy(
        dict(d, fstatic=fstatic), jtr.cfg.model_config(), device="cpu")
    return state


def test_grow_state_matches_jax(runs):
    """The JAX trainer's grow_capacity and the port's grow_state on one
    state (the JAX run's last): every per-Gaussian tensor, both Adam
    moments, the statistics and the LR scalings padded alike, the nets
    and their moments untouched."""
    jtr = runs["jtr"]
    before = jtr.state
    mine = convert.train_state_to_numpy(
        ttrainer.grow_state(_port_state(_jax_state_np(before), jtr)))
    try:
        jtr.grow_capacity()
        theirs = _jax_state_np(jtr.state)
    finally:
        jtr.state = before
    assert theirs["alive"].shape[0] == 2 * before.alive.shape[0]
    for key in theirs:
        a, b = theirs[key], mine[key]
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], f"{key}.{k}")
        elif isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, key)
        else:
            np.testing.assert_array_equal(a, b, key)


def test_zprune_real_xyz_matches_jax(runs):
    """_zprune_real_xyz on one state in both packages: the JAX run's last
    state with random planes (so the motion head moves each point its own
    way) and 40% of the live points placed so that their base-time
    position (xyz plus the motion head at a zero time embedding) lies
    within 1e-4 to 5e-2 of z = 4.5 on either side (by the motion head at
    their old positions).  The alive masks are equal, equal to a recount
    of deform(..., 0.0).real_xyz[:, 2] < 4.5, cut between 20% and 80% of
    the moved points, and differ from a prune of xyz alone."""
    jtr, ttr = runs["jtr"], runs["ttr"]
    rng = np.random.RandomState(5)
    d = _jax_state_np(jtr.state)
    d["points"] = {k: np.array(v) for k, v in d["points"].items()}
    d["net_leaves"] = list(d["net_leaves"])
    for i in range(6):                                  # the planes
        d["net_leaves"][i] = rng.normal(0, 0.3, d["net_leaves"][i].shape
                                        ).astype(np.float32)
    state = _port_state(d, jtr)
    with torch.no_grad():
        real = tgm.deform(state.points, state.nets, ttr.mcfg,
                          ttr.scene.fstatic, 0.0,
                          with_residuals=True).real_xyz
    motion = n(real[:, 2]) - d["points"]["xyz"][:, 2]
    live = np.flatnonzero(d["alive"] > 0)
    moved = rng.choice(live, int(0.4 * live.size), replace=False)
    offset = rng.uniform(1e-4, 5e-2, moved.size) * rng.choice([-1, 1],
                                                               moved.size)
    d["points"]["xyz"][moved, 2] = (4.5 - motion[moved] + offset).astype(
        np.float32)
    state = _port_state(d, jtr)
    jstate = jtr.state._replace(
        points=jtr.state.points._replace(xyz=jnp.asarray(d["points"]["xyz"])),
        nets=jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jtr.state.nets),
            [jnp.asarray(x) for x in d["net_leaves"]]))
    theirs = n(jtr._zprune_real_xyz(jstate).alive)
    saved = ttr.state
    try:
        ttr.state = state
        ttr._zprune_real_xyz()
        mine = n(ttr.state.alive)
    finally:
        ttr.state = saved
    np.testing.assert_array_equal(mine, theirs)
    # the recount: the motion head at the moved positions
    with torch.no_grad():
        real_z = n(tgm.deform(state.points, state.nets, ttr.mcfg,
                              ttr.scene.fstatic, 0.0,
                              with_residuals=True).real_xyz[:, 2])
    np.testing.assert_array_equal(mine, np.where(real_z < 4.5, 0.0,
                                                 d["alive"]))
    cut = (d["alive"][moved] > 0) & (mine[moved] == 0)
    assert 0.2 < cut.mean() < 0.8
    xyz_only = np.where(d["points"]["xyz"][:, 2] < 4.5, 0.0, d["alive"])
    assert not np.array_equal(mine, xyz_only)
    assert np.abs(motion[live]).max() > 0.05


# the schedule of _density_control: passes at 200, 300 and 400 (the first
# one overflowing), opacity resets at 200 and 400, the dynamic stage from
# 601, so that the base-time z prune runs at 1,001 and 1,501 and not at 501
SCHEDULE = dict(densify=2, densify_from_iter=100, densification_interval=100,
                densify_until_iter=450, opacity_reset_interval=200,
                static_iteration=600)


def _stub_moves(tr, calls, monkeypatch, jax_pkg):
    """Every move of ``tr``'s density control replaced by a record of the
    call; the first densify attempt reports an overflow."""
    it = {"now": 0}

    def note(name, **kw):
        calls.append((it["now"], name) + tuple(sorted(kw.items())))
    monkeypatch.setattr(tr, "scene", types.SimpleNamespace(
        record_points=lambda i, msg, pts: note("record", msg=msg)))
    monkeypatch.setattr(tr, "grow_capacity", lambda *a: note("grow"))
    res = types.SimpleNamespace(overflowed=False)
    first = {"left": 1}

    def overflowed():
        over, first["left"] = first["left"] > 0, 0
        return over
    if jax_pkg:
        def densify(state, key, *, with_size_threshold):
            note("densify", size=with_size_threshold)
            return state, types.SimpleNamespace(overflowed=overflowed())
        monkeypatch.setattr(tr, "_densify", densify)
        monkeypatch.setattr(tr, "_reset_opacity",
                            lambda s: note("reset") or s)
        monkeypatch.setattr(tr, "_zprune_real_xyz",
                            lambda s: note("zprune") or s)
    else:
        monkeypatch.setattr(tr, "_densify", lambda size: note(
            "densify", size=size) or res)
        monkeypatch.setattr(tr, "_densify_counts", lambda r: dict(
            overflowed=overflowed(), cloned=0, split=0, pruned=0))
        monkeypatch.setattr(tr, "_apply_densify", lambda r: None)
        monkeypatch.setattr(tr, "_reset_opacity", lambda: note("reset"))
        monkeypatch.setattr(tr, "_zprune_real_xyz", lambda: note("zprune"))
    monkeypatch.setattr(tr, "cfg", dataclasses.replace(tr.cfg, **SCHEDULE))
    return it


def test_density_control_schedule_matches_jax(runs, monkeypatch):
    """_density_control of both trainers over iterations 1 to 1,502 with
    the moves stubbed: the same calls at the same iterations.  Passes
    below densify_until_iter (the screen-size prune after the first
    reset), the overflowing first one followed by a growth and a second
    attempt, the resets, and the base-time z prune at it % 500 == 1 after
    densify_until_iter in the dynamic stage only: at 1,001 and 1,501, not
    at 501."""
    calls = {}
    for name in ("jtr", "ttr"):
        tr = runs[name]
        calls[name] = []
        it = _stub_moves(tr, calls[name], monkeypatch, name == "jtr")
        for i in range(1, 1503):
            it["now"] = i
            tr._density_control(i, tr.stage_at(i))
    assert calls["jtr"] == calls["ttr"]
    by = {}
    for c in calls["ttr"]:
        by.setdefault(c[1], []).append(c[0])
    assert by["zprune"] == [1001, 1501]
    assert by["reset"] == [200, 400]
    assert by["densify"] == [200, 200, 300, 400]
    assert by["grow"] == [200]
    sizes = [dict(c[2:])["size"] for c in calls["ttr"] if c[1] == "densify"]
    assert sizes == [False, False, True, True]


def test_test_main_val_renders_match_jax(runs, monkeypatch):
    """``cli.test_main`` of the port on its checkpoint at 8: the test set
    (6 views of cam00, LPIPS NaN at 32x24 as in the JAX package), then the
    300 spiral val views written as renders, within 1e-4 (the render
    tolerance of tests/test_torch_trainer.py) of the JAX package's
    Evaluator.render_set("val", ...) on the same checkpoint, the same
    frames non-empty in both."""
    tmp = runs["tmp"]
    model = str(tmp / "torch")
    twin = str(tmp / "jax_eval")
    shutil.copytree(model, twin)
    shots = {"torch": {}, "jax": {}}

    def capture(pkg, save):
        def save_png(path, img):
            if f"{os.sep}val{os.sep}" in path and f"{os.sep}renders" in path:
                shots[pkg][os.path.basename(path)] = np.array(img)
            return save(path, img)
        return save_png
    monkeypatch.setattr(teval, "save_png", capture("torch", teval.save_png))
    monkeypatch.setattr(jeval, "save_png", capture("jax", jeval.save_png))

    def jax_val():
        jcfg = jconfig.load_cfg_args(os.path.join(twin, "cfg_args.json"))
        jcfg.model_path = twin
        jsc = jscene.Scene(jcfg, load_iteration=str(ITERS))
        jeval.Evaluator(jcfg, jsc).render_set(
            "val", jsc.val_cameras(), jsc.params, jsc.nets, jsc.alive,
            iteration=str(ITERS), measure_fps=False, has_gt=False)

    # the two packages share nothing: the JAX one goes in a thread
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            job = pool.submit(jax_val)
            res = tcli.test_main(["-m", model, "--iteration", str(ITERS),
                                  "--device", "cpu"])
            job.result()
    finally:
        torch.set_num_threads(threads)
    assert res["num_views"] == n3d.TOY_FRAMES and np.isfinite(res["PSNR"])
    assert np.isnan(res["LPIPS-alex"])
    val_dir = os.path.join(model, "val", f"ours_{ITERS}", "renders")
    assert len(os.listdir(val_dir)) == 300
    assert sorted(shots["torch"]) == sorted(shots["jax"])
    assert len(shots["torch"]) == 300
    mine = np.stack([shots["torch"][k] for k in sorted(shots["torch"])])
    theirs = np.stack([shots["jax"][k] for k in sorted(shots["jax"])])
    np.testing.assert_allclose(mine, theirs, atol=1e-4, rtol=0)
    lit = (theirs.max(axis=(1, 2, 3)) > 0.05)
    assert lit.sum() >= 150, lit.sum()
