"""The HyperNeRF reader and trainer on a vrig capture's layout, both
packages, on the CPU.

``tests/torch_hypernerf_scene.py``'s ``TOY`` layout: 6 time steps taken
by two rig cameras (``left_<t>`` for training, ``right_<t>`` for
validation, 0.1 apart), portrait frames of 144x256 at 1x written at 2x
(72x128), renders of ``synth.build_gt(7)``'s subsampled scene on black,
and a ``points.npy`` of 500 points.  Both ``read_hypernerf_scene`` read
their own copy at resolution 2 and are held to each other and to a numpy
recount from the JSON files.

Then both CLIs warm-start from one checkpoint that the port writes from
its Scene's initial state and train 4 iterations at batch 2 (toy widths:
planes 16^3 x 8 of 8 channels, capacity 512, the pure-JAX tiling with
every tile's instances walked, 32,768 instance slots, no presize), then
``cli test`` of the checkpoint at 4: the losses and the metrics within
1e-5 relative.
"""
import concurrent.futures
import json
import os
import shutil

import numpy as np
import pytest
import torch

from saro_gs_torch import cli as tcli
from saro_gs_torch import config as tconfig
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import hypernerf as thyper
from saro_gs_torch.train import trainer as ttrainer
from saro_gs_tpu import cli as jcli
from saro_gs_tpu.data import hypernerf as jhyper
from saro_gs_tpu.train import trainer as jtrainer
from tests import torch_hypernerf_scene as vrig
from tests.torch_parity import n

TOY = vrig.TOY
CONFIG = dict(
    loader="hypernerf", resolution=2, preprocesspoints=0, batch=2,
    iterations=4, test_iteration=4, capacity=512, raster_backend="jax",
    max_slots=512, presize_instances=False, max_instances=1 << 15,
    duration=TOY["steps"], white_background=False,
    kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                    "output_coordinate_dim": 8,
                    "resolution": [16, 16, 16, 8]})
RTOL = 1e-5
METRICS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS-alex")


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The toy layout, written once (rendered on the CPU, one intra-op
    thread); a reader reads a copy of its own."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = str(tmp_path_factory.mktemp("vrig") / "scene")
        vrig.toy_scene(root)
    finally:
        torch.set_num_threads(threads)
    return root


@pytest.fixture(scope="module")
def infos(layout, tmp_path_factory):
    """Both packages' SceneInfo of their own copy, and the recount."""
    tmp = tmp_path_factory.mktemp("vrig_read")
    roots = {k: str(shutil.copytree(layout, tmp / k))
             for k in ("jax", "torch")}
    return dict(jax=jhyper.read_hypernerf_scene(roots["jax"], resolution=2),
                torch=thyper.read_hypernerf_scene(roots["torch"],
                                                  resolution=2),
                recount=vrig.recount_cameras(layout), root=layout)


def _splits(info):
    return {"train": info.train_cameras, "test": info.test_cameras}


def test_splits_follow_camera_id(infos):
    """Training takes every left camera (camera_id 0), in time order, and
    validation every right one (camera_id 1), in both packages."""
    steps = TOY["steps"]
    names = {"train": [vrig.image_id("left", t) for t in range(steps)],
             "test": [vrig.image_id("right", t) for t in range(steps)]}
    with open(os.path.join(infos["root"], "metadata.json")) as f:
        meta = json.load(f)
    for pkg in ("jax", "torch"):
        for split, cams in _splits(infos[pkg]).items():
            assert [c.image_name for c in cams] == names[split], (pkg, split)
            assert {meta[c.image_name]["camera_id"] for c in cams} == {
                0 if split == "train" else 1}
    assert [c["id"] for c in infos["recount"]["train"]] == names["train"]
    assert [c["id"] for c in infos["recount"]["test"]] == names["test"]


def test_cameras_match_jax_and_recount(infos):
    """R, T, fovx and fovy of every camera within 1e-6 of the JAX
    package's and of the numpy recount from the JSON files; the centres
    the JSON positions."""
    for split, cams in _splits(infos["torch"]).items():
        theirs = _splits(infos["jax"])[split]
        for mine, jc, rc in zip(cams, theirs, infos["recount"][split]):
            for k in ("R", "T"):
                np.testing.assert_allclose(getattr(mine, k), getattr(jc, k),
                                           rtol=0, atol=1e-6)
                np.testing.assert_allclose(getattr(mine, k), rc[k], rtol=0,
                                           atol=1e-6)
            for k in ("fovx", "fovy"):
                assert abs(getattr(mine, k) - getattr(jc, k)) <= 1e-6
                assert abs(getattr(mine, k) - rc[k]) <= 1e-6
            np.testing.assert_allclose(mine.camera_center, rc["centre"],
                                       rtol=0, atol=1e-5)


def test_portrait_sizes_and_shared_timestamps(infos):
    """Every view is portrait at the 2x size (72x128), both packages, and
    the two rig cameras of a time step share its timestamp t / 5."""
    w, h = TOY["width"] // 2, TOY["height"] // 2
    assert h > w
    for pkg in ("jax", "torch"):
        train, test = infos[pkg].train_cameras, infos[pkg].test_cameras
        assert {(c.width, c.height) for c in train + test} == {(w, h)}
        assert [c.timestamp for c in train] == [c.timestamp for c in test] \
            == [t / (TOY["steps"] - 1) for t in range(TOY["steps"])]
    assert [c["timestamp"] for c in infos["recount"]["test"]] == [
        c.timestamp for c in infos["torch"].test_cameras]


def test_init_cloud_from_points_npy(infos):
    """Both readers make the init cloud from points.npy: its 500 points
    (as float32), time 0.5, grey, equal to each other and to the
    recount."""
    pts, cols, times = vrig.recount_init_cloud(infos["root"])
    assert pts.shape == (TOY["points"], 3)
    for pkg in ("jax", "torch"):
        pc = infos[pkg].point_cloud
        np.testing.assert_array_equal(pc.points, pts)
        np.testing.assert_array_equal(pc.colors, cols)
        np.testing.assert_array_equal(pc.times, times)


@pytest.fixture(scope="module")
def runs(layout, tmp_path_factory):
    """The checkpoint, both CLIs' warm-started runs (the JAX one in a
    thread) and both ``cli test`` reports."""
    tmp = tmp_path_factory.mktemp("vrig_train")
    roots = {k: str(shutil.copytree(layout, tmp / f"scene_{k}"))
             for k in ("jax", "torch", "ckpt")}
    cfg_path = str(tmp / "vrig_toy.json")
    with open(cfg_path, "w") as f:
        json.dump(CONFIG, f)
    sc = tscene.Scene(tconfig.load_config(
        cfg_path, source_path=roots["ckpt"], model_path=str(tmp / "ckpt")),
        device="cpu")
    ckpt = sc.save(0, sc.params, sc.nets, sc.alive)
    j_cls, t_cls = jtrainer.Trainer, ttrainer.Trainer

    # every iteration logged
    class JT(j_cls):
        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            return super().run(max_iterations, 1, eval_fn)

    class TT(t_cls):
        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            return super().run(max_iterations, 1, eval_fn)
    models = {k: str(tmp / f"model_{k}") for k in ("jax", "torch")}
    args = {k: ["-s", roots[k], "--config", cfg_path, "-m", models[k],
                "--start_checkpoint", ckpt] for k in models}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jtrainer.Trainer, ttrainer.Trainer = JT, TT
    try:
        # the two runs share nothing: the JAX one goes in a thread
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            job = pool.submit(jcli.train_main, args["jax"])
            ttr = tcli.train_main(args["torch"] + ["--device", "cpu"])
            jtr = job.result()
            job = pool.submit(jcli.test_main, ["-m", models["jax"],
                                               "--iteration", "4"])
            tres = tcli.test_main(["-m", models["torch"], "--iteration",
                                   "4", "--device", "cpu"])
            jres = job.result()
    finally:
        jtrainer.Trainer, ttrainer.Trainer = j_cls, t_cls
        torch.set_num_threads(threads)
    return dict(jtr=jtr, ttr=ttr, jres=jres, tres=tres,
                n_points=int((sc.alive > 0).sum()))


def test_vrig_training_matches_jax(runs):
    """4 iterations at batch 2 from the same checkpoint (its 500 points
    in 512 rows): the losses within 1e-5 relative, no bad step, nothing
    dropped, the same points alive at the end."""
    jh, th = runs["jtr"].history, runs["ttr"].history
    assert runs["n_points"] == TOY["points"]
    assert [h["it"] for h in jh] == [h["it"] for h in th] == [1, 2, 3, 4]
    assert not any("bad_step" in h for h in jh + th)
    assert runs["ttr"].state.dropped_hwm == 0
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=RTOL)
    np.testing.assert_array_equal(n(runs["ttr"].state.alive),
                                  n(runs["jtr"].state.alive))


def test_vrig_test_metrics_match_jax(runs):
    """``cli test`` of the checkpoint at 4 on the 6 right-camera views:
    PSNR, SSIM, MS-SSIM and LPIPS-alex (the seed-0 fixture in both) within
    1e-5 relative of the JAX package's."""
    jres, tres = runs["jres"], runs["tres"]
    assert tres["num_views"] == jres["num_views"] == TOY["steps"]
    assert tres["LPIPS-weights"] == jres["LPIPS-weights"]
    for k in METRICS:
        assert np.isfinite(tres[k]), k
        assert tres[k] == pytest.approx(jres[k], rel=RTOL), k
