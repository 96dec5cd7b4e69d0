"""The HyperNeRF trainer through both packages' CLIs, on the CPU.

The fabricated HyperNeRF layout of tests/test_aux_data.py
(``TestHyperNerf._make_scene``: 6 frames of 320x240 in rgb/2x, 4 for
training and 2 for validation, cameras on a circle of radius 4) with a
``points.npy`` cloud of 300 points, read by the ``hypernerf`` reader at
resolution 2.  The config is written here (no HyperNeRF config is in
configs/): toy widths (planes 16^3 x 8 of 8 channels), capacity 512, the
pure-JAX tiling with every tile's instances walked, 16,384 instance slots
(no presize), 4 iterations at batch 1 with an eval at 4 (the default
densify mode 0: no density control).

Both CLIs warm-start from one checkpoint that the port writes from its
Scene's initial state (``--start_checkpoint``, the schedules from 0), run
in turns beside each other, then ``cli test`` of the checkpoint at 4.
Held: the state both trainers start from, the losses (1e-5 relative), the
eval during training and the test metrics (1e-5 relative).
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
from saro_gs_torch.train import trainer as ttrainer
from saro_gs_tpu import cli as jcli
from saro_gs_tpu.train import trainer as jtrainer
from tests import test_aux_data as jaux
from tests.torch_parity import n

CONFIG = dict(
    loader="hypernerf", resolution=2, preprocesspoints=0, batch=1,
    iterations=4, test_iteration=4, capacity=512, raster_backend="jax",
    max_slots=320, presize_instances=False, max_instances=1 << 14,
    duration=6,
    kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                    "output_coordinate_dim": 8,
                    "resolution": [16, 16, 16, 8]})
RTOL = 1e-5
METRICS = ("PSNR", "SSIM", "MS-SSIM", "LPIPS-alex")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The layout, the checkpoint, both CLIs' warm-started runs (the JAX
    one in a thread) and both ``cli test`` reports."""
    tmp = tmp_path_factory.mktemp("hypernerf")
    rng = np.random.RandomState(3)
    jaux.TestHyperNerf()._make_scene(tmp / "scene", rng)
    np.save(tmp / "scene" / "points.npy", rng.randn(300, 3))
    roots = {k: str(shutil.copytree(tmp / "scene", tmp / f"scene_{k}"))
             for k in ("jax", "torch")}
    cfg_path = str(tmp / "hypernerf_toy.json")
    with open(cfg_path, "w") as f:
        json.dump(CONFIG, f)
    sc = tscene.Scene(tconfig.load_config(
        cfg_path, source_path=str(tmp / "scene"),
        model_path=str(tmp / "ckpt")), device="cpu")
    ckpt = sc.save(0, sc.params, sc.nets, sc.alive)
    starts = {}
    j_cls, t_cls = jtrainer.Trainer, ttrainer.Trainer

    class JT(j_cls):
        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            starts["jax"] = {k: n(v) for k, v in self.state.points._asdict()
                             .items()}, n(self.state.alive)
            return super().run(max_iterations, 1, eval_fn)

    class TT(t_cls):
        def run(self, max_iterations=None, log_every=50, eval_fn=None):
            starts["torch"] = {k: n(v) for k, v in self.state.points._asdict()
                               .items()}, n(self.state.alive)
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
            # cli test writes its report over the training eval's
            evals = []
            for pkg in ("jax", "torch"):
                with open(os.path.join(models[pkg],
                                       "4_runtimeresults.json")) as f:
                    evals.append(json.load(f))
            job = pool.submit(jcli.test_main, ["-m", models["jax"],
                                               "--iteration", "4"])
            tres = tcli.test_main(["-m", models["torch"], "--iteration",
                                   "4", "--device", "cpu"])
            jres = job.result()
    finally:
        jtrainer.Trainer, ttrainer.Trainer = j_cls, t_cls
        torch.set_num_threads(threads)
    return dict(jtr=jtr, ttr=ttr, jres=jres, tres=tres, evals=evals,
                starts=starts, models=models,
                n_points=int((sc.alive > 0).sum()))


def test_warm_start_state_matches_jax(runs):
    """Both trainers start from the checkpoint: its 300 points alive in
    the config's 512 rows, every parameter equal."""
    (jp, ja), (tp, ta) = runs["starts"]["jax"], runs["starts"]["torch"]
    assert runs["n_points"] == 300
    np.testing.assert_array_equal(ja, ta)
    assert ta.shape == (512,) and int(ta.sum()) == 300
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)


def test_hypernerf_training_matches_jax(runs):
    """The 4 iterations' losses within 1e-5 relative, no bad step and
    nothing dropped, and the eval at 4 on the 2 validation views within
    1e-5."""
    jh, th = runs["jtr"].history, runs["ttr"].history
    assert [h["it"] for h in jh] == [h["it"] for h in th] == [1, 2, 3, 4]
    assert not any("bad_step" in h for h in jh + th)
    assert runs["ttr"].state.dropped_hwm == 0
    np.testing.assert_allclose([h["loss"] for h in th],
                               [h["loss"] for h in jh], rtol=RTOL)
    jev, tev = runs["evals"]
    assert jev["iteration"] == tev["iteration"] == 4
    for k in ("PSNR", "SSIM", "MS-SSIM", "L1"):
        assert tev[k] == pytest.approx(jev[k], rel=RTOL), k


def test_hypernerf_test_metrics_match_jax(runs):
    """``cli test`` of the checkpoint at 4: the 2 validation views' PSNR,
    SSIM, MS-SSIM and LPIPS-alex (the seed-0 fixture in both) within 1e-5
    relative of the JAX package's."""
    jres, tres = runs["jres"], runs["tres"]
    assert tres["num_views"] == jres["num_views"] == 2
    assert tres["LPIPS-weights"] == jres["LPIPS-weights"]
    for k in METRICS:
        assert np.isfinite(tres[k]), k
        assert tres[k] == pytest.approx(jres[k], rel=RTOL), k
