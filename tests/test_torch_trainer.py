"""The port's Scene, Trainer, eval and CLI against the JAX package's, on the
toy end-to-end run of tests/test_e2e_train.py (40x32 Blender scene, the
same config, the same 400-point reader, 120 iterations), on the CPU.

Both trainers start from the JAX Scene's initial params and nets (carried
by convert.py) and take the same batches (one RandomState shuffle).  The
port's run is held to the JAX run's first 20 static iterations and to the
golden trajectory of the JAX test; checkpoints cross between the packages
both ways; the CLI runs on the CPU.
"""
import concurrent.futures
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import cli as tcli
from saro_gs_torch import config as tconfig
from saro_gs_torch import convert
from saro_gs_torch import eval as teval
from saro_gs_torch import render as trender
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import readers as treaders
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.train import lpips as tlpips
from saro_gs_torch.train.trainer import Trainer as TTrainer
from saro_gs_tpu import config as jconfig
from saro_gs_tpu import render as jrender
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.data import readers as jreaders
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.train.trainer import Trainer as JTrainer
from tests.test_e2e_train import DURATION, _write_scene
from tests.torch_parity import n

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "toy_trajectory.json")
LOADER = "toy400"
# tests/test_e2e_train.py:test_train_loop_converges, loader aside
CFG = dict(
    loader=LOADER, duration=DURATION, resolution=1,
    batch=2, iterations=120, static_iteration=20,
    densify=5, densify_from_iter=30, densify_until_iter=100,
    densification_interval=40, opacity_reset_interval=1000,
    preprocesspoints=0, capacity=2048,
    raster_backend="jax", max_instances=16384, max_slots=512,
    kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                    "output_coordinate_dim": 8,
                    "resolution": [16, 16, 16, 8]},
    multires=[1], sh_degree=1, dsh=True, scale_reg=True,
    lambda_dscale_reg=8e-6, min_intergral=1e-4, min_interval=0.5,
    position_lr_max_steps=120, mlp_lr=1.6e-3)
N_STATIC = 20


def _small_reader(read, point_cloud, n=400):
    """``read`` with the init cloud cut to ``n`` points (the JAX test
    takes 400), RandomState(0)'s choice."""
    def reader(*a, **k):
        info = read(*a, **k)
        pc = info.point_cloud
        sel = np.random.RandomState(0).choice(pc.points.shape[0], n,
                                              replace=False)
        return info._replace(point_cloud=point_cloud(
            points=pc.points[sel], colors=pc.colors[sel],
            times=pc.times[sel]))
    return reader


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """Both trainers from one initial state: JAX for the first 20
    iterations, the port for 120 (one intra-op thread: the plain
    compositors run thousands of tiny ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("toy_blender"))
    _write_scene(root, np.random.RandomState(7))
    out = tmp_path_factory.mktemp("models")
    jreaders.SCENE_READERS[LOADER] = _small_reader(
        jreaders.read_blender_scene, jgm.PointCloud)
    treaders.SCENE_READERS[LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud)
    try:
        jcfg = jconfig.load_config(source_path=root,
                                   model_path=str(out / "jax"), **CFG)
        jsc = jscene.Scene(jcfg)
        init = dict(params={k: n(v) for k, v in jsc.params._asdict().items()},
                    leaves=[n(x) for x in jax.tree_util.tree_leaves(
                        jsc.nets)],
                    alive=n(jsc.alive),
                    fstatic={k: n(v) for k, v in jsc.fstatic._asdict()
                             .items()})
        jtr = JTrainer(jcfg, jsc)

        tcfg = tconfig.load_config(source_path=root,
                                   model_path=str(out / "torch"), **CFG)
        tsc = tscene.Scene(tcfg, device="cpu")
        for k, v in init["fstatic"].items():
            assert np.array_equal(n(getattr(tsc.fstatic, k)), v), k
        assert tsc.cameras_extent == jsc.cameras_extent
        tsc.params, tsc.nets, _ = convert.jax_to_torch(
            init["params"], init["leaves"], init["fstatic"],
            tcfg.model_config(), device="cpu")
        tsc.alive = torch.as_tensor(init["alive"].copy())
        ttr = TTrainer(tcfg, tsc)
        assert ttr.rcfg == tcfg.raster_config()._replace(
            max_instances=int(jtr.rcfg.max_instances))
        # the two runs share nothing: the JAX one goes in a thread
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_run = pool.submit(jtr.run, max_iterations=N_STATIC,
                                  log_every=1)
            ttr.run(max_iterations=tcfg.iterations, log_every=1)
            jax_run.result()
        yield dict(root=root, out=out, jcfg=jcfg, jsc=jsc, jtr=jtr,
                   tcfg=tcfg, tsc=tsc, ttr=ttr)
    finally:
        torch.set_num_threads(threads)
        jreaders.SCENE_READERS.pop(LOADER, None)
        treaders.SCENE_READERS.pop(LOADER, None)


def test_static_iterations_match_jax(toy):
    """(a) From one state, the first 20 (static) iterations' losses agree
    within 1e-3 relative."""
    jl = [h["loss"] for h in toy["jtr"].history]
    tl = [h["loss"] for h in toy["ttr"].history[:N_STATIC]]
    assert [h["it"] for h in toy["jtr"].history] == list(
        range(1, N_STATIC + 1))
    assert all(h["stage"] == "static" for h in toy["ttr"].history[:N_STATIC])
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_trajectory_meets_golden(toy):
    """(b) The 120-iteration history against tests/golden/toy_trajectory.json
    with the JAX test's bounds; densify ran twice and each pass's count
    adds up."""
    tr, sc = toy["ttr"], toy["tsc"]
    hist = {h["it"]: h for h in tr.history}
    assert len(tr.history) == 120
    assert hist[120]["loss"] < hist[1]["loss"] * 0.7
    assert tr.state.bad_steps == 0 and not tr.overflows
    psnr = teval.quick_test_psnr(tr, sc.test_cameras())
    with open(GOLDEN) as f:
        golden = json.load(f)
    for it, g in golden.items():
        if it == "test_psnr":
            assert psnr > g - 1.5, (psnr, g)
            continue
        h = hist[int(it)]
        assert h["loss"] < g["loss"] * 1.3, (it, h, g)
        assert h["psnr"] > g["psnr"] - 1.5, (it, h, g)
    assert [d["it"] for d in tr.densify_log] == [40, 80]
    for d in tr.densify_log:
        assert d["after"] == d["before"] + d["cloned"] + d["split"] \
            - d["pruned"], d
    with open(os.path.join(sc.model_path, "exp_log.txt")) as f:
        assert f.read().count("densify pointsnumber") == 4


def _jax_render(cfg, cam, params, nets, alive, fstatic):
    """The JAX package's eval render (backend "jax"), jitted once for the
    test's shapes."""
    mcfg = cfg.model_config()
    tcam = cam.raster_params(device="cpu")
    jcam = JCameraParams(*[jnp.asarray(n(x)) for x in tcam])
    key = (cam.width, cam.height)
    if key not in _JAX_RENDERS:
        def fn(jcam, ts, params, nets, alive, fstatic):
            out, _ = jrender.test_render(
                jcam, ts, params, nets, alive, mcfg, fstatic, jnp.zeros(3),
                width=cam.width, height=cam.height,
                sh_degree=mcfg.sh_degree, rcfg=cfg.raster_config())
            return out.color
        _JAX_RENDERS[key] = jax.jit(fn)
    return n(_JAX_RENDERS[key](jcam, jnp.float32(cam.timestamp), params,
                               nets, alive, fstatic))


_JAX_RENDERS = {}


def _torch_render(cfg, cam, params, nets, alive, fstatic):
    mcfg = cfg.model_config()
    out, _ = trender.test_render(
        cam.raster_params(device="cpu"), cam.timestamp, params, nets, alive,
        mcfg, fstatic, torch.zeros(3), width=cam.width, height=cam.height,
        sh_degree=mcfg.sh_degree, rcfg=cfg.raster_config())
    return n(out.color)


def test_checkpoints_cross_packages(toy):
    """(c) A checkpoint the port saves loads through the JAX package's
    loader and renders (backend="jax") within 1e-4 of the port's render of
    the state it saved; and a JAX checkpoint through the port's."""
    tcfg, tsc, ttr = toy["tcfg"], toy["tsc"], toy["ttr"]
    jcfg, jsc, jtr = toy["jcfg"], toy["jsc"], toy["jtr"]
    cam = tsc.test_cameras()[1]
    st = ttr.state
    path = tsc.save("port", st.points, st.nets, st.alive)
    # padded to the JAX state's capacity: one compile serves both renders
    params, nets, alive, fstatic, npts = jscene.load_gaussian_checkpoint(
        path, jsc.nets, capacity=int(jtr.state.alive.shape[0]))
    assert npts == ttr.n_alive()
    mine = _torch_render(tcfg, cam, st.points, st.nets, st.alive,
                         tsc.fstatic)
    theirs = _jax_render(jcfg, cam, params, nets, alive, fstatic)
    assert np.abs(mine).max() > 0.1
    np.testing.assert_allclose(theirs, mine, atol=1e-4, rtol=0)

    js = jtr.state
    path = jsc.save("jax", js.points, js.nets, js.alive)
    params, nets, alive, fstatic, npts = tscene.load_gaussian_checkpoint(
        path, tcfg.model_config(), device="cpu")
    assert npts == int(np.asarray(js.alive).sum())
    theirs = _jax_render(jcfg, cam, js.points, js.nets, js.alive,
                         jsc.fstatic)
    mine = _torch_render(tcfg, cam, params, nets, alive, fstatic)
    np.testing.assert_allclose(mine, theirs, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def cli_run(toy, tmp_path_factory):
    """``cli train`` (with ``--quiet``, as the JAX CLI takes it) and ``cli
    test`` at 8 iterations on the CPU, with a profiler window."""
    tmp = tmp_path_factory.mktemp("cli")
    cfg_path = tmp / "toy.json"
    prof_dir = tmp / "prof"
    cfg = dict(CFG, iterations=8, test_iteration=8, profile_dir=str(prof_dir),
               profile_iters=[2, 3])
    cfg_path.write_text(json.dumps(cfg))
    out = tmp / "model"
    treaders.SCENE_READERS[LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud)
    try:
        tr = tcli.train_main(["-s", toy["root"], "--config", str(cfg_path),
                              "-m", str(out), "--device", "cpu", "--quiet"])
        with open(out / "8_runtimeresults.json") as f:
            train_report = json.load(f)
        res = tcli.test_main(["-m", str(out), "--iteration", "8",
                              "--device", "cpu"])
    finally:
        treaders.SCENE_READERS.pop(LOADER, None)
    return dict(out=out, prof_dir=prof_dir, tr=tr, res=res,
                train_report=train_report)


def test_cli_train_and_test_on_cpu(cli_run):
    """(d) ``python -m saro_gs_torch.cli train/test --device cpu`` at 8
    iterations writes the JAX CLI's files, with LPIPS (the seed-0 fixture)
    in the test report; a profiler window writes its trace."""
    out, tr, res = cli_run["out"], cli_run["tr"], cli_run["res"]
    assert tr.state.step == 8 and len(tr.history) == 1
    for f in ("cfg_args.json", "cameras.json", "history.json",
              "exp_log.txt", "8_runtimeresults.json",
              "point_cloud/iteration_8/point_cloud.ply",
              "point_cloud/iteration_8/point_cloud.npz",
              "point_cloud/iteration_best/point_cloud.ply"):
        assert (out / f).exists(), f
    assert (cli_run["prof_dir"] / "trace_2_3.json").exists()
    assert np.isfinite(cli_run["train_report"]["PSNR"])
    # the JAX package reads the port's cfg_args.json
    assert jconfig.load_cfg_args(str(out / "cfg_args.json")).iterations \
        == 8
    assert np.isfinite(res["PSNR"]) and res["num_views"] == 2
    assert isinstance(res["LPIPS-alex"], float)
    assert np.isfinite(res["LPIPS-alex"]) and res["LPIPS-alex"] > 0
    assert res["LPIPS-weights"] == "fixture-random-seed0"
    with open(out / "8_runtimeresults.json") as f:
        assert json.load(f) == res
    for sub in ("renders", "gt", "depth"):
        assert sorted(os.listdir(out / "test" / "ours_8" / sub)) == [
            "00000.png", "00001.png"], sub
    for f in ("8_runtimeresults.json", "8_runtimeperview.json"):
        assert (out / f).exists(), f


def test_eval_report_lpips_matches_jax(toy, cli_run):
    """The report's LPIPS-alex equals, within 1e-5 relative, the JAX
    package's lpips (its seed-0 fixture) on the same renders and ground
    truth: the checkpoint the CLI tested, rendered as ``render_set`` does."""
    from saro_gs_tpu.train import lpips as jlpips
    out = cli_run["out"]
    cfg = tconfig.load_cfg_args(str(out / "cfg_args.json"))
    cfg.model_path = str(out)
    treaders.SCENE_READERS[LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud)
    try:
        sc = tscene.Scene(cfg, load_iteration="8", device="cpu")
    finally:
        treaders.SCENE_READERS.pop(LOADER, None)
    ev = teval.Evaluator(cfg, sc)
    with torch.no_grad():
        feat = tgm.field_feat(sc.params, sc.nets, ev.mcfg, sc.fstatic)
    jp = {k: jnp.asarray(v) for k, v in jlpips.init_random_weights(
        jax.random.PRNGKey(0), "alex").items()}
    mine, theirs = [], []
    for cam in sc.test_cameras():
        o, _ = ev.render(cam, sc.params, sc.nets, sc.alive, feat,
                         ev.mcfg.sh_degree)
        assert o.num_dropped == 0
        img = torch.clamp(o.color, 0, 1)
        gt = cam.load_image(cfg.white_background)
        mine.append(float(tlpips.lpips(img, torch.as_tensor(gt))))
        theirs.append(float(jlpips.lpips_from_params(
            jp, jnp.asarray(n(img)), jnp.asarray(gt), "alex")))
    np.testing.assert_allclose(mine, theirs, rtol=1e-5)
    assert cli_run["res"]["LPIPS-alex"] == pytest.approx(np.mean(theirs),
                                                         rel=1e-5)
