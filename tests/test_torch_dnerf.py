"""The D-NeRF training mode (configs/dnerf/*.json) in both packages, on the
CPU, on a toy capture in the D-NeRF on-disk layout
(tests/torch_dnerf_scene.py: 6 training and 2 test frames of 64x64 RGBA,
read at resolution 2 over white, no points3d.ply).

Held to the JAX package: the layout writer's images against the port's
render; every configs/dnerf/*.json through both ``load_config``s; the
``blender`` reader's random init and its PLY bytes, the cameras and the
loader's uint8 ground truth composited over white, through the native
decoder and through the Python one; one static and one dynamic train step
at standup.json's full widths (HexPlane 64^3 x 128 of 32 channels, the
default heads) from one state carried by convert.py; ``Trainer.run``'s
schedule over iterations 1 to 2,110 of standup.json (the static stage to
1,000, the SH steps at 1,000 and 2,000, the passes from 600, the opacity
reset at 2,000 and the size-thresholded pass at 2,100) with the step,
the loader and the density moves stubbed in both trainers; and the
``max_instances`` overflow doubling on tests/test_torch_trainer.py's toy
run, both trainers from one state.
"""
import concurrent.futures
import dataclasses
import glob
import json
import math
import os
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import config as tconfig
from saro_gs_torch import convert
from saro_gs_torch import native as tnative
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import dataset as tdataset
from saro_gs_torch.data import readers as treaders
from saro_gs_torch.data.cameras import camera_from_c2w
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
from saro_gs_torch.train import step as tstep
from saro_gs_torch.train import trainer as ttrainer
from saro_gs_tpu import config as jconfig
from saro_gs_tpu import native as jnative
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.data import dataset as jdataset
from saro_gs_tpu.data import readers as jreaders
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.train import step as jstep
from saro_gs_tpu.train import trainer as jtrainer
from tests import torch_dnerf_scene as dnerf
from tests.test_e2e_train import _write_scene
from tests.test_torch_data import _read, _same_cameras, _same_point_clouds
from tests.test_torch_step import (_assert_states_close, _decode,
                                   _jax_state_np)
from tests.test_torch_stress import _near_relu_kink
from tests.test_torch_trainer import CFG as TOY_CFG
from tests.test_torch_trainer import _small_reader
from tests.torch_parity import n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNERF = sorted(glob.glob(os.path.join(ROOT, "configs", "dnerf", "*.json")))
STANDUP = os.path.join(ROOT, "configs", "dnerf", "standup.json")
TOY = dnerf.TOY
# the reader's random init cut to this many points for the trainers
N_POINTS = 2000
LOADER = "dnerf_toy2000"


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The toy layout, written once (rendered on the CPU, one intra-op
    thread); a test copies it before a reader writes into it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = str(tmp_path_factory.mktemp("dnerf") / "scene")
        paths = dnerf.toy_scene(root)
    finally:
        torch.set_num_threads(threads)
    return dict(root=root, paths=paths)


def _copy(layout, dst) -> str:
    shutil.copytree(layout["root"], str(dst))
    return str(dst)


def test_layout_writer(layout):
    """The writer's layout: the three transforms files (camera_angle_x
    0.6911, ``./<split>/r_<jjj>``, time j / (n - 1), poses at radius 4 on
    the upper hemisphere looking at the origin), RGBA PNGs with
    transparent, partly covered and opaque pixels, no points3d.ply; and
    each PNG composited over white within 1/255 (the two roundings) of the
    port's render of the same frame over white."""
    from PIL import Image
    root = layout["root"]
    assert not os.path.exists(os.path.join(root, "points3d.ply"))
    gt = dnerf.dnerf_gt(TOY["stride"], TOY["widen"])
    assert np.abs(gt["base"]).max() < 1.3
    for split in ("train", "test", "val"):
        with open(os.path.join(root, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        assert meta["camera_angle_x"] == 0.6911
        frames = meta["frames"]
        count = TOY[split]
        assert len(frames) == count == len(layout["paths"][split])
        for j, fr in enumerate(frames):
            assert fr["file_path"] == f"./{split}/r_{j:03d}"
            assert fr["time"] == (j / (count - 1) if count > 1 else 0.0)
            c2w = np.asarray(fr["transform_matrix"])
            pos = c2w[:3, 3]
            assert abs(np.linalg.norm(pos) - dnerf.RADIUS) < 1e-9
            assert pos[2] > 0
            # OpenGL: the camera looks down its -z axis, at the origin
            np.testing.assert_allclose(-c2w[:3, 2], -pos / dnerf.RADIUS,
                                       atol=1e-12)
    with open(os.path.join(root, "transforms_train.json")) as f:
        frames = json.load(f)["frames"]
    for k in (0, 3):
        fr = frames[k]
        rgba = np.asarray(Image.open(layout["paths"]["train"][k]))
        assert rgba.shape == (TOY["height"], TOY["width"], 4)
        a = rgba[..., 3]
        assert (a == 0).mean() > 0.2 and (a == 255).mean() > 0.05
        assert ((a > 0) & (a < 255)).any()
        over_white = (rgba[..., :3] / 255.0 * (a[..., None] / 255.0)
                      + (1.0 - a[..., None] / 255.0))
        cam = camera_from_c2w(fr["transform_matrix"], dnerf.CAMERA_ANGLE_X,
                              TOY["width"], TOY["height"], fr["time"])

        def t(x):
            return torch.as_tensor(x)
        with torch.no_grad():
            out = rasterize(
                t(gt["gt_at"](fr["time"])), t(gt["scales"]), t(gt["quats"]),
                t(gt["opac"]), cam.raster_params("cpu"), torch.ones(3),
                width=TOY["width"], height=TOY["height"], sh_degree=3,
                config=RasterConfig(tile_x=32, tile_y=32, chunk=128,
                                    max_instances=1 << 20, tight_rect=True,
                                    need_aux=False), shs=t(gt["shs"]))
        ref = np.clip(n(out.color).transpose(1, 2, 0), 0, 1)
        assert np.abs(over_white - ref).max() <= 1.0 / 255 + 1e-6


@pytest.mark.parametrize("path", DNERF, ids=os.path.basename)
def test_dnerf_config_same_in_both_packages(path):
    """Every setting both configs know is equal, and so are the model and
    raster configurations, the learning-rate statics and the loss
    weights; the D-NeRF mode's fields are the file's: the blender reader
    at resolution 2 over white, batch 4, planes 64^3 x 128 of 32 channels,
    densify 5 from 500 every 100 until 15,000, the opacity reset every
    2,000, static until 1,000, duration 150, 20,000 iterations."""
    cj, ct = jconfig.load_config(path), tconfig.load_config(path)
    dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
    common = (set(dj) & set(dt)) - {"unknown_keys"}
    with open(path) as f:
        keys = set(json.load(f))
    assert keys <= common
    for k in sorted(common):
        assert dj[k] == dt[k], k
    assert cj.unknown_keys == ct.unknown_keys == {}
    mj, mt = cj.model_config(), ct.model_config()
    assert mt._fields == mj._fields
    for k in mt._fields:
        if k != "field":
            assert getattr(mt, k) == getattr(mj, k), k
    assert mt.field.resolution == tuple(mj.field.resolution) \
        == (64, 64, 64, 128)
    assert mt.field.out_dim == mj.field.out_dim == 32
    assert tuple(mt.field.multires) == tuple(mj.field.multires) == (1,)
    rj, rt = cj.raster_config(), ct.raster_config()
    for k in rt._fields:
        if k in rj._fields:
            assert getattr(rt, k) == getattr(rj, k), k
    assert tstep.make_lr_statics(ct) == jstep.make_lr_statics(cj)
    assert tuple(ct.loss_weights()) == tuple(cj.loss_weights())
    sched = dict(loader="blender", resolution=2, white_background=True,
                 batch=4, densify=5, densify_from_iter=500,
                 densification_interval=100, densify_until_iter=15000,
                 opacity_reset_interval=2000, static_iteration=1000,
                 duration=150, iterations=20000, preprocesspoints=0,
                 use_shs=True, sh_degree=3)
    for k, v in sched.items():
        assert dt[k] == v, k
    assert ct.dataset == os.path.basename(path)[:-5]


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_reader_and_loader_match_jax(layout, tmp_path, monkeypatch, decoder):
    """Both ``blender`` readers on their own copy of the toy layout at
    resolution 2 over white: the cameras, the random init (100,000 points
    of RandomState(666), equal to a numpy recount) and its PLY bytes; one
    test image and three batches of 4 of the loader (seed 666): the same
    indices, uint8 ground truth composited over white, timestamps and
    cameras, to the bit.  ``native``: both packages decode through their
    native library; ``python``: SARO_NATIVE=0, PIL in both."""
    if decoder == "python":
        monkeypatch.setenv("SARO_NATIVE", "0")
    else:
        assert tnative.available()
        if jnative.lib() is None:
            # one failed build is remembered for the process: try again
            monkeypatch.setattr(jnative, "_TRIED", False)
        assert jnative.available()
    a_dir = _copy(layout, tmp_path / "a")
    b_dir = _copy(layout, tmp_path / "b")
    a = jreaders.read_blender_scene(a_dir, duration=TOY["train"],
                                    resolution=2, white_background=True)
    b = treaders.read_blender_scene(b_dir, duration=TOY["train"],
                                    resolution=2, white_background=True)
    for split in ("train_cameras", "test_cameras"):
        _same_cameras(getattr(a, split), getattr(b, split), with_paths=False)
        assert [c.image_path.replace(a_dir, b_dir)
                for c in getattr(a, split)] == [
            c.image_path for c in getattr(b, split)]
    cam = b.train_cameras[0]
    assert (cam.width, cam.height) == (TOY["width"] // 2,
                                       TOY["height"] // 2)
    assert [c.timestamp for c in b.train_cameras] == [
        j / (TOY["train"] - 1) * (TOY["train"] - 1) / TOY["train"]
        for j in range(TOY["train"])]
    assert a.nerf_radius == b.nerf_radius
    _same_point_clouds(a.point_cloud, b.point_cloud)
    assert _read(a.ply_path) == _read(b.ply_path)
    pts, cols, times = dnerf.recount_random_init()
    np.testing.assert_array_equal(b.point_cloud.points, pts)
    np.testing.assert_array_equal(b.point_cloud.colors, cols)
    np.testing.assert_array_equal(b.point_cloud.times, times)
    np.testing.assert_array_equal(b.test_cameras[1].load_image(True),
                                  a.test_cameras[1].load_image(True))

    la = jdataset.BatchLoader(a.train_cameras, 4, white_background=True,
                              num_workers=2, seed=666)
    lb = tdataset.BatchLoader(b.train_cameras, 4, white_background=True,
                              num_workers=2, seed=666)
    try:
        for k, (x, y) in enumerate(zip(la, lb)):
            if k == 3:
                break
            np.testing.assert_array_equal(x.indices, y.indices)
            assert y.gt.dtype == np.uint8
            np.testing.assert_array_equal(x.gt, y.gt)
            np.testing.assert_array_equal(x.timestamps, y.timestamps)
            for f in x.cams._fields:
                np.testing.assert_array_equal(np.asarray(getattr(x.cams, f)),
                                              getattr(y.cams, f))
            # over white: the transparent border is white, the subject not
            assert (y.gt == 255).all(axis=1).mean() > 0.3
            assert y.gt.min() < 128
    finally:
        lb.close()


def _standup(root, model, **extra):
    """standup.json for the toy layout: only the paths, the reader (the
    random init cut to N_POINTS), the duration (the toy's frames) and the
    capacities change: 2,048 Gaussian rows (of 262,144), 65,536 instances,
    no presize."""
    return dict(source_path=root, model_path=model, loader=LOADER,
                duration=TOY["train"], capacity=2048,
                presize_instances=False, max_instances=1 << 16,
                max_slots=4096, **extra)


@pytest.fixture(scope="module")
def standup(layout, tmp_path_factory):
    """The JAX Scene and Trainer of standup.json on the toy layout (the
    random init cut to 2,000 points), and the port's Scene and Trainer
    from the JAX Scene's state."""
    tmp = tmp_path_factory.mktemp("standup")
    root = _copy(layout, tmp / "scene")
    jreaders.SCENE_READERS[LOADER] = _small_reader(
        jreaders.read_blender_scene, jgm.PointCloud, N_POINTS)
    treaders.SCENE_READERS[LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud, N_POINTS)
    try:
        jcfg = jconfig.load_config(STANDUP, **_standup(
            root, str(tmp / "jax")))
        jsc = jscene.Scene(jcfg)
        jtr = jtrainer.Trainer(jcfg, jsc)
        tcfg = tconfig.load_config(STANDUP, **_standup(
            root, str(tmp / "torch")))
        tsc = tscene.Scene(tcfg, device="cpu")
        tsc.params, tsc.nets, _ = convert.jax_to_torch(
            {k: n(v) for k, v in jsc.params._asdict().items()},
            [n(x) for x in jax.tree_util.tree_leaves(jsc.nets)],
            {k: n(v) for k, v in jsc.fstatic._asdict().items()},
            tcfg.model_config(), device="cpu")
        tsc.alive = torch.as_tensor(n(jsc.alive).copy())
        ttr = ttrainer.Trainer(tcfg, tsc)
        yield dict(jcfg=jcfg, jsc=jsc, jtr=jtr, tcfg=tcfg, tsc=tsc, ttr=ttr)
    finally:
        jreaders.SCENE_READERS.pop(LOADER, None)
        treaders.SCENE_READERS.pop(LOADER, None)


def _full_width_state(jtr, ts=None):
    """(state dict in convert.py's format with fstatic, JAX TrainState):
    the JAX trainer's initial state with its zero planes filled from a
    seeded N(0, 0.1), so that the field's features and their gradients
    are not all zero; with the views' timestamps ``ts``, the points whose
    deformation heads sit within 1e-5 of a ReLU kink there made dead
    (tests/test_torch_stress.py:_near_relu_kink)."""
    rng = np.random.RandomState(5)
    js = jtr.state
    leaves, treedef = jax.tree_util.tree_flatten(js.nets)
    n_planes = len(jtr.mcfg.field.multires) * 6
    leaves = [jnp.asarray(rng.normal(0, 0.1, x.shape).astype(np.float32))
              if i < n_planes else x for i, x in enumerate(leaves)]
    js = js._replace(nets=jax.tree_util.tree_unflatten(treedef, leaves))
    d = _jax_state_np(js)
    d["fstatic"] = {k: n(v) for k, v in jtr.scene.fstatic._asdict().items()}
    if ts is not None:
        near = _near_relu_kink(d, tconfig.load_config(STANDUP)
                               .model_config(), ts)
        live = d["alive"] > 0
        print(f"{int((near & live).sum())} of {int(live.sum())} points "
              "near a ReLU kink, dead")
        assert (near & live).sum() <= live.sum() // 5
        d["alive"] = np.where(near, np.float32(0), d["alive"])
        js = js._replace(alive=jnp.asarray(d["alive"]))
    return d, js


def test_reset_then_adam_keeps_underflowed_opacity():
    """Fault F4 (ROADMAP section 3), met by standup.json on the card: an
    opacity logit below about -103 makes float32's sigmoid 0, so the
    opacity reset's inverse_sigmoid(min(sigmoid(x), 0.01)) gives -inf in
    both packages (as in the reference's torch code).  The reference's
    torch.optim.Adam adds weight decay only where it is not zero, so such
    a row stays -inf and its gradients stay 0; the JAX package's
    adam_step adds 0 * -inf, NaN, after which every step's opacity,
    t-centre and net gradients are NaN and the guard skips them all.  The
    port's adam_step follows torch: the row stays -inf; the finite rows
    agree with the JAX package's step within 1e-7 relative and with
    torch.optim.Adam's within 1e-6."""
    from saro_gs_torch.models import densify as tdens
    from saro_gs_torch.train import optim as toptim
    from saro_gs_tpu.ops import math3d as jmath3d
    from saro_gs_tpu.train import optim as joptim
    logits = np.asarray([[-120.0], [-50.0], [0.3], [-3.0]], np.float32)
    grads = np.asarray([[0.0], [1e-3], [-2e-3], [5e-4]], np.float32)
    jreset = np.asarray(jax.jit(lambda x: jmath3d.inverse_sigmoid(
        jnp.minimum(jax.nn.sigmoid(x), 0.01)))(jnp.asarray(logits)))
    pts = tgm.GaussianParams(*[torch.zeros(4, 1)] * 7)._replace(
        opacity=torch.as_tensor(logits))
    treset = n(tdens.reset_opacity(pts, pts, pts)[0].opacity)
    np.testing.assert_array_equal(treset, jreset)
    assert treset[0, 0] == -np.inf and np.isfinite(treset[1:]).all()
    mine, _ = toptim.adam_step(toptim.init_adam([torch.as_tensor(treset)]),
                               [torch.as_tensor(treset)],
                               [torch.as_tensor(grads)], [0.05], [0.0])
    mine = n(mine[0])
    assert mine[0, 0] == -np.inf
    theirs, _ = joptim.adam_step(
        joptim.init_adam({"o": jnp.asarray(jreset)}),
        {"o": jnp.asarray(jreset)}, {"o": jnp.asarray(grads)}, {"o": 0.05},
        {"o": 0.0})
    theirs = np.asarray(theirs["o"])
    assert np.isnan(theirs[0, 0])
    np.testing.assert_allclose(mine[1:], theirs[1:], rtol=1e-7)
    ref = torch.nn.Parameter(torch.as_tensor(treset.copy()))
    opt = torch.optim.Adam([ref], lr=0.05, eps=1e-15, weight_decay=0.0)
    ref.grad = torch.as_tensor(grads)
    opt.step()
    ref = n(ref.detach())
    assert ref[0, 0] == -np.inf
    np.testing.assert_allclose(mine[1:], ref[1:], rtol=1e-6)


@pytest.mark.parametrize("stage", ["static", "dynamatic"])
def test_full_width_step_matches_jax(standup, stage):
    """One train step at standup.json's full widths (six planes, 64^3 x
    128, 32 channels; the default heads) on the toy's first batch of 4
    (32x32 over white), from the JAX trainer's initial state (the random
    init cut to 2,000 points, the planes filled by a seeded normal)
    carried across by convert.py, against the JAX train_step_core (the
    pure-JAX compositor at the port's 32x32 tiles): the static step of
    iteration 1 at SH degree 0, the dynamic step of iteration 1,001 at SH
    degree 1.  Loss, Ll1, PSNR and the LR scaling's max within rtol 1e-5;
    each group's largest gradient within rtol 2e-3; the states within
    test_torch_step's gates at 5e-4 (tests/test_torch_stress.py's)."""
    jtr, ttr, tcfg = standup["jtr"], standup["ttr"], standup["tcfg"]
    it = 1 if stage == "static" else tcfg.static_iteration + 1
    assert jtr.stage_at(it) == ttr.stage_at(it) == stage
    degree = 0 if stage == "static" else 1
    loader = jdataset.BatchLoader(jtr.scene.info.train_cameras, 4,
                                  white_background=True, num_workers=1,
                                  seed=tcfg.seed)
    batch = next(iter(loader))
    cams = [np.asarray(x) for x in batch.cams]
    gt, ts = batch.gt, batch.timestamps
    d, jstate = _full_width_state(jtr, ts if stage == "dynamatic" else None)
    tst = ttr._statics()
    assert (tst.rcfg.tile_x, tst.rcfg.chunk) == (32, 128)
    jst = jtr._statics()._replace(rcfg=JRasterConfig(
        tile_x=32, tile_y=32, chunk=128, max_instances=1 << 16,
        max_slots=4096, backend="jax", tight_rect=True))
    js, jm = jax.jit(lambda s, c, g, t, m: jstep.train_step_core(
        s, c, g, t, jnp.ones(3), jtr.scene.fstatic, jst, stage=stage,
        sh_degree=3, sh_mask=m, scale_integral=True))(
        jstate, JCameraParams(*[jnp.asarray(x) for x in cams]),
        jnp.asarray(_decode(gt)), jnp.asarray(ts), jtr._sh_mask(degree))
    jnp_state = _jax_state_np(js)
    del js, jstate

    state, fstatic = convert.train_state_from_numpy(d, ttr.mcfg,
                                                    device="cpu")
    assert [tuple(p.shape) for p in state.nets.field.planes] == [
        (32, 64, 64), (32, 64, 64), (32, 128, 64), (32, 64, 64),
        (32, 128, 64), (32, 128, 64)]
    old = convert.train_state_to_numpy(tstep.clone_state(state))
    ts_, tm = tstep.train_step_core(
        state, CameraParams(*[torch.as_tensor(x) for x in cams]),
        torch.as_tensor(gt), torch.as_tensor(ts), torch.ones(3), fstatic,
        tst, stage=stage, sh_degree=3, scale_integral=True,
        sh_mask=ttr._sh_mask(degree))
    assert tm["bad_step"] == 0 and int(jm["bad_step"]) == 0
    assert tm["dropped"] == 0 and int(jm["dropped"]) == 0
    for key in ("loss", "Ll1", "inv_lr_max", "psnr"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    for k, v in jm["gmax"].items():
        np.testing.assert_allclose(tm["gmax"][k], float(v), rtol=2e-3,
                                   atol=1e-12, err_msg=k)
    if stage == "dynamatic":
        assert tm["gmax"]["nets"] > 0
    _assert_states_close(jnp_state, convert.train_state_to_numpy(ts_), old,
                         5e-4)


def _stub_run(tr, rec, monkeypatch, jax_pkg, cfg=None):
    """``tr.run`` under ``cfg`` (default: the trainer's, run to 2,110 with
    a test and a save there) with the step, the loader, the integral
    refresh and the density moves replaced by records in ``rec``: per
    iteration the stage, the integral flag and the SH mask the step got;
    each refresh with its flag; each densify attempt with its size flag
    and the SH degree then; the resets, the base-time z prunes, the tests
    and the saves.  The step only counts."""
    metrics = {"loss": 0.1, "Ll1": 0.1, "psnr": 20.0, "gmax": {},
               "inv_lr_max": 1.0, "bad_src": 0, "dropped": 0, "bad_step": 0}

    def note(*r):
        rec.append(r)

    def degree(mask):
        return math.isqrt(int(np.asarray(mask).sum())) - 1

    class Loader:
        def __iter__(self):
            while True:
                yield None

        def close(self):
            pass
    scene = types.SimpleNamespace(
        train_loader=lambda *a, **k: Loader(), model_path="", writes=True,
        cameras_extent=1.0, fstatic=None,
        record_points=lambda it, msg, pts: None,
        save=lambda it, *a, **k: note("save", it))
    monkeypatch.setattr(tr, "scene", scene)
    monkeypatch.setattr(tr, "grow_capacity", lambda *a: note("grow"))
    res = types.SimpleNamespace(overflowed=False)
    if jax_pkg:
        def step(state, cams, gt, ts, sh_mask, scale, *, st, stage):
            note("step", int(state.step) + 1, stage, bool(scale),
                 degree(sh_mask))
            return state._replace(step=state.step + 1), metrics

        def densify(state, key, *, with_size_threshold):
            note("densify", int(tr.state.step), with_size_threshold,
                 tr.active_sh_degree)
            return state, res
        monkeypatch.setattr(tr, "_train_step", step)
        monkeypatch.setattr(tr, "_globalize", lambda b: (None, None, None))
        monkeypatch.setattr(tr, "_integral_refresh", lambda s, use: note(
            "refresh", int(tr.state.step) + 1, bool(use)) or s)
        monkeypatch.setattr(tr, "_densify", densify)
        monkeypatch.setattr(tr, "_reset_opacity", lambda s: note(
            "reset", int(tr.state.step)) or s)
        monkeypatch.setattr(tr, "_zprune_real_xyz", lambda s: note(
            "zprune", int(tr.state.step)) or s)
        # the JAX package compiles the dynamic step ahead in a thread
        monkeypatch.setattr(tr, "_precompile_dynamic", lambda *a: None)
    else:
        def step(state, cams, gt, ts, bg, fstatic, st, *, stage, sh_degree,
                 scale_integral, sh_mask, mesh):
            note("step", state.step + 1, stage, bool(scale_integral),
                 degree(sh_mask))
            return state._replace(step=state.step + 1), metrics

        def densify(size):
            note("densify", tr.state.step, size, tr.active_sh_degree)
            return res
        monkeypatch.setattr(tstep, "train_step_core", step)
        monkeypatch.setattr(tr, "_to_device", lambda b: (None, None, None))
        monkeypatch.setattr(tr, "_integral_refresh", lambda use: note(
            "refresh", tr.state.step + 1, bool(use)))
        monkeypatch.setattr(tr, "_densify", densify)
        monkeypatch.setattr(tr, "_densify_counts", lambda r: dict(
            overflowed=False, cloned=0, split=0, pruned=0))
        monkeypatch.setattr(tr, "_apply_densify", lambda r: None)
        monkeypatch.setattr(tr, "_reset_opacity", lambda: note(
            "reset", tr.state.step))
        monkeypatch.setattr(tr, "_zprune_real_xyz", lambda: note(
            "zprune", tr.state.step))
    monkeypatch.setattr(tr, "cfg", cfg or dataclasses.replace(
        tr.cfg, iterations=2110, testing_iterations=[2110],
        save_iterations=[2110]))
    tr.active_sh_degree = 0
    tr.run(log_every=10 ** 6,
           eval_fn=lambda t, it: note("test", it, t.active_sh_degree))
    return tr.active_sh_degree


def test_late_schedule_matches_jax(standup, monkeypatch):
    """``Trainer.run`` of both packages over iterations 1 to 2,110 of
    standup.json's schedule (test and save at 2,110), with the step, the
    loader, the integral refresh and the density moves stubbed: the same
    record, event for event.  And the record is the schedule that
    saro_gs_tpu/train/trainer.py:run and _density_control state: static
    to 1,000; the SH degree 0 until the step of 1,000, 1 from then, 2
    from the step of 2,000 (the degree a step renders with lags the
    update by one iteration); the integral refresh every 50 iterations
    of the dynamic stage (1,050 to 2,100) with its flag on; the scale
    flag on throughout (before densify_until_iter); 16 passes, 600 to
    2,100, the one at 2,100 alone with the screen-size threshold; at
    2,000 the refresh, the step, the SH step, the pass, then the opacity
    reset; the test
    and the save at 2,110 at SH degree 2."""
    recs = {}
    for name in ("jtr", "ttr"):
        tr = standup[name]
        recs[name] = []
        saved = tr.state, tr.active_sh_degree, tr.rcfg
        try:
            tr.state = tr.state._replace(step=0 if name == "ttr" else
                                         jnp.zeros((), jnp.int32))
            final = _stub_run(tr, recs[name], monkeypatch, name == "jtr")
        finally:
            tr.state, tr.active_sh_degree, tr.rcfg = saved
            monkeypatch.undo()
        assert final == 2
    assert recs["jtr"] == recs["ttr"]
    rec = recs["ttr"]
    steps = [r for r in rec if r[0] == "step"]
    assert [r[1] for r in steps] == list(range(1, 2111))
    for _, it, stage, scale, deg in steps:
        assert stage == ("static" if it <= 1000 else "dynamatic"), it
        assert scale, it
        assert deg == (0 if it <= 1000 else 1 if it <= 2000 else 2), it
    assert [r[1:] for r in rec if r[0] == "refresh"] == [
        (it, True) for it in range(1050, 2101, 50)]
    passes = [r[1:] for r in rec if r[0] == "densify"]
    assert [p[0] for p in passes] == list(range(600, 2101, 100))
    assert [p[1] for p in passes] == [False] * 15 + [True]
    assert [r[1] for r in rec if r[0] == "reset"] == [2000]
    # at 2,000: the integral refresh, the step, the SH step (the pass
    # sees degree 2), the pass, then the reset
    at = [r[0] for r in rec if r[1] == 2000]
    assert at == ["refresh", "step", "densify", "reset"], at
    assert dict((p[0], p[2]) for p in passes)[2000] == 2
    assert dict((p[0], p[2]) for p in passes)[1900] == 1
    assert [r for r in rec if r[0] in ("test", "save")] == [
        ("test", 2110, 2), ("save", 2110)]
    assert not [r for r in rec if r[0] == "grow"]


# tests/test_torch_trainer.py's toy run (40x32, 400 points), static
# throughout, with no presize, max_instances below the first frame's
# instances and a check every 2 iterations.  The JAX package's Pallas path
# (its kernels in interpret mode on the CPU, 32x32 tiles): its staged
# binning truncates a view as the port's does, keeping the first
# instances in Gaussian order; the pure-JAX path depth-sorts the Gaussians
# before it expands them and keeps the nearest, another image.  (On the
# denser D-NeRF toy the Pallas forward's own rounding near the T < 1e-4
# latch, ROADMAP section 3, moves the losses by more than this gate.)
OVERFLOW_LOADER = "toy400_overflow"
OVERFLOW = dict(TOY_CFG, loader=OVERFLOW_LOADER, iterations=6,
                densify_from_iter=1000, presize_instances=False,
                max_instances=256, overflow_check_every=2,
                raster_backend="pallas")


def test_overflow_doubling_matches_jax(tmp_path, monkeypatch):
    """Both trainers from the JAX Scene's state on the toy run with
    ``max_instances`` 256 and a check every 2 iterations: per iteration
    the same high-water mark of dropped instances and the same
    ``max_instances`` when the check reads it, so the doublings fall at
    the same iterations with the same marks (the port's
    ``Trainer.overflows``, plain ints) and end at the same capacity; the
    losses within 1e-3 relative (tests/test_torch_trainer.py's gate),
    those of the truncated steps included; nothing dropped after the
    doubling (at 2, to 512; each capacity costs the JAX trainer a compile
    of its step)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path / "scene")
    _write_scene(root, np.random.RandomState(7))
    jreaders.SCENE_READERS[OVERFLOW_LOADER] = _small_reader(
        jreaders.read_blender_scene, jgm.PointCloud)
    treaders.SCENE_READERS[OVERFLOW_LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud)
    trace = {"jtr": [], "ttr": []}

    def traced(name, control):
        def density_control(self, it, stage):
            control(self, it, stage)
            # what the overflow check reads right after this call
            trace[name].append((it, int(self.state.dropped_hwm),
                                int(self.rcfg.max_instances)))
        return density_control
    monkeypatch.setattr(jtrainer.Trainer, "_density_control",
                        traced("jtr", jtrainer.Trainer._density_control))
    monkeypatch.setattr(ttrainer.Trainer, "_density_control",
                        traced("ttr", ttrainer.Trainer._density_control))
    try:
        jcfg = jconfig.load_config(source_path=root,
                                   model_path=str(tmp_path / "jax"),
                                   **OVERFLOW)
        jsc = jscene.Scene(jcfg)
        jtr = jtrainer.Trainer(jcfg, jsc)
        tcfg = tconfig.load_config(source_path=root,
                                   model_path=str(tmp_path / "torch"),
                                   **OVERFLOW)
        tsc = tscene.Scene(tcfg, device="cpu")
        tsc.params, tsc.nets, _ = convert.jax_to_torch(
            {k: n(v) for k, v in jsc.params._asdict().items()},
            [n(x) for x in jax.tree_util.tree_leaves(jsc.nets)],
            {k: n(v) for k, v in jsc.fstatic._asdict().items()},
            tcfg.model_config(), device="cpu")
        tsc.alive = torch.as_tensor(n(jsc.alive).copy())
        ttr = ttrainer.Trainer(tcfg, tsc)
        assert ttr.rcfg.max_instances == int(jtr.rcfg.max_instances) == 256
        # the two runs share nothing: the JAX one goes in a thread
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            jax_run = pool.submit(jtr.run, log_every=1)
            ttr.run(log_every=1)
            jax_run.result()
    finally:
        torch.set_num_threads(threads)
        jreaders.SCENE_READERS.pop(OVERFLOW_LOADER, None)
        treaders.SCENE_READERS.pop(OVERFLOW_LOADER, None)
    every = OVERFLOW["overflow_check_every"]
    assert trace["ttr"] == trace["jtr"]
    assert [r[0] for r in trace["ttr"]] == list(range(1, 7))
    doublings = [(it, hwm) for it, hwm, _ in trace["ttr"]
                 if it % every == 0 and hwm > 0]
    assert ttr.overflows == doublings
    assert all(type(h) is int and h > 0 for _, h in ttr.overflows)
    assert [it for it, _ in ttr.overflows] == [2]
    assert ttr.rcfg.max_instances == int(jtr.rcfg.max_instances) \
        == 256 << len(ttr.overflows)
    assert [hwm for it, hwm, _ in trace["ttr"] if it > 2] == [0] * 4
    assert ttr.state.dropped_hwm == 0 and ttr.state.bad_steps == 0
    jl = [h["loss"] for h in jtr.history]
    tl = [h["loss"] for h in ttr.history]
    assert len(jl) == len(tl) == 6
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
