"""configs/synth/stress_szcap.json in both packages, on the CPU: the same
model configuration and plane shapes; one dynamic train step at the
field's full width (six planes of 512^3 x 256 with 32 channels, heads of
width 128) from one state carried across by convert.py, on a reduced
frame, batch and cloud; and a few trainer iterations with the
configuration's structure (dynamic from iteration 1, densify mode 5 with
the screen-size prune, an opacity reset inside the run, instance
presizing) at toy widths, against the JAX trainer."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch import config as tcfg
from saro_gs_torch import convert
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import cameras as tcams
from saro_gs_torch.data import readers as treaders
from saro_gs_torch.data import synth
from saro_gs_torch.models import gaussians as tgm
from saro_gs_torch.ops import grid_scatter, mip
from saro_gs_torch.ops.projection import CameraParams
from saro_gs_torch.train import step as tstep
from saro_gs_torch.train.trainer import Trainer as TTrainer
from saro_gs_tpu import config as jcfg
from saro_gs_tpu import scene as jscene
from saro_gs_tpu.data import readers as jreaders
from saro_gs_tpu.models import densify as jdens
from saro_gs_tpu.models import field as jfield
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops import mip as jmip
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from saro_gs_tpu.train import optim as joptim
from saro_gs_tpu.train import step as jstep
from saro_gs_tpu.train.trainer import Trainer as JTrainer
from saro_gs_tpu.train.trainer import TrainState as JTrainState
from tests.test_e2e_train import DURATION, _write_scene
from tests.test_torch_step import (_assert_states_close, _decode,
                                   _jax_state_np)
from tests.test_torch_trainer import _small_reader
from tests.torch_parity import n

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRESS = os.path.join(ROOT, "configs", "synth", "stress_szcap.json")
# the reduced inputs of the full-width step
W, H, B, N = 96, 72, 2, 2000
SH_C0 = 0.28209479177387814


def _configs():
    return jcfg.load_config(STRESS), tcfg.load_config(STRESS)


def test_stress_config_same_in_both_packages():
    """Every setting both configs know is equal, the model and field
    configurations are equal, and the planes have the same shapes:
    512^3 x 256 with 32 channels, multires [1]."""
    cj, ct = _configs()
    dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
    common = (set(dj) & set(dt)) - {"unknown_keys"}
    assert {"capacity", "max_instances", "presize_factor", "batch",
            "duration", "static_iteration", "max_screen_size"} <= common
    for k in sorted(common):
        assert dj[k] == dt[k], k
    mj, mt = cj.model_config(), ct.model_config()
    assert mt.field.resolution == tuple(mj.field.resolution) \
        == (512, 512, 512, 256)
    assert mt.field.out_dim == mj.field.out_dim == 32
    assert tuple(mt.field.multires) == tuple(mj.field.multires) == (1,)
    assert mt._fields == mj._fields
    for k in mt._fields:
        if k != "field":
            assert getattr(mt, k) == getattr(mj, k), k
    jleaves = jax.tree_util.tree_leaves(jax.eval_shape(
        lambda: jgm.init_nets(jax.random.PRNGKey(0), mj)))
    tnets = tgm.DeformNets(mt)
    # the JAX layout: weights transposed (convert.net_leaves_to_jax)
    tleaves = [tuple(x.shape)[::-1] if name.endswith(".weight")
               else tuple(x.shape)
               for name, x in zip(tnets.leaf_names(), tnets.leaves())]
    assert tleaves == [tuple(x.shape) for x in jleaves]
    assert [tuple(p.shape) for p in tnets.field.planes] == [
        (32, 512, 512), (32, 512, 512), (32, 256, 512), (32, 512, 512),
        (32, 256, 512), (32, 256, 512)]
    assert sum(int(np.prod(p.shape)) for p in tnets.field.planes) \
        == 37_748_736
    assert mt.deform_hidden_dim == 128


def _full_width_state(cj, exclude=None):
    """(state dict in convert.py's format, JAX TrainState, JAX fstatic):
    2,000 points of synth.init_cloud at 300 frames, random planes and
    heads at the stress widths, zero Adam moments, an LR scaling in
    [1, 5], five dead slots, and dead the points ``exclude(d, mcfg,
    timestamps)`` marks."""
    mj = cj.model_config()
    rng = np.random.RandomState(3)
    f32 = np.float32
    pts, cols, times = synth.init_cloud(synth.build_gt(7), 300, N, 7)
    quat = rng.normal(0, 1, (N, 4)).astype(f32)
    quat[:, 0] += 3.0
    points = dict(
        xyz=pts, features_dc=((cols - 0.5) / SH_C0)[:, None].astype(f32),
        features_rest=rng.normal(0, 0.02, (N, 15, 3)).astype(f32),
        scaling=np.log(rng.uniform(0.01, 0.05, (N, 3))).astype(f32),
        rotation=quat, opacity=rng.uniform(-2.0, 3.0, (N, 1)).astype(f32),
        temporal_pos=times)
    tpl = jgm.init_nets(jax.random.PRNGKey(0), mj)
    treedef = jax.tree_util.tree_structure(tpl)
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(tpl)]
    for i in range(6):                       # the planes
        leaves[i] = rng.normal(0, 0.1, leaves[i].shape).astype(f32)
    alive = np.ones(N, f32)
    alive[-5:] = 0.0
    d = dict(
        points=points, net_leaves=leaves,
        mu_points={k: np.zeros_like(v) for k, v in points.items()},
        nu_points={k: np.zeros_like(v) for k, v in points.items()},
        mu_net_leaves=[np.zeros_like(x) for x in leaves],
        nu_net_leaves=[np.zeros_like(x) for x in leaves],
        count=0, step=0, alive=alive,
        aux=dict(xyz_grad_accum=np.zeros((N, 1), f32),
                 denom=np.zeros((N, 1), f32),
                 max_radii2d=np.zeros(N, f32)),
        inv_integral=rng.uniform(1, 5, (N, 1)).astype(f32),
        inv_integral_densify=np.ones((N, 1), f32),
        fstatic=dict(aabb_min=pts.min(0), aabb_max=pts.max(0),
                     duration=f32(300.0)))
    if exclude is not None:
        near = exclude(d, tcfg.load_config(STRESS).model_config(),
                       _batch()[2])
        print(f"{int(near.sum())} of {N} points near a ReLU kink, dead")
        assert near.sum() <= N // 5
        alive[near] = 0.0

    def jnets(ls):
        return jax.tree_util.tree_unflatten(treedef,
                                            [jnp.asarray(x) for x in ls])

    def jpts(p):
        return jgm.GaussianParams(**{k: jnp.asarray(v)
                                     for k, v in p.items()})
    jstate = JTrainState(
        points=jpts(points), nets=jnets(leaves),
        opt=joptim.AdamState(
            mu={"points": jpts(d["mu_points"]),
                "nets": jnets(d["mu_net_leaves"])},
            nu={"points": jpts(d["nu_points"]),
                "nets": jnets(d["nu_net_leaves"])},
            count=jnp.asarray(0, jnp.int32)),
        alive=jnp.asarray(alive),
        aux=jdens.DensifyAux(**{k: jnp.asarray(v)
                                for k, v in d["aux"].items()}),
        inv_integral=jnp.asarray(d["inv_integral"]),
        inv_integral_densify=jnp.asarray(d["inv_integral_densify"]),
        step=jnp.asarray(0, jnp.int32))
    jfs = jfield.FieldStatic(**{k: jnp.asarray(v)
                                for k, v in d["fstatic"].items()})
    return d, jstate, jfs


def _near_relu_kink(d, mcfg, ts, eps=1e-5):
    """Points whose deformation heads have a hidden pre-activation within
    ``eps`` of zero at a view's timestamp (or at zero time distance, the
    scale residual's input).  Two float32 implementations round such a
    pre-activation to either side of the ReLU's kink, and the one point
    then moves a head's hidden-layer gradient by a large share of its
    largest entry: the comparison is undefined there, not wrong."""
    state, fstatic = convert.train_state_from_numpy(d, mcfg, device="cpu")
    pts, nets = state.points, state.nets
    with torch.no_grad():
        feat = tgm.field_feat(pts, nets, mcfg, fstatic)
        inputs = [(nets.opacity_mlp, feat)]
        for t in list(np.asarray(ts).ravel()) + [None]:
            dist = torch.zeros_like(pts.temporal_pos) if t is None else \
                float(t) - tgm.get_temporal_pos(pts, mcfg)
            df = torch.cat([feat, tgm.time_embed(mcfg, dist)], dim=-1)
            inputs += [(nets.rot_mlp, df)] + ([] if t is None else [
                (nets.motion_mlp, df), (nets.shs_mlp, df)])
        near = torch.zeros(pts.xyz.shape[0], dtype=torch.bool)
        for mlp, x in inputs:
            for layer in mlp.layers[:-1]:
                x = layer(x)
                near |= (x.abs() < eps).any(dim=1)
                x = torch.relu(x)
    return near.numpy()


def _batch():
    """Two ring views of the stress rig at 96x72 (cameras 1 and 8 of
    21), uint8 noise as ground truth, timestamps 0.2 and 0.7."""
    rng = np.random.RandomState(0)
    ring = tcams.ring_cameras(21)
    cams = [tcams.camera_from_c2w(ring[i], 0.85, W, H, 0.0)
            .raster_params("cpu") for i in (1, 8)]
    stacked = [np.stack([n(c[k]) for c in cams]) for k in range(5)]
    gt = (rng.uniform(0, 1, (B, 3, H, W)) * 255).astype(np.uint8)
    ts = np.asarray([0.2, 0.7], np.float32).reshape(-1, 1, 1)
    return stacked, gt, ts


def test_full_width_step_matches_jax(monkeypatch):
    """One dynamic step at the stress field's full width against the JAX
    train_step_core (backend "jax"), from one state with the points at a
    ReLU kink dead (``_near_relu_kink``): loss, Ll1, PSNR and the LR
    scaling within rtol 2e-5, each group's largest gradient within rtol
    2e-3, the states within test_torch_step's 5e-4 gates.  The xy and xt
    planes' gradients, the 512x512 pyramid of 8 levels and the 512x256
    time plane, are held within 1e-5 of their largest entry on the step's
    own cotangent: what the port's backward hands K4's plain version,
    against the JAX package's sample_mip VJP of the same cotangent.  (The
    step's whole plane gradients carry the cotangent's own rounding,
    2e-5 of the largest entry like the points' gradients, and are held
    by the state gates.)"""
    cj, ct = _configs()
    cams, gt, ts = _batch()
    d, jstate, jfs = _full_width_state(cj, _near_relu_kink)
    jst = jstep.StepStatics(
        mcfg=cj.model_config(),
        rcfg=JRasterConfig(tile_x=32, tile_y=32, chunk=128,
                           max_instances=1 << 16, max_slots=4096,
                           backend="jax", tight_rect=True),
        weights=cj.loss_weights(), width=W, height=H,
        cfg_lrs=jstep.make_lr_statics(cj), extent=4.6,
        scale_floor=cj.scale_floor)
    js, jm = jax.jit(lambda s, c, g, t: jstep.train_step_core(
        s, c, g, t, jnp.ones(3), jfs, jst, stage="dynamatic", sh_degree=3,
        scale_integral=True))(
        jstate, JCameraParams(*[jnp.asarray(x) for x in cams]),
        jnp.asarray(_decode(gt)), jnp.asarray(ts))
    jnp_state = _jax_state_np(js)
    del js, jstate

    state, fstatic = convert.train_state_from_numpy(d, ct.model_config(),
                                                    device="cpu")
    planes = list(state.nets.field.planes)
    assert [tuple(p.shape) for p in planes][:3] == [
        (32, 512, 512), (32, 512, 512), (32, 256, 512)]
    old = convert.train_state_to_numpy(tstep.clone_state(state))
    tst = tstep.StepStatics(
        mcfg=ct.model_config(),
        rcfg=ct.raster_config()._replace(max_instances=1 << 16),
        weights=ct.loss_weights(), width=W, height=H,
        cfg_lrs=tstep.make_lr_statics(ct), extent=4.6,
        scale_floor=ct.scale_floor)
    # the planes' sampling calls, and the cotangent each backward gets
    sampled, taps = [], {}
    sample, scatter = mip.sample_mip, grid_scatter.scatter_mip_taps

    def sample_rec(grid, coords, level, max_level):
        i, = [i for i, p in enumerate(planes) if p is grid]
        sampled.append((i, grid.detach().clone(), coords, level, max_level))
        return sample(grid, coords, level, max_level)

    def scatter_rec(coords, level, dfeat, h, w, n_levels):
        rec, = [r for r in sampled if torch.equal(r[2], coords)]
        taps[rec[0]] = rec[1:] + (dfeat.clone(),)
        return scatter(coords, level, dfeat, h, w, n_levels)
    monkeypatch.setattr(mip, "sample_mip", sample_rec)
    monkeypatch.setattr(grid_scatter, "scatter_mip_taps", scatter_rec)
    ts_, tm = tstep.train_step_core(
        state, CameraParams(*[torch.as_tensor(x) for x in cams]),
        torch.as_tensor(gt), torch.as_tensor(ts), torch.ones(3), fstatic,
        tst, stage="dynamatic", sh_degree=3, scale_integral=True)
    assert tm["bad_step"] == 0 and int(jm["bad_step"]) == 0
    assert tm["dropped"] == 0 and int(jm["dropped"]) == 0
    for key in ("loss", "Ll1", "inv_lr_max", "psnr"):
        np.testing.assert_allclose(tm[key], float(jm[key]), rtol=2e-5,
                                   err_msg=key)
    for k, v in jm["gmax"].items():
        np.testing.assert_allclose(tm["gmax"][k], float(v), rtol=2e-3,
                                   atol=1e-12, err_msg=k)
    _assert_states_close(jnp_state, convert.train_state_to_numpy(ts_), old,
                         5e-4)
    for i, max_level in ((0, 7), (2, 0)):
        grid, coords, level, ml, dfeat = taps[i]
        assert ml == max_level
        mine = mip._grid_grad(tuple(grid.shape), coords, level, ml, dfeat)
        _, vjp = jax.vjp(lambda g: jmip.sample_mip(
            g, jnp.asarray(n(coords)), jnp.asarray(n(level)), ml),
            jnp.asarray(n(grid)))
        theirs = np.asarray(vjp(jnp.asarray(n(dfeat)))[0])
        scale = np.abs(theirs).max()
        assert scale > 0 and theirs.shape == tuple(grid.shape)
        assert np.abs(n(mine) - theirs).max() <= 1e-5 * scale, i


# the stress configuration's structure at toy widths: dynamic from
# iteration 1, densify mode 5 at 4 and 8 (the second with the screen-size
# prune, after the opacity reset at 6), presized instances, batch 4
LOADER = "toy_stress"
TOY = dict(
    loader=LOADER, duration=DURATION, resolution=1, batch=4, iterations=10,
    static_iteration=-1, densify=5, densify_from_iter=3,
    densification_interval=4, densify_until_iter=9,
    opacity_reset_interval=6, max_screen_size=6, preprocesspoints=0,
    capacity=1024, raster_backend="jax", max_instances=1 << 12,
    max_slots=512, presize_instances=True, presize_factor=3.0,
    overflow_check_every=25, inv_lr_clip=50.0, use_weight_decay=True,
    kplanes_config={"grid_dimensions": 2, "input_coordinate_dim": 4,
                    "output_coordinate_dim": 8,
                    "resolution": [16, 16, 16, 8]},
    multires=[1], sh_degree=1, dsh=True, scale_reg=True,
    lambda_dscale_reg=8e-6, lambda_dtstd=1e-4, min_intergral=1e-4,
    min_interval=0.5, position_lr_max_steps=10, mlp_lr=1.6e-3,
    densify_grad_threshold=2e-5)


@pytest.fixture(scope="module")
def toy_runs(tmp_path_factory):
    """Both trainers from the JAX Scene's initial state, 10 iterations
    each, logged every iteration (one intra-op thread for the port's
    plain compositors)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("toy_stress"))
    _write_scene(root, np.random.RandomState(7))
    out = tmp_path_factory.mktemp("models")
    jreaders.SCENE_READERS[LOADER] = _small_reader(
        jreaders.read_blender_scene, jgm.PointCloud)
    treaders.SCENE_READERS[LOADER] = _small_reader(
        treaders.read_blender_scene, tgm.PointCloud)
    try:
        jc = jcfg.load_config(source_path=root, model_path=str(out / "jax"),
                              **TOY)
        jsc = jscene.Scene(jc)
        init = dict(params={k: n(v) for k, v in jsc.params._asdict().items()},
                    leaves=[n(x) for x in jax.tree_util.tree_leaves(
                        jsc.nets)],
                    alive=n(jsc.alive),
                    fstatic={k: n(v) for k, v in jsc.fstatic._asdict()
                             .items()})
        jtr = JTrainer(jc, jsc)
        tc = tcfg.load_config(source_path=root,
                              model_path=str(out / "torch"), **TOY)
        tsc = tscene.Scene(tc, device="cpu")
        tsc.params, tsc.nets, _ = convert.jax_to_torch(
            init["params"], init["leaves"], init["fstatic"],
            tc.model_config(), device="cpu")
        tsc.alive = torch.as_tensor(init["alive"].copy())
        ttr = TTrainer(tc, tsc)
        jtr.run(log_every=1)
        ttr.run(log_every=1)
        yield dict(jtr=jtr, ttr=ttr, out=out)
    finally:
        torch.set_num_threads(threads)
        jreaders.SCENE_READERS.pop(LOADER, None)
        treaders.SCENE_READERS.pop(LOADER, None)


def test_toy_stress_trainer_matches_jax(toy_runs):
    """The same presized capacity; every iteration dynamic; the losses
    within 1e-3 relative up to the first densify (iteration 4), whose
    counts (the points logged after it) are equal; both journals record
    densify passes at 4 and 8 only; and after the split draws (the JAX
    package's PRNG, the port's generator) the losses stay within 5%."""
    jtr, ttr, out = toy_runs["jtr"], toy_runs["ttr"], toy_runs["out"]
    assert ttr.rcfg.max_instances == int(jtr.rcfg.max_instances)
    jh, th = jtr.history, ttr.history
    assert [h["it"] for h in jh] == [h["it"] for h in th] == list(
        range(1, 11))
    assert all(h["stage"] == "dynamatic" for h in th + jh)
    assert not any("bad_step" in h for h in th + jh)
    np.testing.assert_allclose([h["loss"] for h in th[:4]],
                               [h["loss"] for h in jh[:4]], rtol=1e-3)
    assert th[3]["points"] == jh[3]["points"] != th[2]["points"]
    np.testing.assert_allclose([h["loss"] for h in th[4:]],
                               [h["loss"] for h in jh[4:]], rtol=5e-2)
    assert [d["it"] for d in ttr.densify_log] == [4, 8]

    def journal(pkg):
        """(iteration, note, points) of each exp_log.txt record."""
        with open(os.path.join(out, pkg, "exp_log.txt")) as f:
            lines = f.read().split("\n")
        return [(int(a.split()[-1]),) + tuple(b.rsplit(" pointsnumber ", 1))
                for a, b in zip(lines[::2], lines[1::2])]
    tj, jj = journal("torch"), journal("jax")
    print(tj, jj)
    assert [r[:2] for r in tj] == [r[:2] for r in jj] == [
        (4, "before densify"), (4, "after densify"), (8, "before densify"),
        (8, "after densify")]
    assert tj[:2] == jj[:2]
    assert not ttr.overflows
