"""The port's eval render (saro_gs_torch.render.test_render) end to end
against the JAX package, on the CPU.

Run as a script, this file (re)generates the golden image that both this
test and chip_smoke.py hold the port to: the arena checkpoint rendered by
the JAX package on the CPU at 338x254 from ring camera 0 at ts = 0.5
(backend "jax", packed=False, tight_rect=True, the arena config's 32x32
tiles, every tile's slots kept):

    JAX_PLATFORMS=cpu python -m tests.test_torch_slice

With the argument ``grads`` it (re)generates the second golden, the
gradients of one training view of that checkpoint (see
``make_grads_golden``):

    JAX_PLATFORMS=cpu python -m tests.test_torch_slice grads
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from saro_gs_torch import config as tcfg
from saro_gs_torch import convert
from saro_gs_torch import render as trender
from saro_gs_torch import scene as tscene
from saro_gs_torch.data import cameras as tcams
from saro_gs_torch.models import gaussians as tgm
from saro_gs_tpu import config as jcfg
from saro_gs_tpu import render as jrender
from saro_gs_tpu.models import field as jfield
from saro_gs_tpu.models import gaussians as jgm
from saro_gs_tpu.ops.projection import CameraParams as JCameraParams
from saro_gs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from tests import torch_parity as tgolden
from tests.torch_parity import n, psnr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARENA = os.path.join(ROOT, "checkpoints", "arena")
PLY = os.path.join(ARENA, "point_cloud", "iteration_best", "point_cloud.ply")
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch_arena_338x254.npz")
GRADS_GOLDEN = os.path.join(ROOT, "tests", "golden",
                            "torch_arena_grads_338x254.npz")
GOLDEN_W, GOLDEN_H, GOLDEN_TS, GOLDEN_FOVX = 338, 254, 0.5, 0.85
# the tile size changes the image: the reference's rect ceiling
# (auxiliary.h:46-56, kept by both packages) drops some boundary tiles
# depending on it, so the golden uses the arena config's tiles
GOLDEN_TILE = 32


def _toy(seed=5, count=800):
    """The arena config's model shape, scaled down: planes 16^3 x 8,
    hidden width 32, random (non-zero) planes and weights."""
    over = dict(kplanes_config={"grid_dimensions": 2,
                                "input_coordinate_dim": 4,
                                "output_coordinate_dim": 32,
                                "resolution": [16, 16, 16, 8]},
                deform_hidden_dim=32)
    cj = jcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    ct = tcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    for k, v in over.items():
        setattr(cj, k, v)
        setattr(ct, k, v)
    rng = np.random.RandomState(seed)
    f32 = np.float32
    params = dict(
        xyz=rng.uniform(-1.2, 1.2, (count, 3)).astype(f32),
        features_dc=rng.normal(0, 0.8, (count, 1, 3)).astype(f32),
        features_rest=rng.normal(0, 0.1, (count, 15, 3)).astype(f32),
        scaling=np.log(rng.uniform(0.02, 0.12, (count, 3))).astype(f32),
        rotation=rng.normal(0, 1, (count, 4)).astype(f32),
        opacity=rng.uniform(-2.0, 4.0, (count, 1)).astype(f32),
        temporal_pos=rng.uniform(0, 1, (count, 1)).astype(f32))
    nets = jgm.init_nets(jax.random.PRNGKey(seed), cj.model_config())
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(nets)]
    for i in range(6):
        leaves[i] = rng.normal(0, 0.3, leaves[i].shape).astype(f32)
    fstatic = dict(aabb_min=np.full(3, -1.5, f32),
                   aabb_max=np.full(3, 1.5, f32), duration=f32(50.0))
    return cj, ct, params, leaves, fstatic


def test_toy_slice_matches_jax():
    """test_render in both packages at the arena config's 32x32 tiles and
    at 16x16; also pins that the image depends on the tile size, in both
    packages alike (the reference's rect ceiling, ROADMAP queue 3)."""
    cj, ct, params, leaves, fs = _toy()
    w = h = 64
    ts = 0.5
    cam = tcams.camera_from_c2w(tcams.ring_cameras(21)[0], GOLDEN_FOVX, w,
                                h, ts)
    bg = np.ones(3, np.float32)
    mj = cj.model_config()
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jnets = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jgm.init_nets(jax.random.PRNGKey(0),
                                                   mj)),
        [jnp.asarray(x) for x in leaves])
    jfs = jfield.FieldStatic(**{k: jnp.asarray(v) for k, v in fs.items()})
    tcam = cam.raster_params(device="cpu")
    jcam = JCameraParams(*[jnp.asarray(n(x)) for x in tcam])
    feat = jgm.field_feat(jp, jnets, mj, jfs)
    alive = jnp.ones(len(params["xyz"]), jnp.float32)
    mt = ct.model_config()
    tp, tnets, tfs = convert.jax_to_torch(params, leaves, fs, mt,
                                          device="cpu")
    with torch.no_grad():
        tfeat = tgm.field_feat(tp, tnets, mt, tfs)
    imgs = {}
    for tile in (32, 16):
        rcfg_j = JRasterConfig(tile_x=tile, tile_y=tile,
                               max_instances=1 << 15, max_slots=1024,
                               backend="jax", tight_rect=True)
        a, _ = jrender.test_render(jcam, jnp.float32(ts), jp, jnets, alive,
                                   mj, jfs, jnp.asarray(bg), width=w,
                                   height=h, sh_degree=3, rcfg=rcfg_j,
                                   feat=feat)
        rcfg_t = ct.raster_config()._replace(tile_x=tile, tile_y=tile)
        b, seg = trender.test_render(
            tcam, ts, tp, tnets, torch.ones(len(params["xyz"])), mt, tfs,
            torch.as_tensor(bg), width=w, height=h, sh_degree=3,
            rcfg=rcfg_t, feat=tfeat, require_segment=True)
        assert b.num_dropped == 0 and b.num_instances > 300
        assert float(np.abs(n(a.color) - 1.0).max()) > 0.3   # not blank
        assert psnr(b.color, a.color) >= 60.0
        assert seg.color.shape == (3, h, w)
        assert torch.isfinite(seg.color).all()
        imgs[tile] = (n(a.color), n(b.color))
    jax_gap = np.abs(imgs[32][0] - imgs[16][0]).max()
    port_gap = np.abs(imgs[32][1] - imgs[16][1]).max()
    assert jax_gap > 1e-3 and abs(port_gap - jax_gap) < 1e-4


def test_arena_matches_jax_golden():
    """The real checkpoint, on the CPU through the plain versions, against
    the JAX package's render (the check chip_smoke.py makes on the card)."""
    g = np.load(GOLDEN)
    mt = tcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    mcfg = mt.model_config()
    params, nets, alive, fstatic, _ = tscene.load_gaussian_checkpoint(
        PLY, mcfg, device="cpu")
    cam = tcams.camera_from_c2w(tcams.ring_cameras(21)[0], GOLDEN_FOVX,
                                GOLDEN_W, GOLDEN_H, GOLDEN_TS)
    with torch.no_grad():
        feat = tgm.field_feat(params, nets, mcfg, fstatic)
    out, _ = trender.test_render(
        cam.raster_params(device="cpu"), GOLDEN_TS, params, nets, alive,
        mcfg, fstatic, torch.ones(3), width=GOLDEN_W, height=GOLDEN_H,
        sh_degree=3, rcfg=mt.raster_config(), feat=feat)
    gold = g["color"].astype(np.float32)
    assert mt.raster_config().tile_x == int(g["tile"])
    assert out.num_dropped == 0
    assert psnr(out.color, gold) >= 50.0
    assert float(np.abs(n(out.color) - gold).max()) < 4.0 / 255.0


def make_golden(path=GOLDEN):
    """Render the arena checkpoint with the JAX package on the CPU."""
    from saro_gs_tpu import scene as jscene
    from saro_gs_tpu.ops import binning, projection

    cfg = jcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    mcfg = cfg.model_config()
    tpl = jgm.init_nets(jax.random.PRNGKey(0), mcfg)
    params, nets, alive, fstatic, npts = jscene.load_gaussian_checkpoint(
        PLY, tpl, capacity=None)
    w, h = GOLDEN_W, GOLDEN_H
    cam_np = tcams.camera_from_c2w(tcams.ring_cameras(21)[0], GOLDEN_FOVX,
                                   w, h, GOLDEN_TS).raster_params("cpu")
    cam = projection.CameraParams(*[jnp.asarray(n(x)) for x in cam_np])
    feat = jgm.field_feat(params, nets, mcfg, fstatic)
    # size max_slots from this frame's fullest tile, so no tile's
    # instances are cut
    d = jgm.deform(params, nets, mcfg, fstatic, jnp.float32(GOLDEN_TS),
                   feat=feat)
    active = alive * (d.state[:, 0] > jrender.EVAL_STATE_CUTOFF)
    pre = projection.preprocess(d.xyz, d.scaling, d.rotation,
                                d.opacity.reshape(-1), cam, w, h,
                                GOLDEN_TILE, GOLDEN_TILE, sh_degree=3,
                                shs=d.shs, active=active,
                                tight_rect=True)
    gx, gy = -(-w // GOLDEN_TILE), -(-h // GOLDEN_TILE)
    bins = binning.bin_gaussians(pre, gx, gy, 1 << 21, 64)
    assert int(bins.num_dropped) == 0
    max_slots = int(np.asarray(bins.tile_count).max())
    rcfg = JRasterConfig(tile_x=GOLDEN_TILE, tile_y=GOLDEN_TILE, chunk=64,
                         max_instances=1 << 21, max_slots=max_slots,
                         backend="jax", packed=False, tight_rect=True)
    out, _ = jrender.test_render(cam, jnp.float32(GOLDEN_TS), params, nets,
                                 alive, mcfg, fstatic, jnp.ones(3),
                                 width=w, height=h, sh_degree=3, rcfg=rcfg,
                                 feat=feat)
    color = np.asarray(out.color)
    assert np.isfinite(color).all() and int(out.num_dropped) == 0
    np.savez_compressed(path, color=color.astype(np.float16),
                        width=w, height=h, ts=GOLDEN_TS, fovx=GOLDEN_FOVX,
                        tile=GOLDEN_TILE,
                        camera=0, num_points=npts,
                        num_instances=int(out.num_instances),
                        max_slots=max_slots)
    print(f"wrote {path}: {w}x{h}, {npts} points, "
          f"{int(out.num_instances)} instances, max_slots {max_slots}",
          file=sys.stderr)


def test_arena_gradients_match_jax_golden():
    """The real checkpoint's training gradients for one view, on the CPU
    through the plain versions of all four kernels, against the JAX
    package's (the check chip_smoke.py makes on the card): the loss to
    1e-5, every group's sampled gradients within 0.05 of the group's
    largest entry, its norm within 5%."""
    mt = tcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    params, nets, alive, fstatic, _ = tscene.load_gaussian_checkpoint(
        PLY, mt.model_config(), device="cpu")
    report = tgolden.check_gradients(GRADS_GOLDEN, mt, params, nets, alive,
                                     fstatic, device="cpu")
    assert report["loss_rel_err"] <= 1e-5, report
    assert report["worst_rel_err"] <= 0.05, report
    assert report["worst_norm_rel_err"] <= 0.05, report
    assert len(report["groups"]) >= 8


def make_grads_golden(path=GRADS_GOLDEN):
    """Loss and gradients of one training view of the arena checkpoint by
    the JAX package on the CPU (train/step.py:batch_loss_fn through
    rasterize(backend="jax"), dynamic stage, ring camera 0, ts 0.5,
    338x254, 32x32 tiles, every tile's slots kept, white background, the
    checkpoint's loss weights, seeded uint8 noise as ground truth): the
    loss, each parameter group's gradient norm and largest entry, the
    gradient rows of every 16th Gaussian (every 64th for features_rest),
    of one 16x16 patch of plane 0, and every head gradient's norm."""
    from saro_gs_tpu import scene as jscene
    from saro_gs_tpu.ops import binning, projection
    from saro_gs_tpu.train import step as jstep

    cfg = jcfg.load_cfg_args(os.path.join(ARENA, "cfg_args.json"))
    mcfg = cfg.model_config()
    tpl = jgm.init_nets(jax.random.PRNGKey(0), mcfg)
    params, nets, alive, fstatic, npts = jscene.load_gaussian_checkpoint(
        PLY, tpl, capacity=None)
    w, h = GOLDEN_W, GOLDEN_H
    cam_np = tcams.camera_from_c2w(tcams.ring_cameras(21)[0], GOLDEN_FOVX,
                                   w, h, GOLDEN_TS).raster_params("cpu")
    cam = projection.CameraParams(*[jnp.asarray(n(x)) for x in cam_np])
    d = jgm.deform(params, nets, mcfg, fstatic, jnp.float32(GOLDEN_TS))
    pre = projection.preprocess(d.xyz, d.scaling, d.rotation,
                                d.opacity.reshape(-1), cam, w, h,
                                GOLDEN_TILE, GOLDEN_TILE, sh_degree=3,
                                shs=d.shs, active=alive, tight_rect=True)
    gx, gy = -(-w // GOLDEN_TILE), -(-h // GOLDEN_TILE)
    bins = binning.bin_gaussians(pre, gx, gy, 1 << 21, 64)
    assert int(bins.num_dropped) == 0
    max_slots = int(np.asarray(bins.tile_count).max())
    rcfg = JRasterConfig(tile_x=GOLDEN_TILE, tile_y=GOLDEN_TILE, chunk=64,
                         max_instances=1 << 21, max_slots=max_slots,
                         backend="jax", packed=False, tight_rect=True)
    st = jstep.StepStatics(mcfg=mcfg, rcfg=rcfg, weights=cfg.loss_weights(),
                           width=w, height=h,
                           cfg_lrs=jstep.make_lr_statics(cfg), extent=1.0)
    gt = jnp.asarray(tgolden.noise_gt(1, h, w).astype(np.float32)
                     * np.float32(1.0 / 255.0))
    cams = jax.tree_util.tree_map(lambda x: x[None], cam)
    ts = jnp.full((1, 1, 1), GOLDEN_TS, jnp.float32)

    def loss_fn(points, nets_, m2d):
        return jstep.batch_loss_fn(
            points, nets_, m2d, cams=cams, gt=gt, timestamps=ts,
            alive=alive, bg=jnp.ones(3), fstatic=fstatic, st=st,
            stage="dynamatic", sh_degree=3)

    (loss, _), (g_pts, g_nets, g_m2d) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1, 2), has_aux=True))(
        params, nets, jnp.zeros((1, npts, 2), jnp.float32))
    groups = {k: np.asarray(v) for k, v in g_pts._asdict().items()}
    groups["mean2d"] = np.asarray(g_m2d[0])
    leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(g_nets)]
    out = tgolden.summarize(float(loss), groups, leaves)
    assert all(np.isfinite(v).all() for v in out.values())
    np.savez_compressed(path, width=w, height=h, ts=GOLDEN_TS,
                        fovx=GOLDEN_FOVX, tile=GOLDEN_TILE, camera=0,
                        num_points=npts, max_slots=max_slots, **out)
    print(f"wrote {path}: loss {float(loss):.8f}, max_slots {max_slots}, "
          f"{os.path.getsize(path)} bytes", file=sys.stderr)


if __name__ == "__main__":
    if sys.argv[1:] == ["grads"]:
        make_grads_golden()
    else:
        make_golden()
