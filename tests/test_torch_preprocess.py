"""saro_gs_torch preprocess (math3d, sh, projection) and cameras against
the JAX package, on the same seeded numpy inputs."""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.data import cameras as tcams
from saro_gs_torch.ops import math3d as tm3d
from saro_gs_torch.ops import projection as tproj
from saro_gs_tpu.ops import math3d as jm3d
from saro_gs_tpu.ops import projection as jproj
from tests.scene_fixtures import make_camera, make_gaussians
from tests.torch_parity import n, t, torch_cam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FLOAT_FIELDS = ("depth", "mean_x", "mean_y", "conic_a", "conic_b",
                "conic_c")
INT_FIELDS = ("radii", "rmin_x", "rmin_y", "rmax_x", "rmax_y",
              "tiles_touched", "mask")


def _scene(rng, count=800):
    cam, meta = make_camera(64, 64)
    means, scales, quats, opac, shs = make_gaussians(rng, n=count)
    # low-opacity splats (tight rects shrink hard), one below 1/255, and a
    # few points behind the camera
    opac[::5] = 0.02
    opac[7] = 0.003
    means[::97, 2] = -5.0
    return cam, meta, means, scales, quats, opac, shs


@pytest.mark.parametrize("tight", [False, True])
def test_preprocess_matches_jax(rng, tight):
    cam, meta, means, scales, quats, opac, shs = _scene(rng)
    w, h = meta["width"], meta["height"]
    active = (rng.uniform(size=means.shape[0]) > 0.05).astype(np.float32)
    a = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                         jnp.asarray(quats), jnp.asarray(opac), cam, w, h,
                         16, 16, sh_degree=3, shs=jnp.asarray(shs),
                         active=jnp.asarray(active), tight_rect=tight)
    b = tproj.preprocess(t(means), t(scales), t(quats), t(opac),
                         torch_cam(cam), w, h, 16, 16, sh_degree=3,
                         shs=t(shs), active=t(active), tight_rect=tight)
    for f in INT_FIELDS:
        np.testing.assert_array_equal(n(getattr(b, f)), n(getattr(a, f)),
                                      err_msg=f)
    m = n(b.mask)
    assert m.sum() > 100 and (~m).sum() > 0
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(n(getattr(b, f))[m], n(getattr(a, f))[m],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_allclose(n(b.rgb)[m], n(a.rgb)[m], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(n(b.clamped), n(a.clamped))


def test_colors_precomp_path(rng):
    cam, meta, means, scales, quats, opac, _ = _scene(rng, count=200)
    cols = rng.uniform(0, 1, (means.shape[0], 3)).astype(np.float32)
    w, h = meta["width"], meta["height"]
    a = jproj.preprocess(jnp.asarray(means), jnp.asarray(scales),
                         jnp.asarray(quats), jnp.asarray(opac), cam, w, h,
                         32, 32, colors_precomp=jnp.asarray(cols),
                         tight_rect=True)
    b = tproj.preprocess(t(means), t(scales), t(quats), t(opac),
                         torch_cam(cam), w, h, 32, 32, colors_precomp=t(cols),
                         tight_rect=True)
    np.testing.assert_array_equal(n(b.tiles_touched), n(a.tiles_touched))
    np.testing.assert_array_equal(n(b.rgb), n(a.rgb))


def test_cov_and_quat_math(rng):
    s = rng.uniform(0.01, 0.5, (64, 3)).astype(np.float32)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    np.testing.assert_allclose(n(tm3d.quat_normalize(t(q))),
                               n(jm3d.quat_normalize(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-7)
    c6 = tm3d.build_cov3d(t(s), 1.0, t(q))
    np.testing.assert_allclose(
        n(c6), n(jm3d.build_cov3d(jnp.asarray(s), 1.0, jnp.asarray(q))),
        rtol=1e-6, atol=1e-7)
    cam, meta = make_camera(64, 48)
    m = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    tc = torch_cam(cam)
    fx = tm3d.fov2focal(2 * math.atan(meta["tanfovx"]), 64)
    fy = tm3d.fov2focal(2 * math.atan(meta["tanfovy"]), 48)
    a = jm3d.compute_cov2d(jnp.asarray(m), fx, fy, cam.tanfovx, cam.tanfovy,
                           jnp.asarray(n(c6)), jnp.asarray(cam.viewmat))
    b = tm3d.compute_cov2d(t(m), fx, fy, tc.tanfovx, tc.tanfovy, c6,
                           tc.viewmat)
    np.testing.assert_allclose(n(b), n(a), rtol=1e-5, atol=1e-6)


def test_cameras_match_reference_rig():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import make_synth_scene as mss
    finally:
        sys.path.pop(0)
    for a, b in zip(mss.ring_cameras(21), tcams.ring_cameras(21)):
        np.testing.assert_array_equal(a, b)
    c2w = mss.ring_cameras(21)[0]
    ja = mss.camera_from_c2w(c2w, 0.85, 338, 254, 0.5).raster_params()
    tb = tcams.camera_from_c2w(c2w, 0.85, 338, 254, 0.5).raster_params(
        device="cpu")
    for x, y in zip(ja, tb):
        np.testing.assert_array_equal(n(y), np.asarray(x, np.float32))
    assert tb.viewmat.dtype == torch.float32
    np.testing.assert_array_equal(
        tm3d.projection_matrix(0.01, 100.0, 0.9, 0.7, 0.1, -0.05),
        jm3d.projection_matrix(0.01, 100.0, 0.9, 0.7, 0.1, -0.05))
