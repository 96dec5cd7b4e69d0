"""The port's public surface off the main path against the JAX package's,
on the cases of tests/test_aux_data.py, tests/test_math3d.py and
tests/test_field.py: COLMAP preprocessing, the visual helpers, the
HyperNeRF reader and its registry entry, ``mark_visible``, ``Camerass``,
the math3d row helpers and ``convert_coarse_to_fine``.

Host-side numpy code is held to the JAX package's output exactly; float32
tensor arithmetic within 1e-6 (one rounding of a 4-term dot product).
"""
import os
import shutil
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from saro_gs_torch.data import cameras as tcameras
from saro_gs_torch.data import colmap as tcolmap
from saro_gs_torch.data import preprocess as tpre
from saro_gs_torch.data import readers as treaders
from saro_gs_torch.models import field as tfield
from saro_gs_torch.ops import math3d as tm3
from saro_gs_torch.ops import projection as tproj
from saro_gs_torch.utils import visual as tvis
from saro_gs_tpu.data import cameras as jcameras
from saro_gs_tpu.data import preprocess as jpre
from saro_gs_tpu.data import readers as jreaders
from saro_gs_tpu.models import field as jfield
from saro_gs_tpu.ops import math3d as jm3
from saro_gs_tpu.ops import projection as jproj
from saro_gs_tpu.utils import visual as jvis
from tests import test_aux_data as jaux
from tests.scene_fixtures import make_camera

F32 = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


# ---------------------------------------------------------------- preprocess

def _poses_bounds(n=3):
    return jaux.TestPreprocess()._poses_bounds(None, n)


def test_llff_conversion_matches_jax():
    pb = _poses_bounds()
    mine, theirs = tpre.llff_poses_to_colmap(pb), jpre.llff_poses_to_colmap(pb)
    assert len(mine) == len(theirs) == 3
    for (q, t, focal, h, w), ref, row in zip(mine, theirs, pb):
        np.testing.assert_array_equal(q, ref[0])
        np.testing.assert_array_equal(t, ref[1])
        assert (focal, h, w) == ref[2:] == (500.0, 480, 640)
        # the camera centre -R^T t is the LLFF position
        R = tcolmap.qvec2rotmat(q)
        np.testing.assert_allclose(-R.T @ t, row[:15].reshape(3, 5)[:, 3],
                                   atol=1e-6)


def test_write_frame_model_matches_jax(tmp_path):
    pb = _poses_bounds()
    names = [f"cam{i:02d}.png" for i in range(3)]
    mine = tpre.write_frame_model(str(tmp_path / "t" / "colmap_0"), pb,
                                  names)
    theirs = jpre.write_frame_model(str(tmp_path / "j" / "colmap_0"), pb,
                                    names)
    for f in ("cameras.txt", "images.txt", "points3D.txt"):
        with open(os.path.join(mine[1], f)) as a, \
                open(os.path.join(theirs[1], f)) as b:
            assert a.read() == b.read(), f
    rows = []
    for db in (mine[0], theirs[0]):
        conn = sqlite3.connect(db)
        try:
            rows.append([conn.execute(f"SELECT * FROM {t}").fetchall()
                         for t in ("cameras", "images")])
        finally:
            conn.close()
    assert rows[0] == rows[1]
    cams, imgs = rows[0]
    assert len(cams) == 3 and len(imgs) == 3
    assert all(c[1] == 1 and c[2] == 640 and c[3] == 480 for c in cams)
    assert not any(np.isnan(i[3]) for i in imgs)
    # the manual model reads back through the port's text readers
    tcams = tcolmap.read_cameras_text(os.path.join(mine[1], "cameras.txt"))
    timgs = tcolmap.read_images_text(os.path.join(mine[1], "images.txt"))
    assert len(tcams) == 3 and tcams[1].model == "PINHOLE"
    assert len(timgs) == 3 and timgs[1].name == "cam00.png"
    with pytest.raises(ValueError, match="poses"):
        tpre.write_frame_model(str(tmp_path / "x"), pb, names[:2])


def test_missing_binary_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="colmap"):
        tpre.run_colmap_frame(str(tmp_path), 0)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tpre.extract_frames("x.mp4", str(tmp_path), 0, 1)
    # the prep entry point reaches the same gate
    from saro_gs_torch import prep
    np.save(tmp_path / "poses_bounds.npy", _poses_bounds(1))
    (tmp_path / "cam00.mp4").write_bytes(b"")
    with pytest.raises(RuntimeError, match="ffmpeg"):
        prep.main(["--videopath", str(tmp_path), "--duration", "1"])


# -------------------------------------------------------------------- visual

def test_quat_and_slerp_match_jax(rng):
    for _ in range(20):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        R = tvis._mat_from_quat(q)
        np.testing.assert_array_equal(R, jvis._mat_from_quat(q))
        q2 = tvis._quat_from_mat(R)
        np.testing.assert_array_equal(q2, jvis._quat_from_mat(R))
        np.testing.assert_allclose(q * np.sign(np.dot(q, q2)), q2,
                                   atol=1e-8)
    q0, q1 = rng.randn(2, 4)
    q0 /= np.linalg.norm(q0)
    q1 /= np.linalg.norm(q1)
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(tvis.slerp(q0, q1, t),
                                      jvis.slerp(q0, q1, t))
    np.testing.assert_allclose(tvis.slerp(q0, q1, 0.0), q0, atol=1e-9)


def test_pose_smoothing_and_averaging_match_jax(rng):
    n = 30
    noisy = np.eye(4)[None].repeat(n, 0)
    noisy[:, 0, 3] = np.linspace(0, 1, n) + rng.randn(n) * 0.05
    out = tvis.smooth_camera_poses(noisy, window=5)
    np.testing.assert_array_equal(out, jvis.smooth_camera_poses(noisy, 5))

    def jitter(p):
        return np.abs(np.diff(p[:, 0, 3], 2)).mean()
    assert jitter(out) < jitter(noisy)
    still = np.eye(4)[None].repeat(7, 0)
    np.testing.assert_allclose(tvis.smooth_camera_poses(still), still,
                               atol=1e-9)
    c2ws = np.stack([np.eye(4)] * 4)
    c2ws[:, :3, 3] = rng.randn(4, 3)
    np.testing.assert_array_equal(tvis.average_pose(c2ws),
                                  jvis.average_pose(c2ws))
    rec = tvis.recenter_poses(c2ws)
    np.testing.assert_array_equal(rec, jvis.recenter_poses(c2ws))
    np.testing.assert_allclose(rec[:, :3, 3].mean(0), 0, atol=1e-9)


def test_rgbd_frustum_and_ply_match_jax(tmp_path, rng):
    h, w, f = 8, 8, 4.0
    color = rng.rand(3, h, w)
    depth = np.full((h, w), 2.0)
    depth[0, 0] = 15.0     # not hit: dropped
    c2w = np.eye(4)
    c2w[:3, 3] = [0.5, -1.0, 2.0]
    for kw in ({}, {"c2w": c2w, "stride": 2}):
        xyz, rgb = tvis.rgbd_to_pointcloud(color, depth, f, f, **kw)
        ref = jvis.rgbd_to_pointcloud(color, depth, f, f, **kw)
        np.testing.assert_array_equal(xyz, ref[0])
        np.testing.assert_array_equal(rgb, ref[1])
    xyz, _ = tvis.rgbd_to_pointcloud(color, depth, f, f)
    assert xyz.shape[0] == h * w - 1 and np.allclose(xyz[:, 2], 2.0)
    c2ws = np.stack([np.eye(4)] * 3)
    c2ws[:, :3, 3] = rng.randn(3, 3)
    pts, lines = tvis.camera_frustum_lineset(c2ws)
    ref = jvis.camera_frustum_lineset(c2ws)
    assert pts.shape == (15, 3) and lines.shape == (24, 2)
    np.testing.assert_array_equal(pts, ref[0])
    np.testing.assert_array_equal(lines, ref[1])
    a, b = rng.rand(10, 3), rng.rand(10, 3)
    tvis.save_pointcloud_ply(str(tmp_path / "t.ply"), a, b)
    jvis.save_pointcloud_ply(str(tmp_path / "j.ply"), a, b)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    assert b"element vertex 10" in (tmp_path / "t.ply").read_bytes()


# ----------------------------------------------------------------- hypernerf

def _same_cameras(mine, theirs, root_a, root_b):
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert (a.uid, a.width, a.height, a.image_name) == \
            (b.uid, b.width, b.height, b.image_name)
        assert os.path.relpath(a.image_path, root_a) == \
            os.path.relpath(b.image_path, root_b)
        assert (a.fovx, a.fovy, a.timestamp) == (b.fovx, b.fovy,
                                                 b.timestamp)
        for k in ("R", "T", "world_view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                          err_msg=k)


@pytest.mark.parametrize("cloud", ["random", "points_npy"])
def test_hypernerf_matches_jax(cloud, tmp_path, rng):
    """The fabricated layout of tests/test_aux_data.py through both
    readers, each in its own copy of the scene: cameras, timestamps and
    the init cloud (100,000 RandomState(666) points, or points.npy) equal
    to the JAX package's."""
    from saro_gs_torch.data.hypernerf import read_hypernerf_scene
    from saro_gs_tpu.data.hypernerf import read_hypernerf_scene as jread
    root = tmp_path / "t"
    jaux.TestHyperNerf()._make_scene(root, rng)
    if cloud == "points_npy":
        np.save(root / "points.npy", rng.randn(500, 3))
    shutil.copytree(root, tmp_path / "j")
    mine = read_hypernerf_scene(str(root), resolution=2)
    theirs = jread(str(tmp_path / "j"), resolution=2)
    assert len(mine.train_cameras) == 4 and len(mine.test_cameras) == 2
    cam = mine.train_cameras[0]
    assert (cam.width, cam.height) == (320, 240)
    assert abs(np.linalg.norm(cam.camera_center) - 4.0) < 1e-3
    assert [c.timestamp for c in mine.train_cameras + mine.test_cameras] \
        == [i / 5 for i in range(6)]
    for split in ("train_cameras", "test_cameras"):
        _same_cameras(getattr(mine, split), getattr(theirs, split), root,
                      tmp_path / "j")
    assert mine.nerf_radius == theirs.nerf_radius
    np.testing.assert_array_equal(mine.nerf_translate, theirs.nerf_translate)
    assert (root / "points3d_init.ply").read_bytes() == \
        (tmp_path / "j" / "points3d_init.ply").read_bytes()
    n = 100_000 if cloud == "random" else 500
    for k in ("points", "colors", "times"):
        a, b = getattr(mine.point_cloud, k), getattr(theirs.point_cloud, k)
        assert a.shape[0] == n
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(cam.load_image(),
                                  theirs.train_cameras[0].load_image())


def test_hypernerf_registered():
    assert set(treaders.SCENE_READERS) == set(jreaders.SCENE_READERS) == {
        "colmap", "blender", "hypernerf"}


# ------------------------------------------------------- cameras, projection

def test_mark_visible_matches_jax(rng):
    jcam, _ = make_camera(cam_z=-4.0)
    tcam = tproj.CameraParams(*[_t(x) for x in jcam])
    pts = np.array([[0.0, 0.0, 0.0],      # in front (view z 4)
                    [0.0, 0.0, -3.9],     # z 0.1: culled (<= 0.2)
                    [0.0, 0.0, -10.0]],   # behind
                   np.float32)
    assert tproj.mark_visible(_t(pts), tcam).tolist() == [True, False,
                                                          False]
    many = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tproj.mark_visible(_t(many), tcam).numpy(),
        np.asarray(jproj.mark_visible(jnp.asarray(many), jcam)))


def test_camerass_matches_jax():
    """2x the size, rays equal to the JAX package's, re-projecting through
    full_proj onto their own pixel centres (tests/test_aux_data.py)."""
    rng = np.random.RandomState(3)
    th = 0.4
    c, s = np.cos(th), np.sin(th)
    kw = dict(uid=0, R=np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]),
              T=np.array([0.1, -0.2, 4.0]), fovx=1.0, fovy=0.8, width=32,
              height=24, timestamp=0.3)
    cam, ref = tcameras.Camerass(**kw), jcameras.Camerass(**kw)
    assert (cam.width, cam.height) == (ref.width, ref.height) == (64, 48)
    assert (cam.base_width, cam.base_height) == (32, 24)
    assert cam.rayd.shape == (1, 3, 48, 64)
    np.testing.assert_array_equal(cam.rayd, ref.rayd)
    np.testing.assert_array_equal(cam.rayo, ref.rayo)
    np.testing.assert_allclose(cam.rayo[0, :, 0, 0], cam.camera_center,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(cam.rayd, axis=1), 1.0,
                               atol=1e-5)
    for _ in range(20):
        i, j = rng.randint(cam.height), rng.randint(cam.width)
        p = np.append(cam.rayo[0, :, i, j].astype(np.float64)
                      + 3.0 * cam.rayd[0, :, i, j].astype(np.float64), 1.0)
        assert (p @ cam.world_view.astype(np.float64))[2] > 0
        clip = p @ cam.full_proj.astype(np.float64)
        np.testing.assert_allclose(
            clip[:2] / clip[3], [(2 * j + 1) / cam.width - 1,
                                 (2 * i + 1) / cam.height - 1], atol=1e-5)


def test_camerass_loads_ground_truth_at_base_size(tmp_path, rng):
    from PIL import Image
    path = str(tmp_path / "g.png")
    Image.fromarray((rng.rand(24, 32, 3) * 255).astype(np.uint8)).save(path)
    kw = dict(uid=0, R=np.eye(3), T=np.array([0, 0, 4.0]), fovx=1.0,
              fovy=0.8, width=32, height=24, image_path=path)
    img = tcameras.Camerass(**kw).load_image()
    assert img.shape == (3, 24, 32)
    np.testing.assert_array_equal(img, jcameras.Camerass(**kw).load_image())


# -------------------------------------------------------------------- math3d

def test_world_to_view_roundtrip():
    R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=float)
    m = tm3.world_to_view_matrix(R, np.array([0.3, -0.2, 2.0]))
    center = np.linalg.inv(m.astype(np.float64))[3, :3]
    out = tm3.transform_point_4x3(_t(center), _t(m))
    np.testing.assert_allclose(out.numpy(), 0.0, atol=1e-5)


def test_row_helpers_match_jax(rng):
    jcam, _ = make_camera()
    pts = rng.uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
    quats = rng.normal(0, 1, (2, 16, 4)).astype(np.float32)
    c6 = rng.normal(0, 1, (16, 6)).astype(np.float32)
    cases = [
        (tm3.transform_point_4x3(_t(pts), _t(jcam.viewmat)),
         jm3.transform_point_4x3(jnp.asarray(pts), jnp.asarray(jcam.viewmat))),
        (tm3.transform_point_4x4(_t(pts), _t(jcam.projmat)),
         jm3.transform_point_4x4(jnp.asarray(pts), jnp.asarray(jcam.projmat))),
        (tm3.project_points(_t(pts), _t(jcam.projmat)),
         jm3.project_points(jnp.asarray(pts), jnp.asarray(jcam.projmat))),
        (tm3.quat_to_rotmat_raw(_t(quats)),
         jm3.quat_to_rotmat_raw(jnp.asarray(quats))),
        (tm3.unpack_sym3(_t(c6)), jm3.unpack_sym3(jnp.asarray(c6))),
    ]
    for mine, theirs in cases:
        assert tuple(mine.shape) == tuple(theirs.shape)
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **F32)
    # the stacked rotation is the column form's, and unpack_sym3 symmetric
    r = tm3.quat_to_rotmat_raw(_t(quats[0]))
    cols = tm3.quat_to_rotmat_cols(*_t(quats[0]).unbind(-1))
    np.testing.assert_array_equal(r.reshape(16, 9).numpy(),
                                  torch.stack(cols, -1).numpy())
    s = tm3.unpack_sym3(_t(c6))
    assert torch.equal(s, s.transpose(-1, -2))


# --------------------------------------------------------------------- field

def test_convert_coarse_to_fine_matches_jax(rng):
    """tests/test_field.py's cases (same aabb and size: a copy; 8 -> 16:
    nearest upsampling; a shrunk aabb: its sub-window), each plane equal
    to the JAX package's."""
    coarse = dict(resolution=(8, 8, 8, 5), out_dim=3, multires=(1,))
    fine = dict(resolution=(16, 16, 16, 5), out_dim=3, multires=(1,))
    old = [[rng.standard_normal(p.shape).astype(np.float32) for p in planes]
           for planes in jfield.init_field(jfield.FieldConfig(**coarse))]
    old_t = [torch.as_tensor(p) for planes in old for p in planes]
    old_j = [[jnp.asarray(p) for p in planes] for planes in old]

    def statics(lo, hi):
        return (tfield.FieldStatic(_t([lo] * 3), _t([hi] * 3), _t(10)),
                jfield.make_static([lo] * 3, [hi] * 3, 10))
    st, jst = statics(-1.0, 1.0)
    st2, jst2 = statics(-0.5, 0.5)
    for cfg, (new_st, new_jst) in ((coarse, (st, jst)), (fine, (st, jst)),
                                   (coarse, (st2, jst2))):
        mine = tfield.convert_coarse_to_fine(tfield.FieldConfig(**cfg),
                                             new_st, old_t, st)
        theirs = jfield.convert_coarse_to_fine(jfield.FieldConfig(**cfg),
                                               new_jst, old_j, jst)[0]
        assert len(mine) == len(theirs) == 6
        for ci, (a, b) in enumerate(tfield.COMBS):
            reso = tfield.FieldConfig(**cfg).reso(1)
            assert tuple(mine[ci].shape) == (3, reso[b], reso[a])
            np.testing.assert_array_equal(mine[ci].numpy(),
                                          np.asarray(theirs[ci]))
    same = tfield.convert_coarse_to_fine(tfield.FieldConfig(**coarse), st,
                                         old_t, st)
    for p_new, p_old in zip(same, old_t):
        assert torch.equal(p_new, p_old)
    # the new planes load into a HexPlaneField of the fine config
    field = tfield.HexPlaneField(tfield.FieldConfig(**fine))
    with torch.no_grad():
        for p, new in zip(field.planes, tfield.convert_coarse_to_fine(
                tfield.FieldConfig(**fine), st, field.planes, st)):
            p.copy_(new)


def test_hypernerf_scene_through_the_port_scene(tmp_path, rng):
    """The registry entry drives the port's Scene: a HyperNeRF config
    loads its cameras and its points.npy cloud on the CPU."""
    from saro_gs_torch.config import load_config
    from saro_gs_torch.scene import Scene
    jaux.TestHyperNerf()._make_scene(tmp_path, rng)
    np.save(tmp_path / "points.npy", rng.randn(300, 3))
    cfg = load_config(source_path=str(tmp_path), loader="hypernerf",
                      resolution=2, model_path=str(tmp_path / "m"),
                      preprocesspoints=0)
    scene = Scene(cfg, device="cpu")
    assert len(scene.info.train_cameras) == 4
    assert len(scene.test_cameras()) == 2
    assert int((scene.alive > 0).sum()) == 300
