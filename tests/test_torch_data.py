"""The port's data modules against the JAX package's: PLY files (bytes
both ways), COLMAP readers and writers, both scene readers on fabricated
layouts (tests/test_readers.py's Neural3D layout, tests/test_e2e_train.py's
Blender scene), point-cloud preprocessing and the batch loader."""
import os
import shutil

import numpy as np
import pytest
import torch

from saro_gs_torch.data import colmap as tcolmap
from saro_gs_torch.data import dataset as tdataset
from saro_gs_torch.data import ply as tply
from saro_gs_torch.data import pointcloud as tpc
from saro_gs_torch.data import readers as treaders
from saro_gs_torch.models import gaussians as tgm
from saro_gs_tpu.data import colmap as jcolmap
from saro_gs_tpu.data import dataset as jdataset
from saro_gs_tpu.data import ply as jply
from saro_gs_tpu.data import pointcloud as jpc
from saro_gs_tpu.data import readers as jreaders
from saro_gs_tpu.models import gaussians as jgm
from tests.test_e2e_train import DURATION, _write_scene
from tests.test_readers import DURATION as N3D_DURATION
from tests.test_readers import neural3d_dir  # noqa: F401  (fixture)
from tests.torch_parity import n

CAM_FIELDS = ("uid", "fovx", "fovy", "width", "height", "timestamp",
              "image_name")


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same_cameras(a, b, with_paths=True):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in CAM_FIELDS:
            assert getattr(x, f) == getattr(y, f), f
        np.testing.assert_array_equal(x.R, y.R)
        np.testing.assert_array_equal(x.T, y.T)
        np.testing.assert_array_equal(x.full_proj, y.full_proj)
        np.testing.assert_array_equal(x.camera_center, y.camera_center)
        if with_paths:
            assert x.image_path == y.image_path


def _same_point_clouds(a, b):
    for f in ("points", "colors", "times"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_gaussian_ply_bytes_both_ways(tmp_path):
    rng = np.random.RandomState(1)
    n = 57
    arrays = (rng.normal(size=(n, 3)), rng.normal(size=(n, 1, 3)),
              rng.normal(size=(n, 15, 3)), rng.normal(size=(n, 1)),
              rng.normal(size=(n, 3)), rng.normal(size=(n, 4)),
              rng.uniform(size=(n, 1)))
    arrays = [a.astype(np.float32) for a in arrays]
    tply.save_gaussian_ply(str(tmp_path / "t.ply"), *arrays)
    jply.save_gaussian_ply(str(tmp_path / "j.ply"), *arrays)
    assert _read(tmp_path / "t.ply") == _read(tmp_path / "j.ply")
    a = jply.load_gaussian_ply(str(tmp_path / "t.ply"))
    b = tply.load_gaussian_ply(str(tmp_path / "j.ply"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(b["f_rest"], arrays[2])

    xyzt = rng.normal(size=(n, 4))
    rgb = rng.uniform(0, 255, (n, 3))
    tply.store_point_cloud(str(tmp_path / "tp.ply"), xyzt, rgb)
    jply.store_point_cloud(str(tmp_path / "jp.ply"), xyzt, rgb)
    assert _read(tmp_path / "tp.ply") == _read(tmp_path / "jp.ply")
    for x, y in zip(tply.fetch_point_cloud(str(tmp_path / "jp.ply")),
                    jply.fetch_point_cloud(str(tmp_path / "tp.ply"))):
        np.testing.assert_array_equal(x, y)


def test_colmap_readers_and_writers(tmp_path, neural3d_dir):  # noqa: F811
    sparse = os.path.join(neural3d_dir, "sparse", "0")
    for name in ("cameras", "images", "points3d"):
        path = os.path.join(sparse, f"{name.replace('points3d', 'points3D')}"
                            ".bin")
        a = getattr(jcolmap, f"read_{name}_binary")(path)
        b = getattr(tcolmap, f"read_{name}_binary")(path)
        if name == "points3d":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            continue
        assert a.keys() == b.keys()
        for k in a:
            for f in a[k]._fields:
                x, y = getattr(a[k], f), getattr(b[k], f)
                if f in ("xys", "point3D_ids"):
                    continue
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    cams = tcolmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    images = tcolmap.read_images_binary(os.path.join(sparse, "images.bin"))
    tcolmap.write_cameras_binary(cams, str(tmp_path / "c_t.bin"))
    jcolmap.write_cameras_binary(cams, str(tmp_path / "c_j.bin"))
    tcolmap.write_images_binary(images, str(tmp_path / "i_t.bin"))
    jcolmap.write_images_binary(images, str(tmp_path / "i_j.bin"))
    assert _read(tmp_path / "c_t.bin") == _read(tmp_path / "c_j.bin")
    assert _read(tmp_path / "i_t.bin") == _read(tmp_path / "i_j.bin")
    r = np.linalg.qr(np.random.RandomState(2).normal(size=(3, 3)))[0]
    np.testing.assert_array_equal(tcolmap.rotmat2qvec(r),
                                  jcolmap.rotmat2qvec(r))

    # the text variants
    (tmp_path / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 64 48 60 61 32 24\n2 SIMPLE_PINHOLE 8 6 5 4 3\n")
    (tmp_path / "images.txt").write_text(
        "# comment\n1 1 0 0 0 0.1 0.2 4 1 a.png\n\n"
        "2 0.5 0.5 0.5 0.5 1 2 3 2 b.png\n1.0 2.0 -1\n")
    (tmp_path / "points3D.txt").write_text(
        "# comment\n1 0.1 0.2 0.3 10 20 30 0.5 1 2\n2 1 2 3 4 5 6 0.1\n")
    for name in ("cameras", "images", "points3d"):
        path = str(tmp_path / f"{name.replace('points3d', 'points3D')}.txt")
        a = getattr(jcolmap, f"read_{name}_text")(path)
        b = getattr(tcolmap, f"read_{name}_text")(path)
        if name == "points3d":
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            continue
        assert a.keys() == b.keys()
        for k in a:
            for x, y in zip(a[k], b[k]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_colmap_scene_reader_matches_jax(tmp_path,
                                         neural3d_dir):  # noqa: F811
    """Both readers on their own copy of one Neural3D layout: cameras,
    splits, radius and translate, the merged cloud (its file byte for
    byte) and the spiral validation path."""
    scene = os.path.dirname(neural3d_dir)
    copy = str(tmp_path / "copy")
    shutil.copytree(scene, copy)
    a = jreaders.read_colmap_scene(neural3d_dir, duration=N3D_DURATION,
                                   resolution=2)
    b = treaders.read_colmap_scene(os.path.join(copy, "colmap_0"),
                                   duration=N3D_DURATION, resolution=2)
    for split in ("train_cameras", "test_cameras"):
        _same_cameras(getattr(a, split), getattr(b, split), with_paths=False)
        assert [c.image_path.replace(scene, copy)
                for c in getattr(a, split)] == [
            c.image_path for c in getattr(b, split)]
    _same_cameras(a.val_cameras, b.val_cameras)
    assert len(b.val_cameras) == 300
    assert a.nerf_radius == b.nerf_radius
    np.testing.assert_array_equal(a.nerf_translate, b.nerf_translate)
    _same_point_clouds(a.point_cloud, b.point_cloud)
    assert _read(a.ply_path) == _read(b.ply_path)


def test_blender_reader_and_loader_match_jax(tmp_path):
    """Both Blender readers on their own copy of the toy scene (the random
    init cloud written byte for byte alike), one image decoded alike, and
    three epochs of the loader: the same indices, ground truth and
    cameras for the same seed."""
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    _write_scene(a_dir, np.random.RandomState(7))
    shutil.copytree(a_dir, b_dir)
    a = jreaders.read_blender_scene(a_dir, duration=DURATION, resolution=1)
    b = treaders.read_blender_scene(b_dir, duration=DURATION, resolution=1)
    _same_cameras(a.train_cameras, b.train_cameras, with_paths=False)
    _same_cameras(a.test_cameras, b.test_cameras, with_paths=False)
    assert a.nerf_radius == b.nerf_radius
    _same_point_clouds(a.point_cloud, b.point_cloud)
    assert _read(a.ply_path) == _read(b.ply_path)
    assert not [f for f in os.listdir(b_dir) if f.endswith(".tmp")]
    # both packages decode through the native library: the same bits
    np.testing.assert_array_equal(b.test_cameras[1].load_image(),
                                  a.test_cameras[1].load_image())

    bs = 2
    la = jdataset.BatchLoader(a.train_cameras, bs, num_workers=2, seed=11)
    lb = tdataset.BatchLoader(b.train_cameras, bs, num_workers=2, seed=11)
    try:
        per_epoch = len(a.train_cameras) // bs
        for k, (x, y) in enumerate(zip(la, lb)):
            if k == 3 * per_epoch:
                break
            np.testing.assert_array_equal(x.indices, y.indices)
            np.testing.assert_array_equal(x.gt, y.gt)
            assert y.gt.dtype == np.uint8
            np.testing.assert_array_equal(x.timestamps, y.timestamps)
            for f in x.cams._fields:
                np.testing.assert_array_equal(np.asarray(getattr(x.cams, f)),
                                              getattr(y.cams, f))
    finally:
        lb.close()


def test_held_uint8_ground_truth(tmp_path):
    """A uint8 image given to set_image (what an in-memory scene of many
    views holds: a quarter of float32's bytes) reaches the loader's batch
    as it is, and load_image decodes it as x / 255 in float32, as the
    train step does; a float image goes on being rounded to uint8."""
    d = str(tmp_path / "s")
    _write_scene(d, np.random.RandomState(7))
    cams = treaders.read_blender_scene(d, duration=DURATION,
                                       resolution=1).train_cameras[:2]
    rng = np.random.RandomState(3)
    u8 = (rng.uniform(0, 1, (3, cams[0].height, cams[0].width)) * 255
          ).astype(np.uint8)
    f32 = rng.uniform(0, 1, u8.shape).astype(np.float32)
    cams[0].set_image(u8)
    cams[1].set_image(f32)
    img = cams[0].load_image()
    assert img.dtype == np.float32
    np.testing.assert_array_equal(
        img, n(torch.as_tensor(u8).to(torch.float32) * (1.0 / 255.0)))
    loader = tdataset.BatchLoader(cams, 2, shuffle=False, num_workers=1)
    try:
        gt = next(iter(loader)).gt
    finally:
        loader.close()
    assert gt.dtype == np.uint8
    np.testing.assert_array_equal(gt[0], u8)
    np.testing.assert_array_equal(
        gt[1], np.clip(f32 * 255.0 + 0.5, 0, 255).astype(np.uint8))


def _cloud(seed, n=900, stamps=6):
    rng = np.random.RandomState(seed)
    return dict(points=rng.normal(0, 40, (n, 3)) + [0, 0, 120],
                colors=rng.uniform(0, 1, (n, 3)),
                times=(rng.randint(0, stamps, (n, 1)) / stamps))


@pytest.mark.parametrize("mode", [0, 3, 31, 4, 2])
def test_preprocess_points_matches_jax(mode):
    d = _cloud(4)
    a = jpc.preprocess_points(jgm.PointCloud(**d), mode)
    b = tpc.preprocess_points(tgm.PointCloud(**d), mode, device="cpu")
    _same_point_clouds(a, b)
    if mode in (31, 4, 2):
        assert b.points.shape[0] < d["points"].shape[0]


def test_point_cloud_parts_match_jax():
    d = _cloud(5)
    _same_point_clouds(jpc.prune_max_z(jgm.PointCloud(**d), 150.0),
                       tpc.prune_max_z(tgm.PointCloud(**d), 150.0))
    _same_point_clouds(jpc.add_sky_points(jgm.PointCloud(**d), 50),
                       tpc.add_sky_points(tgm.PointCloud(**d), 50))
    nt = dict(d, times=None)
    _same_point_clouds(jpc.sparsify(jgm.PointCloud(**nt), 3),
                       tpc.sparsify(tgm.PointCloud(**nt), 3, device="cpu"))
    pts = d["points"][:200]
    np.testing.assert_allclose(tpc._nn_distance(pts, torch.device("cpu")),
                               jpc._nn_distance(pts), rtol=1e-6)


def test_camera_helpers_match_jax():
    """MiniCam, camera_to_json and resolution_policy against the JAX
    package's."""
    from saro_gs_torch.data import cameras as tcams
    from saro_gs_tpu.data import cameras as jcams
    for args in ((1352, 1014, -1), (2704, 2028, -1), (800, 800, 2),
                 (1000, 600, 640), (640, 480, 1, 0.5)):
        assert tcams.resolution_policy(*args) == jcams.resolution_policy(
            *args), args
    cam = tcams.camera_from_c2w(tcams.ring_cameras(5)[2], 0.85, 64, 48, 0.3)
    jcam = jcams.Camera(uid=cam.uid, R=cam.R, T=cam.T, fovx=cam.fovx,
                        fovy=cam.fovy, width=64, height=48, timestamp=0.3)
    assert tcams.camera_to_json(3, cam) == jcams.camera_to_json(3, jcam)
    args = (64, 48, cam.fovx, cam.fovy, 0.01, 100.0, cam.world_view,
            cam.full_proj, 0.3)
    t = tcams.MiniCam(*args).raster_params(device="cpu")
    j = jcams.MiniCam(*args).raster_params()
    for x, y, z in zip(t, j, cam.raster_params(device="cpu")):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_allclose(x.numpy(), z.numpy(), rtol=1e-6)
