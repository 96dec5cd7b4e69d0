"""Scene readers: Neural3D (per-frame COLMAP dirs), Blender/D-NeRF and
HyperNeRF (``data/hypernerf.py``) (counterpart of data/readers.py).

The behaviour of scene/dataset_readers.py:
  * Colmap/Neural3D: a ``colmap_<start>`` directory per first frame; one
    camera per (physical camera, frame) over ``duration`` frames with
    ``timestamp = (j - start)/duration``; first camera (sorted by name) is
    the test camera; the 300 per-frame COLMAP clouds merge into
    ``points3D_total<duration>.ply`` with per-point times,
  * Blender: transforms_{train,test}.json with alpha-composited images,
    ``time * (d-1)/d`` timestamps and a random 100k-point init in
    [-1.3, 1.3]^3, written to a temporary name and renamed into place so
    that processes reading one directory never see half a file.
"""
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from ..models.gaussians import PointCloud
from ..ops import math3d, sh
from . import colmap, ply, pose_utils
from .cameras import Camera, resolution_policy


class SceneInfo(NamedTuple):
    point_cloud: PointCloud
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    val_cameras: List[Camera]
    nerf_radius: float
    nerf_translate: np.ndarray
    ply_path: str


def natural_sort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def nerfpp_norm(cams: List[Camera]):
    """Camera-center bounding sphere (dataset_readers.getNerfppNorm:59-80)."""
    centers = np.stack([c.camera_center for c in cams], axis=0)
    avg = centers.mean(axis=0)
    diag = np.linalg.norm(centers - avg, axis=1).max()
    return diag * 1.1, -avg


def read_colmap_scene(path: str, duration: int = 300, resolution: int = 2,
                      eval_split: bool = True,
                      images_dir: str = "images") -> SceneInfo:
    """Neural3D loader (dataset_readers.readColmapSceneInfo:364-451).

    ``path`` points at the first frame's ``colmap_<start>`` directory.
    """
    sparse = os.path.join(path, "sparse/0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse,
                                                       "cameras.bin"))
    else:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    start = os.path.basename(path).split("_")[1]
    assert start.isdigit(), "expected a colmap_<starttime> directory"
    start = int(start)

    # near/far + spiral validation path from poses_bounds.npy (:85-114)
    pb_path = os.path.join(os.path.dirname(path), "poses_bounds.npy")
    near, far = 0.01, 100.0
    val_cams: List[Camera] = []
    spiral_meta = None
    if os.path.exists(pb_path):
        pb = np.load(pb_path)
        poses = pb[:, :15].reshape(-1, 3, 5)
        bounds = pb[:, -2:]
        near = bounds.min() * 0.95
        far = bounds.max() * 1.05
        val_poses = np.concatenate(
            [poses[..., 1:2], -poses[..., :1], poses[..., 2:4]], -1)
        spiral_meta = (val_poses, near, far)

    cam_infos: List[Camera] = []
    fovx = fovy = None
    width = height = None
    for key in extr:
        e = extr[key]
        i = intr[e.camera_id]
        R = colmap.qvec2rotmat(e.qvec).T
        T = np.array(e.tvec)
        if i.model == "SIMPLE_PINHOLE":
            fx = fy = i.params[0]
        elif i.model == "PINHOLE":
            fx, fy = i.params[0], i.params[1]
        else:
            raise ValueError(f"unsupported camera model {i.model}")
        fovx = math3d.focal2fov(fx, i.width)
        fovy = math3d.focal2fov(fy, i.height)
        w, h = resolution_policy(i.width, i.height, resolution)
        width, height = w, h
        name = os.path.basename(e.name).split(".")[0]
        base_img = os.path.join(path, images_dir, os.path.basename(e.name))
        for j in range(start, start + duration):
            img_path = base_img.replace(f"colmap_{start}", f"colmap_{j}", 1)
            cam_infos.append(Camera(
                uid=i.id, R=R, T=T, fovx=fovx, fovy=fovy, width=w, height=h,
                timestamp=(j - start) / duration, image_name=name,
                image_path=img_path))

    cam_infos.sort(key=lambda c: natural_sort_key(c.image_name))

    if eval_split:
        # first camera (by name) is the test camera (:391-405)
        train = cam_infos[duration:]
        test = cam_infos[:duration]
        names = {c.image_name for c in test}
        assert len(names) == 1
        assert not names & {c.image_name for c in train}
    else:
        train, test = cam_infos, cam_infos[:2]

    if spiral_meta is not None and fovx is not None:
        vposes = pose_utils.get_spiral(*spiral_meta, n_views=300)
        val_cams = pose_utils.spiral_to_cameras(vposes, fovx, fovy, width,
                                                height)

    radius, translate = nerfpp_norm(train)

    # merged per-frame point cloud with per-point times (:419-439)
    total_ply = os.path.join(sparse, f"points3D_total{duration}.ply")
    if not os.path.exists(total_ply):
        xyzs, rgbs, times = [], [], []
        for j in range(start, start + duration):
            p = os.path.join(sparse, "points3D.bin").replace(
                f"colmap_{start}", f"colmap_{j}", 1)
            xyz, rgb, _ = colmap.read_points3d_binary(p)
            xyzs.append(xyz)
            rgbs.append(rgb)
            times.append(np.full((xyz.shape[0], 1),
                                 (j - start) / duration))
        xyz = np.concatenate(xyzs)
        rgb = np.concatenate(rgbs)
        t = np.concatenate(times)
        ply.store_point_cloud(total_ply, np.concatenate([xyz, t], axis=1),
                              rgb)
    pts, colors, times = ply.fetch_point_cloud(total_ply)
    pcd = PointCloud(points=pts, colors=colors, times=times)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     val_cameras=val_cams, nerf_radius=radius,
                     nerf_translate=translate, ply_path=total_ply)


def _blender_cameras(path, transforms_file, duration, resolution):
    with open(os.path.join(path, transforms_file)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    cams = []
    for idx, frame in enumerate(contents["frames"]):
        name = frame["file_path"]
        img_path = os.path.join(path, name + ".png")
        mat = np.linalg.inv(np.array(frame["transform_matrix"]))
        R = -np.transpose(mat[:3, :3])
        R[:, 0] = -R[:, 0]
        T = -mat[:3, 3]
        from PIL import Image
        with Image.open(img_path) as im:
            ow, oh = im.size
        w, h = resolution_policy(ow, oh, resolution)
        fovy = math3d.focal2fov(math3d.fov2focal(fovx, ow), oh)
        ts = frame.get("time", 0.0) * (duration - 1) / duration
        cams.append(Camera(uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
                           width=w, height=h, timestamp=ts,
                           image_name=Path(name).stem, image_path=img_path))
    return cams


def read_blender_scene(path: str, duration: int = 150, resolution: int = 2,
                       eval_split: bool = True,
                       white_background: bool = False,
                       rng: Optional[np.random.RandomState] = None
                       ) -> SceneInfo:
    """D-NeRF loader (dataset_readers.readNerfSyntheticInfo:506-545)."""
    train = _blender_cameras(path, "transforms_train.json", duration,
                             resolution)
    test = _blender_cameras(path, "transforms_test.json", duration,
                            resolution)
    if not eval_split:
        train = train + test
        test = []
    radius, translate = nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = rng or np.random.RandomState(666)
        num_pts = 100_000
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs_rand = rng.random((num_pts, 3)) / 255.0
        times = rng.random((num_pts, 1))
        # in float32, as the JAX package's sh2rgb computes it
        colors = sh.sh2rgb(shs_rand.astype(np.float32))
        tmp = f"{ply_path}.{os.getpid()}.tmp"
        ply.store_point_cloud(tmp, np.concatenate([xyz, times], axis=1),
                              colors * 255)
        os.replace(tmp, ply_path)
    pts, colors, times = ply.fetch_point_cloud(ply_path)
    pcd = PointCloud(points=pts, colors=colors, times=times)
    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     val_cameras=[], nerf_radius=radius,
                     nerf_translate=translate, ply_path=ply_path)


def _read_hypernerf(*args, **kwargs):
    from .hypernerf import read_hypernerf_scene
    return read_hypernerf_scene(*args, **kwargs)


SCENE_READERS = {
    "colmap": read_colmap_scene,
    "blender": read_blender_scene,
    "hypernerf": _read_hypernerf,
}
