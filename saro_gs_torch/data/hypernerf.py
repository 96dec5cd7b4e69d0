"""HyperNeRF / Nerfies scenes (counterpart of data/hypernerf.py).

The Nerfies camera (orientation, position, focal length, principal point;
radial distortion ignored, as the reference's use of it does) and a scene
reader for the standard HyperNeRF layout:

    scene/
      dataset.json     {"ids": [...], "train_ids": [...], "val_ids": [...]}
      metadata.json    {id: {"time_id": t, "camera_id": c}, ...}
      camera/<id>.json {"orientation": 3x3, "position": 3, "focal_length",
                        "principal_point": 2, "image_size": [w, h]}
      rgb/<ratio>x/<id>.png

The init cloud is ``points3d_init.ply``; where it is missing it is made
from ``points.npy`` (time 0.5, grey) or else 100,000 random points of
``RandomState(666)`` in [-1.3, 1.3]^3, and written to a temporary name
and renamed into place.
"""
from __future__ import annotations

import json
import math
import os
from typing import List, Optional

import numpy as np

from ..models.gaussians import PointCloud
from ..ops import sh
from . import ply
from .cameras import Camera
from .readers import SceneInfo, nerfpp_norm


class HyperNerfCamera:
    """Nerfies camera: ``orientation`` is the world-to-camera rotation,
    ``position`` the camera centre in world space."""

    def __init__(self, orientation, position, focal_length,
                 principal_point, image_size, pixel_aspect_ratio=1.0):
        self.orientation = np.asarray(orientation, np.float64)
        self.position = np.asarray(position, np.float64)
        self.focal_length = float(focal_length)
        self.principal_point = np.asarray(principal_point, np.float64)
        self.image_size = np.asarray(image_size, np.int64)   # (w, h)
        self.pixel_aspect_ratio = float(pixel_aspect_ratio)

    @classmethod
    def from_json(cls, path: str) -> "HyperNerfCamera":
        with open(path) as f:
            d = json.load(f)
        return cls(d["orientation"], d["position"], d["focal_length"],
                   d["principal_point"], d["image_size"],
                   d.get("pixel_aspect_ratio", 1.0))

    def scaled(self, ratio: float) -> "HyperNerfCamera":
        return HyperNerfCamera(
            self.orientation, self.position, self.focal_length * ratio,
            self.principal_point * ratio,
            np.round(self.image_size * ratio).astype(np.int64),
            self.pixel_aspect_ratio)

    @property
    def translation(self) -> np.ndarray:
        """World-to-camera translation t = -R p."""
        return -self.orientation @ self.position

    def fov(self):
        w, h = self.image_size
        fovx = 2 * math.atan(w / (2 * self.focal_length))
        fy = self.focal_length * self.pixel_aspect_ratio
        fovy = 2 * math.atan(h / (2 * fy))
        return fovx, fovy


def read_hypernerf_scene(path: str, duration: int = 0, resolution: int = 2,
                         eval_split: bool = True,
                         white_background: bool = False,
                         rng: Optional[np.random.RandomState] = None
                         ) -> SceneInfo:
    """The HyperNeRF layout -> SceneInfo; ``resolution`` picks the
    pre-downsampled rgb/<r>x directory (1, 2, 4, 8...)."""
    with open(os.path.join(path, "dataset.json")) as f:
        dataset = json.load(f)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    ids: List[str] = dataset["ids"]
    train_ids = set(dataset.get("train_ids", ids))
    val_ids = set(dataset.get("val_ids", []))
    tmax = max(max(meta[i]["time_id"] for i in ids), 1)
    ratio = 1.0 / max(resolution, 1)
    rgb_dir = os.path.join(path, "rgb", f"{max(resolution, 1)}x")

    train, test = [], []
    for idx, iid in enumerate(ids):
        hcam = HyperNerfCamera.from_json(
            os.path.join(path, "camera", f"{iid}.json")).scaled(ratio)
        fovx, fovy = hcam.fov()
        # COLMAP-style Camera: R is the transpose of the world-to-camera
        # rotation, T the world-to-camera translation
        cam = Camera(uid=idx, R=hcam.orientation.T,
                     T=np.asarray(hcam.translation), fovx=fovx, fovy=fovy,
                     width=int(hcam.image_size[0]),
                     height=int(hcam.image_size[1]),
                     timestamp=meta[iid]["time_id"] / tmax, image_name=iid,
                     image_path=os.path.join(rgb_dir, f"{iid}.png"))
        if not eval_split or iid in train_ids:
            train.append(cam)
        if iid in val_ids or (eval_split and iid not in train_ids):
            test.append(cam)
    if not test:
        test = train[::8] or train[:1]

    radius, translate = nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d_init.ply")
    if not os.path.exists(ply_path):
        pts_npy = os.path.join(path, "points.npy")
        if os.path.exists(pts_npy):
            xyz = np.load(pts_npy)
            t = np.full((xyz.shape[0], 1), 0.5)
            colors = np.full((xyz.shape[0], 3), 0.5)
        else:
            rng = rng or np.random.RandomState(666)
            xyz = rng.random((100_000, 3)) * 2.6 - 1.3
            t = rng.random((xyz.shape[0], 1))
            # in float32, as the JAX package's sh2rgb computes it
            colors = sh.sh2rgb((rng.random((xyz.shape[0], 3)) / 255.0)
                               .astype(np.float32))
        tmp = f"{ply_path}.{os.getpid()}.tmp"
        ply.store_point_cloud(tmp, np.concatenate([xyz, t], axis=1),
                              np.clip(colors, 0, 1) * 255)
        os.replace(tmp, ply_path)
    pts, colors, t = ply.fetch_point_cloud(ply_path)
    return SceneInfo(point_cloud=PointCloud(points=pts, colors=colors,
                                            times=t),
                     train_cameras=train, test_cameras=test, val_cameras=[],
                     nerf_radius=radius, nerf_translate=translate,
                     ply_path=ply_path)
