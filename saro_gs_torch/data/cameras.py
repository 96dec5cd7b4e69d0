"""Cameras (counterpart of data/cameras.py and the ring rig of
scripts/make_synth_scene.py).

Host-side pose and intrinsics in numpy, with ``raster_params(device)``
producing the tensors the rasterizer takes.  Matrix conventions: row-vector,
GL projection with the (f+n)/(f-n) variant, znear=0.01, zfar=100.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device
from ..ops import math3d
from ..ops.projection import CameraParams

ZNEAR, ZFAR = 0.01, 100.0


@dataclasses.dataclass
class Camera:
    uid: int
    R: np.ndarray              # [3,3] cam-to-world rotation (COLMAP style)
    T: np.ndarray              # [3] world-to-cam translation
    fovx: float
    fovy: float
    width: int                 # render resolution
    height: int
    timestamp: float = 0.0
    image_name: str = ""
    cx_ratio: float = 0.0      # principal point offsets in [-0.5, 0.5]
    cy_ratio: float = 0.0

    def __post_init__(self):
        wv = math3d.world_to_view_matrix(self.R, self.T)
        proj = math3d.projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy,
                                        self.cx_ratio, self.cy_ratio)
        self.world_view = wv
        self.full_proj = (wv.astype(np.float64)
                          @ proj.astype(np.float64)).astype(np.float32)
        self.camera_center = np.linalg.inv(
            wv.astype(np.float64))[3, :3].astype(np.float32)
        self.tanfovx = math.tan(self.fovx * 0.5)
        self.tanfovy = math.tan(self.fovy * 0.5)

    def raster_params(self, device=DEFAULT_DEVICE) -> CameraParams:
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return CameraParams(viewmat=t(self.world_view),
                            projmat=t(self.full_proj),
                            campos=t(self.camera_center),
                            tanfovx=t(self.tanfovx),
                            tanfovy=t(self.tanfovy))


def ring_cameras(n_cams: int, radius: float = 4.2):
    """Camera-to-world matrices on a ring, OpenGL convention (x right,
    y up, z backward), all looking at the scene centre."""
    mats = []
    target = np.array([0.0, 0.0, -0.25])
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        z = 0.45 + 0.75 * ((i * 7) % n_cams) / max(n_cams - 1, 1)
        pos = np.array([radius * math.cos(th), radius * math.sin(th), z])
        fwd = target - pos
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        up2 = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
            right, up2, -fwd, pos
        mats.append(c2w)
    return mats


def camera_from_c2w(c2w, fovx, width, height, timestamp) -> Camera:
    """Blender-style camera from a camera-to-world matrix (the math of the
    Blender reader, so a render matches what training saw)."""
    mat = np.linalg.inv(np.array(c2w))
    R = -np.transpose(mat[:3, :3])
    R[:, 0] = -R[:, 0]
    T = -mat[:3, 3]
    fovy = math3d.focal2fov(math3d.fov2focal(fovx, width), height)
    return Camera(uid=0, R=R, T=T, fovx=fovx, fovy=fovy, width=width,
                  height=height, timestamp=timestamp)
