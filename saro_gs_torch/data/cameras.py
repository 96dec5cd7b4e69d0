"""Cameras (counterpart of data/cameras.py and the ring rig of
scripts/make_synth_scene.py).

Host-side pose and intrinsics in numpy, with ``raster_params(device)``
producing the tensors the rasterizer takes, and a lazily decoded ground
truth image (the native image library's decoder, PIL where it is off).
Matrix conventions: row-vector, GL projection with the (f+n)/(f-n)
variant, znear=0.01, zfar=100 (scene/cameras.py:84-101).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE, native, resolve_device
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
    image_path: Optional[str] = None
    cx_ratio: float = 0.0      # principal point offsets in [-0.5, 0.5]
    cy_ratio: float = 0.0
    # [3,H,W] float in [0,1] or uint8, set_image
    _image: Optional[np.ndarray] = None

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

    def load_image(self, white_background: bool = False,
                   size=None) -> np.ndarray:
        """The ground truth at ``size`` (default (width, height)):
        [3, H, W] float32 in [0, 1], decoded by the native image library
        (PIL where it is off, ``native.image_lib``, or refuses the file),
        Lanczos-resized if needed, alpha composited over the background
        as scene/dataset.py:57-97 does; the image given to ``set_image``
        if there is one (uint8 decoded as x / 255)."""
        if self._image is not None:
            if self._image.dtype == np.uint8:
                return self._image.astype(np.float32) * np.float32(1 / 255)
            return self._image
        w, h = size if size is not None else (self.width, self.height)
        bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)
        img = native.load_image(self.image_path, w, h, bg)
        if img is not None:
            return img
        return load_image_pil(self.image_path, w, h, white_background)

    @property
    def has_image(self) -> bool:
        return self._image is not None or self.image_path is not None

    def set_image(self, img: np.ndarray):
        """Hold ``img`` ([3, H, W] float in [0, 1], or uint8: a quarter of
        the bytes, and what the loader ships) as the ground truth."""
        self._image = img


def load_image_pil(path: str, width: int, height: int,
                   white_background: bool = False) -> np.ndarray:
    """The Python decode: PIL, resized with LANCZOS if needed, alpha
    composited over the background -> [3, H, W] float32 in [0, 1]."""
    from PIL import Image
    with Image.open(path) as img:
        if img.size != (width, height):
            img = img.resize((width, height), Image.LANCZOS)
        arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    if arr.shape[-1] == 4:
        bg = 1.0 if white_background else 0.0
        arr = arr[..., :3] * arr[..., 3:4] + bg * (1 - arr[..., 3:4])
    return np.transpose(arr, (2, 0, 1)).copy()


@dataclasses.dataclass
class MiniCam:
    """A camera given by its matrices only (scene/cameras.py:114-126)."""
    width: int
    height: int
    fovx: float
    fovy: float
    znear: float
    zfar: float
    world_view: np.ndarray
    full_proj: np.ndarray
    timestamp: float = 0.0

    def __post_init__(self):
        inv = np.linalg.inv(self.world_view.astype(np.float64))
        self.camera_center = inv[3, :3].astype(np.float32)

    def raster_params(self, device=DEFAULT_DEVICE) -> CameraParams:
        dev = resolve_device(device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return CameraParams(viewmat=t(self.world_view),
                            projmat=t(self.full_proj),
                            campos=t(self.camera_center),
                            tanfovx=t(math.tan(self.fovx * 0.5)),
                            tanfovy=t(math.tan(self.fovy * 0.5)))


@dataclasses.dataclass
class Camerass(Camera):
    """A ray-bundle camera at twice the resolution (scene/cameras.py:
    128-214): ``width`` and ``height`` double, and ``rayo``/``rayd``
    [1, 3, H, W] float32 hold each pixel centre's ray origin (the camera
    centre) and unit direction (pix2ndc -> inverse projection ->
    camera-to-world rotation -> normalise).  The ground truth keeps the
    base size.  Off the main path, as in the reference."""

    def __post_init__(self):
        super().__post_init__()
        self.base_width, self.base_height = self.width, self.height
        self.width = 2 * self.width
        self.height = 2 * self.height
        h, w = self.height, self.width
        xs = (2.0 * np.arange(w, dtype=np.float64) + 1.0) / w - 1.0
        ys = (2.0 * np.arange(h, dtype=np.float64) + 1.0) / h - 1.0
        ndcx, ndcy = np.meshgrid(xs, ys)                     # [H, W]
        ndc = np.stack([ndcx, ndcy, np.ones_like(ndcx),
                        np.ones_like(ndcx)], axis=-1)        # [H, W, 4]
        # row-vector matrices: the reference's ndc @ (proj^T)^-1 . T is
        # ndc @ inv(proj)
        proj = math3d.projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy,
                                        self.cx_ratio, self.cy_ratio)
        cam_pt = ndc @ np.linalg.inv(proj.astype(np.float64))
        cam_pt = cam_pt[..., :3] / cam_pt[..., 3:4]
        c2w = np.linalg.inv(self.world_view.astype(np.float64))
        direction = cam_pt @ c2w[:3, :3]
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        self.rayd = np.transpose(direction, (2, 0, 1))[None].astype(
            np.float32)
        self.rayo = np.broadcast_to(
            self.camera_center.reshape(1, 3, 1, 1),
            self.rayd.shape).astype(np.float32)

    def load_image(self, white_background: bool = False,
                   size=None) -> np.ndarray:
        if size is None:
            size = (self.base_width, self.base_height)
        return super().load_image(white_background, size=size)


def resolution_policy(orig_w: int, orig_h: int, resolution: int,
                      resolution_scale: float = 1.0) -> Tuple[int, int]:
    """The reference's resolution policy (utils/camera_utils.py:73-95):
    -1 caps the width at 1600; 1/2/4/8 divide; other values set the
    target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        global_down = orig_w / resolution
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def camera_to_json(idx: int, cam: Camera) -> dict:
    """A cameras.json entry (utils/camera_utils.py:292-312)."""
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.transpose()
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": c2w[:3, 3].tolist(),
        "rotation": [r.tolist() for r in c2w[:3, :3]],
        "fy": math3d.fov2focal(cam.fovy, cam.height),
        "fx": math3d.fov2focal(cam.fovx, cam.width),
    }


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
