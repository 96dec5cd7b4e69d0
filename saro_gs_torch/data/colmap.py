"""COLMAP sparse-reconstruction readers and writers, binary and text
(counterpart of data/colmap.py).

The standard COLMAP model format, as far as the pipeline needs it:
cameras.bin/images.bin/points3D.bin and their text variants (reference:
scene/colmap_loader.py).  The binary readers parse through the native
core library (``native.lib``, which needs no image headers) and in Python
under ``SARO_NATIVE=0``.
"""
from __future__ import annotations

import collections
import struct

import numpy as np

from .. import native

CameraModel = collections.namedtuple("CameraModel", ["id", "name",
                                                     "num_params"])
ColmapCamera = collections.namedtuple(
    "ColmapCamera", ["id", "model", "width", "height", "params"])
ColmapImage = collections.namedtuple(
    "ColmapImage", ["id", "qvec", "tvec", "camera_id", "name", "xys",
                    "point3D_ids"])

CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
MODEL_BY_ID = {m.id: m for m in CAMERA_MODELS}
MODEL_BY_NAME = {m.name: m for m in CAMERA_MODELS}


def qvec2rotmat(q):
    """COLMAP (w, x, y, z) quaternion -> rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z,
         2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x,
         1 - 2 * x * x - 2 * y * y]])


def rotmat2qvec(R):
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path):
    native_out = native.read_cameras_bin(path)
    if native_out is not None:
        return {cid: ColmapCamera(cid, MODEL_BY_ID[mid].name, w, h, params)
                for cid, mid, w, h, params in native_out}
    return read_cameras_binary_py(path)


def read_cameras_binary_py(path):
    """``read_cameras_binary``'s Python parse."""
    cams = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            model = MODEL_BY_ID[model_id]
            params = np.array(_read(f, 8 * model.num_params,
                                    "d" * model.num_params))
            cams[cid] = ColmapCamera(cid, model.name, w, h, params)
    return cams


def read_images_binary(path, load_points=False):
    if not load_points:
        native_out = native.read_images_bin(path)
        if native_out is not None:
            return {iid: ColmapImage(iid, q, t, cid, name, None, None)
                    for iid, q, t, cid, name in native_out}
    return read_images_binary_py(path, load_points)


def read_images_binary_py(path, load_points=False):
    """``read_images_binary``'s Python parse."""
    images = {}
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        for _ in range(num):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            cam_id = _read(f, 4, "i")[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_pts = _read(f, 8, "Q")[0]
            if load_points:
                data = np.frombuffer(f.read(24 * n_pts),
                                     dtype=np.float64).reshape(n_pts, 3)
                xys = data[:, :2].copy()
                ids = data[:, 2].astype(np.int64)
            else:
                f.seek(24 * n_pts, 1)
                xys, ids = None, None
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, ids)
    return images


def read_points3d_binary(path):
    """Returns (xyz [N,3], rgb [N,3] uint8, error [N])."""
    native_out = native.read_points3d_bin(path)
    if native_out is not None:
        return native_out
    return read_points3d_binary_py(path)


def read_points3d_binary_py(path):
    """``read_points3d_binary``'s Python parse, a loop over the points."""
    with open(path, "rb") as f:
        num = _read(f, 8, "Q")[0]
        xyz = np.empty((num, 3))
        rgb = np.empty((num, 3), np.uint8)
        err = np.empty(num)
        for i in range(num):
            data = _read(f, 43, "QdddBBBd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            track_len = _read(f, 8, "Q")[0]
            f.seek(8 * track_len, 1)
    return xyz, rgb, err


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            cid = int(el[0])
            model = el[1]
            cams[cid] = ColmapCamera(cid, model, int(el[2]), int(el[3]),
                                     np.array(el[4:], float))
    return cams


def read_images_text(path):
    """Two lines per image: pose header + (possibly empty) points2D."""
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    i = 0
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        el = lines[i].split()
        iid = int(el[0])
        qvec = np.array(el[1:5], float)
        tvec = np.array(el[5:8], float)
        images[iid] = ColmapImage(iid, qvec, tvec, int(el[8]), el[9],
                                  None, None)
        i += 2   # skip the points2D line (even when empty)
    return images


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return (np.array(xyz), np.array(rgb, np.uint8), np.array(err))


# ---- writers (used by tests and the COLMAP preprocessing CLI) -------------

def write_cameras_binary(cams, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model = MODEL_BY_NAME[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, model.id, cam.width,
                                cam.height))
            f.write(struct.pack("<" + "d" * model.num_params, *cam.params))


def write_images_binary(images, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz, rgb, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i],
                                *rgb[i].astype(np.uint8), 0.0))
            f.write(struct.pack("<Q", 0))
