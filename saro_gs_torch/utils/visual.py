"""Trajectory and visualisation helpers (counterpart of utils/visual.py;
the reference's helper_test.py, utils/my_utils.py, utils/pose_utils.py).

NumPy only (open3d is not used; the exporter writes PLY itself):
  * ``rgbd_to_pointcloud``: back-project a rendered RGB-D frame to a
    coloured point cloud (helper_test.rgbd2pcd:8-33),
  * ``camera_frustum_lineset``: wireframes of a camera trajectory,
  * ``smooth_camera_poses``: sliding-window SLERP pose smoothing
    (utils/my_utils.smooth_camera_poses:38-80),
  * ``average_pose`` / ``recenter_poses``: LLFF-style pose averaging
    (utils/pose_utils.py),
  * ``save_pointcloud_ply``: an ASCII point-cloud PLY.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _quat_from_mat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + t * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def smooth_camera_poses(c2ws: np.ndarray, window: int = 5) -> np.ndarray:
    """Sliding-window pose smoothing: SLERP-blend rotations toward the
    window mean, average translations (utils/my_utils.py:38-80)."""
    n = c2ws.shape[0]
    out = np.empty_like(c2ws)
    half = window // 2
    quats = np.stack([_quat_from_mat(m[:3, :3]) for m in c2ws])
    # hemisphere-align consecutive quats so averaging is well-posed
    for i in range(1, n):
        if np.dot(quats[i], quats[i - 1]) < 0:
            quats[i] = -quats[i]
    for i in range(n):
        lo, hi = max(0, i - half), min(n, i + half + 1)
        qm = quats[lo:hi].mean(axis=0)
        qm /= np.linalg.norm(qm)
        q = slerp(quats[i], qm, 0.5)
        out[i] = np.eye(4)
        out[i][:3, :3] = _mat_from_quat(q)
        out[i][:3, 3] = c2ws[lo:hi, :3, 3].mean(axis=0)
    return out


def rgbd_to_pointcloud(color: np.ndarray, depth: np.ndarray,
                       focal_x: float, focal_y: float,
                       c2w: Optional[np.ndarray] = None,
                       max_depth: float = 14.9,
                       stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project an RGB-D render to world-space points.

    color [3,H,W] in [0,1], depth [H,W]; pixels at/beyond ``max_depth``
    (the rasterizer's 15.0 unhit default) are dropped.  Returns
    (xyz [M,3], rgb [M,3])."""
    h, w = depth.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth[::stride, ::stride]
    mask = (d > 0) & (d < max_depth)
    x = (xs - w / 2.0) / focal_x * d
    y = (ys - h / 2.0) / focal_y * d
    pts = np.stack([x[mask], y[mask], d[mask]], axis=1)
    if c2w is not None:
        pts = pts @ c2w[:3, :3].T + c2w[:3, 3]
    rgb = color[:, ::stride, ::stride][:, mask].T
    return pts, rgb


def camera_frustum_lineset(c2ws: np.ndarray, scale: float = 0.1
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Wireframe frusta for a camera trajectory: (points [5N,3],
    lines [8N,2] index pairs)."""
    corners = np.array([[0, 0, 0],
                        [-1, -0.75, 1.5], [1, -0.75, 1.5],
                        [1, 0.75, 1.5], [-1, 0.75, 1.5]]) * scale
    edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4],
                      [1, 2], [2, 3], [3, 4], [4, 1]])
    pts, lines = [], []
    for i, m in enumerate(c2ws):
        pts.append(corners @ m[:3, :3].T + m[:3, 3])
        lines.append(edges + 5 * i)
    return np.concatenate(pts), np.concatenate(lines)


def save_pointcloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """ASCII PLY dump (replaces the reference's open3d writer)."""
    rgb8 = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {xyz.shape[0]}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(xyz, rgb8):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]} {c[1]} {c[2]}\n")


def average_pose(c2ws: np.ndarray) -> np.ndarray:
    """LLFF-style mean camera (utils/pose_utils.poses_avg)."""
    center = c2ws[:, :3, 3].mean(0)
    fwd = _normalize(c2ws[:, :3, 2].sum(0))
    up = c2ws[:, :3, 1].sum(0)
    m = np.eye(4)
    m[:3] = _viewmatrix(fwd, up, center)
    return m


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def recenter_poses(c2ws: np.ndarray) -> np.ndarray:
    """Transform all poses so the average pose is the identity."""
    avg = average_pose(c2ws)
    inv = np.linalg.inv(avg)
    out = inv @ np.concatenate(
        [c2ws[:, :3, :4],
         np.broadcast_to(np.array([0, 0, 0, 1.0]),
                         (c2ws.shape[0], 1, 4))], axis=1)
    return out
