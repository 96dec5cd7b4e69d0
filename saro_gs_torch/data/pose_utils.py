"""LLFF-style spiral camera paths for validation renders (counterpart of
data/pose_utils.py).

Implements the standard NeRF/LLFF spiral trajectory used by the reference
for Neural3D validation views (dataset_readers.get_spiral:204-227 +
format_render_poses:178-203, utils/pose_utils.py).
"""
from __future__ import annotations

from typing import List

import numpy as np

from .cameras import Camera


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec1_avg = up
    vec0 = _normalize(np.cross(vec1_avg, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def average_poses(poses):
    """[N, 3, 4+] camera-to-world -> average pose [3, 4]."""
    center = poses[:, :3, 3].mean(0)
    z = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return _viewmatrix(z, up, center)


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, n_rots=2,
                       n=120):
    poses = []
    rads = np.array(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta),
                             -np.sin(theta * zrate), 1.0]) * rads)
        z = _normalize(c - np.dot(c2w[:3, :4],
                                  np.array([0, 0, -focal, 1.0])))
        poses.append(_viewmatrix(z, up, c))
    return poses


def get_spiral(c2ws_all, near, far, rads_scale=1.0, n_views=120):
    """Spiral validation path (dataset_readers.get_spiral:204-227)."""
    c2w = average_poses(c2ws_all)
    up = _normalize(c2ws_all[:, :3, 1].sum(0))
    dt = 0.75
    close_depth, inf_depth = near * 0.9, far * 5.0
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    zdelta = near * 0.2
    tt = c2ws_all[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0) * rads_scale
    return np.stack(render_path_spiral(c2w, up, rads, focal, zdelta,
                                       zrate=0.5, n=n_views))


def spiral_to_cameras(poses, fovx, fovy, width, height,
                      near=0.01, far=100.0) -> List[Camera]:
    """Convert spiral poses to Cameras with the reference's sign flips
    (format_render_poses:188-198: R = -pose_R, T = -t @ R)."""
    cams = []
    n = len(poses)
    for idx, p in enumerate(poses):
        pose = np.eye(4)
        pose[:3, :] = p[:3, :]
        R = -pose[:3, :3]
        T = -pose[:3, 3].dot(R)
        cams.append(Camera(uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
                           width=width, height=height, timestamp=idx / n,
                           image_name=str(idx)))
    return cams
