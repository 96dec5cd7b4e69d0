"""Point-cloud preprocessing at scene creation (counterpart of
data/pointcloud.py).

helper_model.py's one-shot preprocessing of the merged per-frame clouds:

  * ``sparsify`` keeps, per timestamp, the most isolated 1/n of the points
    by nearest-neighbour distance (helper_model.interpolate_point
    :122-175; frame 0 is kept whole);
  * ``prune_max_z`` drops points above a height (:273-285);
  * ``add_sky_points`` adds a spherical-cap shell of points (:286-314).

``preprocess_points`` dispatches on the reference's ``preprocesspoints``
integer (saro_gaussian.create_from_pcd:159-175).  Nearest-neighbour
distances are exact, in float32 as the JAX package's native library
computes them, by ``ops/knn.py`` on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device
from ..models.gaussians import PointCloud
from ..ops import knn


def _nn_distance(points: np.ndarray, device) -> np.ndarray:
    """Distance to the nearest OTHER point, [N] float32."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    return torch.sqrt(knn.knn_sq_dists(pts, 1)[:, 0]).cpu().numpy()


def sparsify(pcd: PointCloud, n: int = 4,
             device=DEFAULT_DEVICE) -> PointCloud:
    """Keep the most isolated 1/n of the points of each timestamp (frame 0
    whole)."""
    dev = resolve_device(device)
    save_rate = 1.0 / n
    times = pcd.times if pcd.times is not None else np.zeros(
        (pcd.points.shape[0], 1))
    # rows grouped by timestamp once: random-time clouds have about one
    # point per stamp, and a scan per stamp would be quadratic
    stamps, inverse = np.unique(times[:, 0], return_inverse=True)
    order = np.argsort(inverse, kind="stable")
    bounds = np.searchsorted(inverse[order], np.arange(stamps.shape[0] + 1))
    keep = np.zeros(times.shape[0], bool)
    for ti in range(stamps.shape[0]):
        idx = order[bounds[ti]:bounds[ti + 1]]
        if ti == 0:
            keep[idx] = True
            continue
        num_take = int(idx.shape[0] * save_rate)
        if num_take <= 0:
            continue
        d = _nn_distance(pcd.points[idx], dev)
        thresh = np.sort(d)[-num_take]
        keep[idx[d > thresh]] = True
    return PointCloud(points=pcd.points[keep], colors=pcd.colors[keep],
                      times=times[keep])


def prune_max_z(pcd: PointCloud, maxz: float = 200.0) -> PointCloud:
    sel = pcd.points[:, 2] < maxz
    t = pcd.times[sel] if pcd.times is not None else None
    return PointCloud(points=pcd.points[sel], colors=pcd.colors[sel],
                      times=t)


def add_sky_points(pcd: PointCloud, extra: int = 5000, radius: float = 200,
                   min_radius: float = 63,
                   rng: np.random.RandomState | None = None) -> PointCloud:
    rng = rng or np.random.RandomState(666)
    r = rng.rand(extra) * radius + min_radius
    phi = rng.rand(extra) * np.pi / 2 + np.pi / 4
    sita = rng.rand(extra) * np.pi / 4
    x = r * np.sin(phi) * np.cos(sita)
    y = r * np.cos(phi)
    z = r * np.sin(phi) * np.sin(sita)
    xyz = np.stack([x, y, z], axis=1)
    rgb = np.full((extra, 3), 0.5)
    t = np.full((extra, 1), 0.5)
    times = pcd.times if pcd.times is not None else np.zeros(
        (pcd.points.shape[0], 1))
    return PointCloud(points=np.concatenate([pcd.points, xyz]),
                      colors=np.concatenate([pcd.colors, rgb]),
                      times=np.concatenate([times, t]))


def preprocess_points(pcd: PointCloud, mode: int,
                      device=DEFAULT_DEVICE) -> PointCloud:
    """Dispatch on the reference's ``preprocesspoints`` integer."""
    if mode == 0:
        return pcd
    if mode == 3:
        return prune_max_z(add_sky_points(sparsify(pcd, 40, device), 5000,
                                          100, 0), 300)
    if mode == 31:
        return prune_max_z(sparsify(pcd, 40, device), 200)
    if mode == 4:
        return sparsify(pcd, 40, device)
    return sparsify(pcd, mode, device)
