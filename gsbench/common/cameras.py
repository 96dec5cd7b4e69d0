"""Camera layouts of the benchmark's configurations, in numpy.

The camera matrices follow the reference rasterizer's conventions, as the
port's Blender reader builds them (a copy of its math, so that the
benchmark owns its inputs): row-vector world->view and world->NDC
matrices, znear 0.01, zfar 100.

Layouts (a configuration's ``bench.cameras``):

  * ``arc``: a forward-facing arc of ``count`` cameras at ``radius`` about
    the origin, azimuths evenly over ``span_deg`` centred on the +x axis,
    heights alternating 0 and ``height_step``, each looking at the origin
    (a DyNeRF rig in front of its subject);
  * ``hemisphere``: ``count`` poses on the upper hemisphere at
    ``radius``, azimuth uniform over the circle and elevation uniform in
    ``elevation_deg``, each looking at the origin (a D-NeRF capture's
    monocular training poses), drawn once from the configuration's
    ``layout_seed``: one capture, whatever the run's seed.

``stack`` turns a list of camera-to-world matrices into the stacked
tensors that both sides take: viewmat, projmat [N, 4, 4], campos [N, 3],
tanfovx, tanfovy [N].
"""
from __future__ import annotations

import math

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0
FIELDS = ("viewmat", "projmat", "campos", "tanfovx", "tanfovy")


def look_at(pos, target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-world [4, 4] (OpenGL axes: x right, y up, z backward) of
    a camera at ``pos`` looking at ``target`` with the world's z up."""
    pos = np.asarray(pos, np.float64)
    fwd = np.asarray(target, np.float64) - pos
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
        right, np.cross(right, fwd), -fwd, pos
    return c2w


def arc_centers(count: int, radius: float, span_deg: float,
                height_step: float) -> np.ndarray:
    """[count, 3] camera centres of the ``arc`` layout."""
    th = np.radians(np.linspace(-0.5 * span_deg, 0.5 * span_deg, count))
    z = height_step * (np.arange(count) % 2)
    return np.stack([radius * np.cos(th), radius * np.sin(th), z], axis=1)


def sweep_centers(centers: np.ndarray, frames: int) -> np.ndarray:
    """[frames, 3]: one pass along the arc, each frame's centre the linear
    blend of its two neighbouring rig cameras."""
    s = np.arange(frames) * (len(centers) - 1) / frames
    k = np.minimum(np.floor(s).astype(int), len(centers) - 2)
    f = (s - k)[:, None]
    return centers[k] * (1.0 - f) + centers[k + 1] * f


def hemisphere_centers(count: int, radius: float, elevation_deg,
                       rng: np.random.Generator) -> np.ndarray:
    """[count, 3] centres of the ``hemisphere`` layout."""
    az = rng.uniform(0.0, 2 * np.pi, count)
    el = np.radians(rng.uniform(elevation_deg[0], elevation_deg[1], count))
    return radius * np.stack([np.cos(el) * np.cos(az),
                              np.cos(el) * np.sin(az), np.sin(el)], axis=1)


def _world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    rt = np.zeros((4, 4))
    rt[:3, :3] = R.transpose()
    rt[:3, 3] = t
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    return np.float32(np.linalg.inv(c2w).T)


def _projection(fovx: float, fovy: float) -> np.ndarray:
    top = math.tan(fovy / 2) * ZNEAR
    right = math.tan(fovx / 2) * ZNEAR
    p = np.zeros((4, 4))
    p[0, 0] = 2.0 * ZNEAR / (2 * right)
    p[1, 1] = 2.0 * ZNEAR / (2 * top)
    p[3, 2] = 1.0
    p[2, 2] = (ZFAR + ZNEAR) / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return np.float32(p.T)


def raster_arrays(c2w: np.ndarray, fovx: float, width: int, height: int):
    """One camera's (viewmat, projmat, campos, tanfovx, tanfovy) as
    float32 arrays, from an OpenGL camera-to-world matrix (the Blender
    reader's conversion)."""
    mat = np.linalg.inv(np.array(c2w))
    R = -np.transpose(mat[:3, :3])
    R[:, 0] = -R[:, 0]
    T = -mat[:3, 3]
    focal = width / (2 * math.tan(fovx / 2))
    fovy = 2 * math.atan(height / (2 * focal))
    wv = _world_to_view(R, T)
    full = (wv.astype(np.float64)
            @ _projection(fovx, fovy).astype(np.float64)).astype(np.float32)
    campos = np.linalg.inv(wv.astype(np.float64))[3, :3].astype(np.float32)
    return (wv, full, campos, np.float32(math.tan(fovx * 0.5)),
            np.float32(math.tan(fovy * 0.5)))


def stack(c2ws, fovx: float, width: int, height: int, device) -> dict:
    """The cameras as stacked float32 tensors on ``device`` (FIELDS)."""
    cols = list(zip(*[raster_arrays(m, fovx, width, height) for m in c2ws]))
    return {name: torch.as_tensor(np.stack(col), device=device)
            for name, col in zip(FIELDS, cols)}


def extent(centers: np.ndarray) -> float:
    """The scene extent the trainer scales position LRs by: 1.1 x the
    largest distance of a camera centre from their mean (NeRF++'s
    normalisation, as the port's readers compute it)."""
    avg = centers.mean(axis=0)
    return float(np.linalg.norm(centers - avg, axis=1).max() * 1.1)
