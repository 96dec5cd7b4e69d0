"""A synthetic multi-view dynamic scene, rendered by the port's own
rasterizer (counterpart of scripts/make_synth_scene.py, which renders with
the JAX package's).

The ground truth is a structured Gaussian set of 46,000 splats: a
checkerboard floor disk and a banded sphere (static), a striped torus
rotating one full turn over the sequence, a bouncing two-tone ball and a
box sliding along x.  ``build_gt`` makes it with the script's
``RandomState`` draws, so the arrays are the script's to the bit.

The dataset is a Neural3D-like ring of cameras (camera 0 held out for
test) in the Blender/D-NeRF layout the ``blender`` reader loads:
``r_{cam:02d}_{frame:03d}.png``, ``transforms_{train,test}.json`` with
``time = j / (frames - 1)``, and ``points3d.ply``, a COLMAP-like init
cloud of noisy ground-truth positions at random frames with noisy colours
(``init_cloud``).

    python -m saro_gs_torch.data.synth --out datasets/synth_arena \\
        [--width 676] [--height 507] [--frames 50] [--cams 21] \\
        [--seed 7] [--init_points 100000] [--fovx 0.85] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE, resolve_device
from ..ops.rasterize import RasterConfig, rasterize
from . import ply
from .cameras import Camera, camera_from_c2w, ring_cameras

SH_C0 = 0.28209479177387814
# the script's raster settings: 32x32 tiles, batches of 128, tight rects
RASTER = RasterConfig(tile_x=32, tile_y=32, chunk=128, max_instances=1 << 20,
                      tight_rect=True, need_aux=False)


def build_gt(seed: int = 7) -> dict:
    """The ground-truth Gaussians: static arrays (``base`` positions,
    ``scales``, ``quats``, ``opac``, ``shs`` [N, 16, 3], ``colors``,
    ``group``) and ``gt_at(t)``, the positions at time t in [0, 1]."""
    rng = np.random.RandomState(seed)
    xyzs, cols, scales, groups = [], [], [], []

    def add(xyz, col, scale, group):
        xyzs.append(xyz)
        cols.append(np.broadcast_to(col, xyz.shape).copy()
                    if np.ndim(col) == 1 else col)
        scales.append(np.broadcast_to(scale, xyz.shape).copy()
                      if np.ndim(scale) <= 1 else scale)
        groups.append(np.full(xyz.shape[0], group))

    # floor disk (static)
    n = 14000
    r = np.sqrt(rng.uniform(0, 1, n)) * 1.7
    th = rng.uniform(0, 2 * np.pi, n)
    xyz = np.stack([r * np.cos(th), r * np.sin(th), np.full(n, -1.0)], 1)
    check = (np.floor(xyz[:, 0] / 0.4) + np.floor(xyz[:, 1] / 0.4)) % 2
    col = np.where(check[:, None] > 0, [0.82, 0.78, 0.70], [0.30, 0.36, 0.48])
    sc = np.full((n, 3), 0.035)
    sc[:, 2] = 0.005
    add(xyz, col, sc, "static")

    # banded sphere sculpture (static)
    n = 9000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    c0 = np.array([-0.65, -0.45, -0.55])
    xyz = c0 + 0.42 * v
    band = (np.floor((v[:, 2] + 1) * 4) % 2)
    col = np.where(band[:, None] > 0, [0.85, 0.35, 0.25], [0.92, 0.80, 0.30])
    add(xyz, col, np.full((n, 3), 0.022), "static")

    # rotating striped torus ring
    n = 12000
    u = rng.uniform(0, 2 * np.pi, n)     # around the main ring
    w = rng.uniform(0, 2 * np.pi, n)     # around the tube
    r_main, r_tube = 0.72, 0.13
    xyz = np.stack([
        (r_main + r_tube * np.cos(w)) * np.cos(u),
        (r_main + r_tube * np.cos(w)) * np.sin(u),
        r_tube * np.sin(w) - 0.15], 1)
    stripe = (np.floor(u / (2 * np.pi) * 10) % 2)
    col = np.where(stripe[:, None] > 0, [0.20, 0.65, 0.90], [0.95, 0.95, 0.95])
    add(xyz, col, np.full((n, 3), 0.020), "ring")

    # bouncing two-tone ball, centred; gt_at moves it
    n = 6000
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = 0.24 * v
    col = np.where(v[:, [0]] > 0, [0.25, 0.80, 0.35], [0.55, 0.20, 0.75])
    add(xyz, col, np.full((n, 3), 0.020), "ball")

    # oscillating box
    n = 5000
    face = rng.randint(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    ext = np.array([0.18, 0.18, 0.30])
    xyz = np.zeros((n, 3))
    for f in range(6):
        m = face == f
        ax = f // 2
        sgn = 1.0 if f % 2 == 0 else -1.0
        rest = [a for a in range(3) if a != ax]
        xyz[m, ax] = sgn * ext[ax]
        xyz[m, rest[0]] = uv[m, 0] * ext[rest[0]]
        xyz[m, rest[1]] = uv[m, 1] * ext[rest[1]]
    col = np.stack([0.9 - 0.3 * (face / 5), 0.45 + 0.1 * (face / 5),
                    np.full(n, 0.2)], 1)
    add(xyz, col, np.full((n, 3), 0.018), "box")

    xyz = np.concatenate(xyzs).astype(np.float32)
    col = np.clip(np.concatenate(cols), 0, 1).astype(np.float32)
    scale = np.concatenate(scales).astype(np.float32)
    group = np.concatenate(groups)
    ntot = xyz.shape[0]

    shs = np.zeros((ntot, 16, 3), np.float32)
    shs[:, 0] = (col - 0.5) / SH_C0
    # mild view dependence on the degree-1 coefficients
    shs[:, 1:4] = rng.normal(0, 0.03, (ntot, 3, 3))
    opac = np.full(ntot, 0.95, np.float32)
    quats = np.zeros((ntot, 4), np.float32)
    quats[:, 0] = 1.0

    ring, ball, box = group == "ring", group == "ball", group == "box"
    base = xyz.copy()

    def gt_at(t: float) -> np.ndarray:
        """Positions [N, 3] float32 at time t in [0, 1]."""
        p = base.copy()
        a = 2 * np.pi * t                      # one revolution
        ca, sa = np.cos(a), np.sin(a)
        rx = base[ring, 0] * ca - base[ring, 1] * sa
        ry = base[ring, 0] * sa + base[ring, 1] * ca
        p[ring, 0], p[ring, 1] = rx, ry
        p[ball] += np.array([0.80, 0.55, -0.70 + 0.85 *
                             abs(math.sin(2 * math.pi * t))], np.float32)
        p[box] += np.array([-0.15 + 0.55 * math.sin(2 * math.pi * t),
                            0.85, -0.78], np.float32)
        return p

    return dict(base=base, scales=scale, quats=quats, opac=opac, shs=shs,
                colors=col, group=group, gt_at=gt_at)


def init_cloud(gt: dict, frames: int, n: int, seed: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The COLMAP-like init cloud of ``n`` points (the script's draws from
    ``RandomState(seed + 1)``): ground-truth positions of random splats at
    random frames j (time j / (frames - 1)) plus N(0, 0.02), their colours
    plus N(0, 0.08) clipped to [0, 1], and the times j / frames.  Returns
    (points [n, 3] float32, colours [n, 3] float64, times [n, 1]
    float32)."""
    rng = np.random.RandomState(seed + 1)
    idx = rng.randint(0, gt["base"].shape[0], n)
    js = rng.randint(0, frames, n)
    pts = np.empty((n, 3), np.float32)
    for j in np.unique(js):
        m = js == j
        pts[m] = gt["gt_at"](j / (frames - 1))[idx[m]]
    pts += rng.normal(0, 0.02, pts.shape).astype(np.float32)
    cols = np.clip(gt["colors"][idx] + rng.normal(0, 0.08, (n, 3)), 0, 1)
    times = (js / frames).astype(np.float32)[:, None]
    return pts, cols, times


def render_frames(gt: dict, views: Iterable[Tuple[Camera, float]],
                  width: int, height: int, device=DEFAULT_DEVICE
                  ) -> Iterator[torch.Tensor]:
    """The ground truth seen by each (camera, time t in [0, 1]) of
    ``views``: uint8 [height, width, 3] on ``device``, the render clipped to
    [0, 1] and rounded as ``uint8(255 x + 0.5)``, over a white background
    at SH degree 3 with the script's raster settings (``RASTER``).  Raises
    if a render drops an instance."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(x, device=dev)
    scales, quats, opac, shs = (t(gt[k]) for k in ("scales", "quats", "opac",
                                                    "shs"))
    bg = torch.ones(3, device=dev)
    means = {}
    for cam, time in views:
        if time not in means:
            means[time] = t(gt["gt_at"](time))
        with torch.no_grad():
            out = rasterize(means[time], scales, quats, opac,
                            cam.raster_params(dev), bg, width=width,
                            height=height, sh_degree=3, config=RASTER,
                            shs=shs)
        if out.num_dropped:
            raise RuntimeError(f"{out.num_dropped} instances dropped at time "
                               f"{time} (max_instances "
                               f"{RASTER.max_instances})")
        img = torch.clamp(out.color.permute(1, 2, 0), 0.0, 1.0)
        yield (img * 255 + 0.5).to(torch.uint8)


def write_scene(out: str, width: int = 676, height: int = 507,
                frames: int = 50, cams: int = 21, seed: int = 7,
                init_points: int = 100_000, fovx: float = 0.85,
                device=DEFAULT_DEVICE):
    """The dataset under ``out``: every camera at every frame, camera 0
    the test split.  PNGs already on disk are kept, so a killed run
    resumes."""
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    gt = build_gt(seed)
    print(f"GT scene: {gt['base'].shape[0]} gaussians", flush=True)
    c2ws = ring_cameras(cams)
    splits = {"train": list(range(1, cams)), "test": [0]}
    # the PNGs are encoded on a pool while the next frames render
    with ThreadPoolExecutor(max_workers=8) as pool:
        for split, cam_ids in splits.items():
            frames_json, todo, done = [], [], 0
            for ci in cam_ids:
                for j in range(frames):
                    t = j / (frames - 1)
                    name = f"r_{ci:02d}_{j:03d}"
                    path = os.path.join(out, name + ".png")
                    frames_json.append({
                        "file_path": name, "time": t,
                        "transform_matrix": c2ws[ci].tolist()})
                    if os.path.exists(path):
                        done += 1
                        continue
                    todo.append((ci, j, path, camera_from_c2w(
                        c2ws[ci], fovx, width, height, t)))
            imgs = render_frames(gt, ((cam, j / (frames - 1))
                                      for _, j, _, cam in todo),
                                 width, height, device)
            pending = []
            for (ci, j, path, _), img in zip(todo, imgs):
                img = img.cpu().numpy()
                if ci == cam_ids[0] and j == 0:
                    nonbg = (img < 250).any(-1).mean()
                    print(f"[{split}] cam {ci} coverage {nonbg:.2f}",
                          flush=True)
                    if nonbg <= 0.15:
                        raise RuntimeError(
                            f"camera {ci} sees {nonbg:.2f} of the frame "
                            "covered: camera convention broken?")
                pending.append(pool.submit(Image.fromarray(img).save, path))
                if len(pending) > 64:
                    pending.pop(0).result()
            for f in pending:
                f.result()
            with open(os.path.join(out, f"transforms_{split}.json"),
                      "w") as f:
                json.dump({"camera_angle_x": fovx, "frames": frames_json}, f)
            print(f"[{split}] {len(frames_json)} frames written "
                  f"({done} already on disk)", flush=True)

    pts, cols, times = init_cloud(gt, frames, init_points, seed)
    ply.store_point_cloud(os.path.join(out, "points3d.ply"),
                          np.concatenate([pts, times], axis=1), cols * 255)
    print(f"init cloud: {init_points} points", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m saro_gs_torch.data.synth")
    ap.add_argument("--out", default="datasets/synth_arena")
    ap.add_argument("--width", type=int, default=676)
    ap.add_argument("--height", type=int, default=507)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--cams", type=int, default=21)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--init_points", type=int, default=100_000)
    ap.add_argument("--fovx", type=float, default=0.85)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    write_scene(args.out, width=args.width, height=args.height,
                frames=args.frames, cams=args.cams, seed=args.seed,
                init_points=args.init_points, fovx=args.fovx,
                device=args.device)


if __name__ == "__main__":
    main()
