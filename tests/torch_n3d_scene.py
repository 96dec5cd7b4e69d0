"""A Neural3D capture's on-disk layout, written from arrays (test and smoke
scaffolding; no JAX import, so ``chip_smoke.py`` uses it too).

    <root>/poses_bounds.npy                      LLFF rows: [3x5 pose | near far]
    <root>/colmap_0/sparse/0/cameras.bin         one PINHOLE camera a rig camera
    <root>/colmap_0/sparse/0/images.bin          poses by llff_poses_to_colmap
    <root>/colmap_<j>/sparse/0/points3D.bin      frame j's cloud
    <root>/colmap_<j>/images/cam<kk>.png         rig camera kk at frame j (RGB)

The cameras and images files come from ``poses_bounds.npy`` through the
port's ``data/preprocess.py:llff_poses_to_colmap``, the convention the
COLMAP preparation writes, so a reader holds the prep path's poses.
``toy_scene`` is the CPU tests' layout; ``rig_poses_bounds`` and
``write_layout`` also write the card's full-size scene.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Sequence, Tuple

import numpy as np

from saro_gs_torch.data import colmap
from saro_gs_torch.data.preprocess import llff_poses_to_colmap

# a points3D.bin record with an empty track: id, xyz, rgb, error, track
# length (COLMAP's binary layout, 51 bytes)
POINT_RECORD = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)),
                         ("rgb", "u1", (3,)), ("error", "<f8"),
                         ("track", "<u8")])
# the toy layout of the CPU tests
TOY_CAMS, TOY_FRAMES, TOY_W, TOY_H, TOY_FOCAL = 4, 6, 64, 48, 56.0
TOY_TARGET = (0.0, 0.0, 8.0)


def look_at_c2w(center: Sequence[float], target: Sequence[float]
                ) -> np.ndarray:
    """[3, 3] camera-to-world rotation, COLMAP axes (x right, y down, z
    forward), of a camera at ``center`` looking at ``target``, with the
    world's up along -y."""
    z = np.asarray(target, float) - np.asarray(center, float)
    z /= np.linalg.norm(z)
    x = np.cross(z, [0.0, -1.0, 0.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=1)


def rig_poses_bounds(centers: np.ndarray, target: Sequence[float],
                     width: int, height: int, focal: float, near: float,
                     far: float) -> np.ndarray:
    """poses_bounds.npy rows [N, 17] of a rig whose cameras at ``centers``
    look at ``target``: LLFF's [down, right, back, centre] columns with
    [height, width, focal] beside them, then near and far."""
    rows = np.zeros((len(centers), 17))
    for i, c in enumerate(centers):
        r = look_at_c2w(c, target)
        m = np.zeros((3, 5))
        m[:, 0], m[:, 1], m[:, 2] = r[:, 1], r[:, 0], -r[:, 2]
        m[:, 3] = c
        m[:, 4] = [height, width, focal]
        rows[i, :15] = m.reshape(-1)
        rows[i, 15:] = [near, far]
    return rows


def write_points3d(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """points3D.bin of ``xyz`` [N, 3] and ``rgb`` [N, 3] uint8, error 0
    and no tracks: the bytes of ``colmap.write_points3d_binary``, packed by
    numpy."""
    rec = np.zeros(xyz.shape[0], POINT_RECORD)
    rec["id"] = np.arange(xyz.shape[0])
    rec["xyz"] = xyz
    rec["rgb"] = rgb
    with open(path, "wb") as f:
        f.write(np.uint64(xyz.shape[0]).tobytes())
        f.write(rec.tobytes())


def write_layout(root: str, poses_bounds: np.ndarray,
                 clouds: Sequence[Tuple[np.ndarray, np.ndarray]],
                 frame_images: Callable[[int], List[np.ndarray]],
                 png_level: int = 6, threads: int = 8) -> List[str]:
    """The layout under ``root``: ``clouds[j]`` = (xyz, rgb uint8) is frame
    j's points3D.bin and ``frame_images(j)`` its views, one [H, W, 3] uint8
    array a rig camera (PNGs written at zlib level ``png_level`` on
    ``threads`` threads).  Returns the PNG paths, frame-major."""
    from PIL import Image
    np.save(os.path.join(_mkdir(root), "poses_bounds.npy"), poses_bounds)
    sparse0 = _mkdir(root, "colmap_0", "sparse", "0")
    cams, images = {}, {}
    for k, (q, t, focal, h, w) in enumerate(
            llff_poses_to_colmap(poses_bounds), 1):
        cams[k] = colmap.ColmapCamera(k, "PINHOLE", w, h, np.array(
            [focal, focal, w / 2.0, h / 2.0]))
        images[k] = colmap.ColmapImage(k, q, t, k, f"cam{k - 1:02d}.png",
                                       None, None)
    colmap.write_cameras_binary(cams, os.path.join(sparse0, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse0, "images.bin"))
    paths = []

    def save(img, path):
        Image.fromarray(img).save(path, compress_level=png_level)
    with ThreadPoolExecutor(threads) as pool:
        jobs = []
        for j, (xyz, rgb) in enumerate(clouds):
            write_points3d(os.path.join(
                _mkdir(root, f"colmap_{j}", "sparse", "0"), "points3D.bin"),
                xyz, rgb)
            img_dir = _mkdir(root, f"colmap_{j}", "images")
            # at most two frames' images wait for the encoder
            if j >= 2:
                for job in jobs[j - 2]:
                    job.result()
            jobs.append([])
            for k, img in enumerate(frame_images(j)):
                paths.append(os.path.join(img_dir, f"cam{k:02d}.png"))
                jobs[-1].append(pool.submit(save, img, paths[-1]))
        for frame_jobs in jobs:
            for job in frame_jobs:
                job.result()
    return paths


def read_points3d(path: str) -> np.ndarray:
    """The positions [N, 3] float64 of a points3D.bin ``write_points3d``
    wrote (records with empty tracks)."""
    with open(path, "rb") as f:
        count = int(np.frombuffer(f.read(8), "<u8")[0])
        rec = np.frombuffer(f.read(), POINT_RECORD)
    assert rec.shape[0] == count, path
    return rec["xyz"].copy()


def recount_preprocess31(frames_xyz: Sequence[np.ndarray], keep: int = 40,
                         maxz: float = 200.0, near_z: float = 4.5):
    """The point counts of the Neural3D init by numpy and scipy, apart from
    the port's code: (merged, after ``preprocesspoints`` 31, after the
    CLI's z prune).  Frame 0 is kept whole; in every later frame of n
    points, those whose nearest-neighbour distance (float32, the
    difference form) exceeds the int(n / keep)-th largest; then z <
    ``maxz``; then z >= ``near_z``."""
    from scipy.spatial import cKDTree
    kept = [np.asarray(frames_xyz[0], np.float32)]
    for xyz in frames_xyz[1:]:
        take = int(xyz.shape[0] / keep)
        if take <= 0:
            continue
        p = np.asarray(xyz, np.float32)
        _, idx = cKDTree(p).query(p, k=2)
        # the other point of the pair (a duplicate may come first)
        other = np.where(idx[:, 0] == np.arange(p.shape[0]), idx[:, 1],
                         idx[:, 0])
        diff = p - p[other]
        d = np.sqrt((diff * diff).sum(axis=1))
        kept.append(p[d > np.sort(d)[-take]])
    pts = np.concatenate(kept)
    pts = pts[pts[:, 2] < maxz]
    return (sum(x.shape[0] for x in frames_xyz), pts.shape[0],
            int((pts[:, 2] >= near_z).sum()))


def _mkdir(*parts) -> str:
    path = os.path.join(*parts)
    os.makedirs(path, exist_ok=True)
    return path


def toy_clouds(rng: np.random.RandomState, frames: int = TOY_FRAMES):
    """Per-frame clouds of a blob at z 5 to 11 drifting along x (300 points
    in frame 0, 120 in each later one), with floaters: 3 near ones (z < 4.5)
    and a far one (z > 200) in frame 0, 2 near and a far one in frames 2
    and 4.  Frame 0 also holds 6 isolated points just beyond the z = 4.5
    plane (wide, so their split children can fall below it) and a tight
    cluster of 20 (small, so they clone).  Returns [(xyz, rgb uint8)] by
    frame."""
    base = rng.normal(TOY_TARGET, (1.0, 0.7, 0.8), (300, 3))
    base[:, 2] = np.clip(base[:, 2], 5.0, 11.0)
    edge = np.stack([rng.uniform(-1.5, 1.5, 6), rng.uniform(-0.6, 0.6, 6),
                     rng.uniform(4.55, 4.8, 6)], 1)
    cluster = rng.normal((0.3, 0.2, 6.5), 0.002, (20, 3))
    clouds = []
    for j in range(frames):
        pts = base if j == 0 else base[rng.choice(300, 120, replace=False)]
        pts = pts + [0.05 * j, 0.0, 0.0] + rng.normal(0, 0.01, pts.shape)
        if j in (0, 2, 4):
            n_near = 3 if j == 0 else 2
            near = np.stack([rng.uniform(-1, 1, n_near),
                             rng.uniform(-0.7, 0.7, n_near),
                             rng.uniform(1.5, 4.0, n_near)], 1)
            far = [[rng.uniform(-30, 30), rng.uniform(-30, 30),
                    rng.uniform(210, 400)]]
            pts = np.concatenate([pts, near, far]
                                 + ([edge, cluster] if j == 0 else []))
        clouds.append((pts, rng.randint(0, 256, pts.shape).astype(np.uint8)))
    return clouds


def toy_scene(root: str, seed: int = 0) -> dict:
    """The CPU tests' Neural3D layout under ``root``: 4 rig cameras at z 0
    looking at (0, 0, 8), 6 frames, 64x48 RGB sources (smooth random
    colour fields), ``toy_clouds``.  Returns the poses_bounds rows, the
    clouds and the PNG paths."""
    rng = np.random.RandomState(seed)
    centers = np.stack([np.linspace(-0.9, 0.9, TOY_CAMS),
                        0.1 * np.arange(TOY_CAMS) - 0.15,
                        np.zeros(TOY_CAMS)], 1)
    pb = rig_poses_bounds(centers, TOY_TARGET, TOY_W, TOY_H, TOY_FOCAL, 3.0,
                          15.0)
    clouds = toy_clouds(rng)
    fields = rng.uniform(0, 255, (TOY_FRAMES, TOY_CAMS, 3, 4, 3))

    def frame_images(j):
        out = []
        for k in range(TOY_CAMS):
            # a 4x3 grid of colours, bilinearly upsampled
            ys = np.linspace(0, 2, TOY_H)[:, None]
            xs = np.linspace(0, 3, TOY_W)[None, :]
            y0, x0 = np.minimum(ys.astype(int), 1), np.minimum(
                xs.astype(int), 2)
            fy, fx = (ys - y0)[..., None], (xs - x0)[..., None]
            g = fields[j, k]
            img = ((1 - fy) * ((1 - fx) * g[y0, x0] + fx * g[y0, x0 + 1])
                   + fy * ((1 - fx) * g[y0 + 1, x0] + fx * g[y0 + 1, x0 + 1]))
            out.append(img.astype(np.uint8))
        return out
    paths = write_layout(root, pb, clouds, frame_images, threads=2)
    return dict(poses_bounds=pb, clouds=clouds, paths=paths)


# the card's scene (chip_smoke.py phase 15): synth.build_gt moved in front
# of a 19-camera forward-facing rig, 30 frames at the Neural3D capture size
N3D_CAMS, N3D_FRAMES, N3D_W, N3D_H, N3D_FOVX = 19, 30, 2704, 2028, 0.85
N3D_SEED = 7
# per-frame cloud sizes: frame 0, each later frame, near floaters (z < 4.5)
# and far ones (z > 200) in frame 0.  Frame 0 is sized so that 262,123
# points stay after preprocesspoints 31 and 262,023 after the CLI's z
# prune: 121 free slots of the 262,144, fewer than the first densify
# pass's moves, so that pass overflows and grows the capacity (with 2,000
# near floaters their slots alone left more free than a pass moved)
N3D_CLOUD = dict(first=233_055, later=40_000, near=100, far=200)
# build_gt's frame (z up, floor at z = -1) to the rig's COLMAP-style one
# (y down, z away from the rig): a quarter turn about x, 8 ahead
GT_ROT = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
GT_SHIFT = np.array([0.0, 0.0, 8.0])
N3D_TARGET = (0.0, 0.5, 8.0)


def n3d_rig(cams: int = N3D_CAMS) -> np.ndarray:
    """[cams, 3] camera centres on an arc of radius 7.5 about the subject,
    z 0.5 to 1.0, heights alternating; camera 0 in the middle of the arc
    (the reader's test camera), the others alternating left and right."""
    step = 0.7 / (cams - 1)
    th = np.array([0.0] + [s * step * ((k + 2) // 2) for k, s in zip(
        range(cams - 1), [-1, 1] * cams)])
    return np.stack([7.5 * np.sin(th), -1.0 + 0.12 * (np.arange(cams) % 2),
                     8.0 - 7.5 * np.cos(th)], 1)


def n3d_gt(seed: int = N3D_SEED) -> dict:
    """synth.build_gt(seed) moved by one rigid transform (GT_ROT, GT_SHIFT)
    into the rig's frame: positions, rotations (build_gt's are the
    identity) and motion alike; ``world_at(t)`` the positions at t."""
    from saro_gs_torch.data import synth
    gt = synth.build_gt(seed)
    assert np.all(gt["quats"] == [1.0, 0.0, 0.0, 0.0])
    quats = np.broadcast_to(colmap.rotmat2qvec(GT_ROT).astype(np.float32),
                            gt["quats"].shape).copy()

    def world_at(t):
        return (gt["gt_at"](t).astype(np.float64) @ GT_ROT.T
                + GT_SHIFT).astype(np.float32)
    return dict(gt, quats=quats, world_at=world_at)


def n3d_clouds(gt: dict, frames: int = N3D_FRAMES, seed: int = N3D_SEED,
               sizes: dict = N3D_CLOUD):
    """COLMAP-like per-frame clouds: ground-truth positions of random
    splats at the frame's time j / frames plus N(0, 0.02), their colours
    plus N(0, 0.08); frame 0 also holds the near floaters (x in +-2.5, y in
    +-1.5, z in [1, 4.4]) and the far ones (x, y in +-100, z in [210,
    400]).  Returns [(xyz float64, rgb uint8)] by frame."""
    rng = np.random.RandomState(seed + 2)
    n_gt = gt["base"].shape[0]
    clouds = []
    for j in range(frames):
        n = sizes["first"] if j == 0 else sizes["later"]
        idx = rng.randint(0, n_gt, n)
        xyz = gt["world_at"](j / frames)[idx].astype(np.float64) \
            + rng.normal(0, 0.02, (n, 3))
        col = np.clip(gt["colors"][idx] + rng.normal(0, 0.08, (n, 3)), 0, 1)
        if j == 0:
            near = np.stack([rng.uniform(-2.5, 2.5, sizes["near"]),
                             rng.uniform(-1.5, 1.5, sizes["near"]),
                             rng.uniform(1.0, 4.4, sizes["near"])], 1)
            far = np.stack([rng.uniform(-100, 100, sizes["far"]),
                            rng.uniform(-100, 100, sizes["far"]),
                            rng.uniform(210, 400, sizes["far"])], 1)
            xyz = np.concatenate([xyz, near, far])
            col = np.concatenate([col, rng.uniform(
                0, 1, (sizes["near"] + sizes["far"], 3))])
        clouds.append((xyz, (col * 255 + 0.5).astype(np.uint8)))
    return clouds


def write_n3d_scene(root: str, device) -> dict:
    """The card's Neural3D scene under ``root`` (the N3D_* sizes), reused
    where a finished one of the same settings is there (``scene.json``,
    written last): the ground truth of ``n3d_gt`` rendered by the port's
    rasterizer on a black background at SH degree 3 (32x32 tiles, tight
    rects) on ``device``, 8-bit PNGs (zlib level 1), ``n3d_clouds``.
    Returns the settings, the PNG paths and whether the scene was
    written."""
    import json

    import torch
    from saro_gs_torch.data import cameras
    from saro_gs_torch.ops import math3d
    from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
    frames, cams, width, height = N3D_FRAMES, N3D_CAMS, N3D_W, N3D_H
    sizes = N3D_CLOUD
    settings = dict(frames=frames, cams=cams, width=width, height=height,
                    fovx=N3D_FOVX, seed=N3D_SEED, sizes=sizes)
    marker = os.path.join(root, "scene.json")
    if os.path.exists(marker):
        with open(marker) as f:
            done = json.load(f)
        if done["settings"] == settings:
            return dict(done, written=False)
    focal = width / (2.0 * np.tan(N3D_FOVX / 2))
    centers = n3d_rig(cams)
    pb = rig_poses_bounds(centers, N3D_TARGET, width, height, focal, 5.5,
                          12.0)
    gt = n3d_gt()
    fovy = math3d.focal2fov(focal, height)
    views = []
    for c in centers:
        r = look_at_c2w(c, N3D_TARGET)
        views.append(cameras.Camera(uid=len(views), R=r, T=-r.T @ c,
                                    fovx=N3D_FOVX, fovy=fovy, width=width,
                                    height=height).raster_params(device))
    dev = views[0].viewmat.device

    def t(x):
        return torch.as_tensor(x, device=dev)
    scales, quats, opac, shs = (t(gt[k]) for k in ("scales", "quats", "opac",
                                                    "shs"))
    bg = torch.zeros(3, device=dev)
    rcfg = RasterConfig(tile_x=32, tile_y=32, chunk=128,
                        max_instances=1 << 23, tight_rect=True,
                        need_aux=False)

    def frame_images(j):
        means = t(gt["world_at"](j / frames))
        out = []
        for cam in views:
            with torch.no_grad():
                o = rasterize(means, scales, quats, opac, cam, bg,
                              width=width, height=height, sh_degree=3,
                              config=rcfg, shs=shs)
            if o.num_dropped:
                raise RuntimeError(f"{o.num_dropped} instances dropped")
            img = torch.clamp(o.color.permute(1, 2, 0), 0.0, 1.0)
            out.append((img * 255 + 0.5).to(torch.uint8).cpu().numpy())
        return out
    paths = write_layout(root, pb, n3d_clouds(gt, frames, sizes=sizes),
                         frame_images, png_level=1)
    done = dict(settings=settings, paths=paths)
    with open(marker, "w") as f:
        json.dump(done, f)
    return dict(done, written=True)
