"""A D-NeRF capture's on-disk layout, written from the port's renders (test
and smoke scaffolding; no JAX import, so ``chip_smoke.py`` uses it too).

    <root>/transforms_train.json    camera_angle_x and the frames:
    <root>/transforms_test.json       {file_path, time, transform_matrix}
    <root>/transforms_val.json      (the readers read neither this file
                                     nor its images)
    <root>/{train,test,val}/r_<jjj>.png   RGBA, 8 bit

A monocular capture, as D-NeRF's: one camera pose a frame, drawn on the
upper hemisphere at ``RADIUS`` looking at the origin (Blender/OpenGL axes:
x right, y up, z backward), ``time`` j / (n - 1) for frame j of n, and
``camera_angle_x`` 0.6911.  The subject is ``synth.build_gt``'s moving
scene without its floor disk, so that it lies inside the cube [-1.3, 1.3]^3
of the ``blender`` reader's random init.  Each image is the port's render
on black at SH degree 3: alpha is 1 - T (the render's final
transmittance) and the colour is the render un-premultiplied, so that the
loader's composite over white gives back the render over white.  No
``points3d.ply`` is written: the reader draws its 100,000 points
(``recount_random_init`` restates that draw in numpy).

``toy_scene`` is the CPU tests' layout (every 16th splat, widened, at
64x64); ``write_dnerf_scene`` the card's (150 training and 20 test frames
at 800x800, as the D-NeRF scenes have them).
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Tuple

import numpy as np

CAMERA_ANGLE_X = 0.6911
RADIUS = 4.0
SEED = 7
# build_gt's first 14,000 splats are its floor disk (radius 1.7 at z -1)
FLOOR = 14_000
SH_C0 = 0.28209479177387814
# the frames of each split, the source size, and the subject: every
# ``stride``-th splat with its scales times ``widen``
TOY = dict(train=6, test=2, val=1, width=64, height=64, stride=16,
           widen=2.5)
FULL = dict(train=150, test=20, val=20, width=800, height=800, stride=1,
            widen=1.0)
# the blender reader's random init (dataset_readers.py:528-538)
INIT_POINTS, INIT_SEED = 100_000, 666


def hemisphere_c2w(n: int, rng: np.random.RandomState,
                   radius: float = RADIUS) -> List[np.ndarray]:
    """``n`` camera-to-world matrices [4, 4] (OpenGL axes) on the upper
    hemisphere at ``radius``: azimuth uniform over the circle, elevation
    uniform in [10, 65] degrees, each looking at the origin with the
    world's z up."""
    mats = []
    for az, el in zip(rng.uniform(0.0, 2 * np.pi, n),
                      np.radians(rng.uniform(10.0, 65.0, n))):
        pos = radius * np.array([np.cos(el) * np.cos(az),
                                 np.cos(el) * np.sin(az), np.sin(el)])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = \
            right, np.cross(right, fwd), -fwd, pos
        mats.append(c2w)
    return mats


def dnerf_gt(stride: int = 1, widen: float = 1.0,
             seed: int = SEED) -> dict:
    """synth.build_gt(seed) without its floor disk, every ``stride``-th
    splat kept and its scales times ``widen``; ``gt_at(t)`` the kept
    splats' positions at t."""
    from saro_gs_torch.data import synth
    gt = synth.build_gt(seed)
    keep = np.arange(FLOOR, gt["base"].shape[0], stride)
    out = {k: gt[k][keep] for k in ("base", "quats", "opac", "shs",
                                    "colors", "group")}
    out["scales"] = (gt["scales"][keep] * widen).astype(np.float32)

    def gt_at(t: float) -> np.ndarray:
        return gt["gt_at"](t)[keep]
    out["gt_at"] = gt_at
    return out


def split_frames(n: int, rng: np.random.RandomState, split: str
                 ) -> List[dict]:
    """The transforms file's frames of one split: ``./<split>/r_<jjj>``,
    time j / (n - 1), a hemisphere pose each."""
    return [{"file_path": f"./{split}/r_{j:03d}",
             "time": j / (n - 1) if n > 1 else 0.0,
             "transform_matrix": c2w.tolist()}
            for j, c2w in enumerate(hemisphere_c2w(n, rng))]


def render_rgba(gt: dict, frames: Sequence[dict], width: int, height: int,
                device) -> List[np.ndarray]:
    """Each frame's RGBA image [height, width, 4] uint8: the port's render
    of ``gt`` at the frame's time on black (SH degree 3, 32x32 tiles,
    tight rects), alpha = 1 - T, the colour divided by alpha where alpha
    is not zero, both rounded as uint8(255 x + 0.5)."""
    import torch
    from saro_gs_torch.data.cameras import camera_from_c2w
    from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
    cams = [camera_from_c2w(f["transform_matrix"], CAMERA_ANGLE_X, width,
                            height, f["time"]).raster_params(device)
            for f in frames]
    dev = cams[0].viewmat.device if cams else torch.device("cpu")

    def t(x):
        return torch.as_tensor(x, device=dev)
    scales, quats, opac, shs = (t(gt[k]) for k in ("scales", "quats", "opac",
                                                    "shs"))
    bg = torch.zeros(3, device=dev)
    rcfg = RasterConfig(tile_x=32, tile_y=32, chunk=128,
                        max_instances=1 << 22, tight_rect=True,
                        need_aux=False)
    out = []
    for f, cam in zip(frames, cams):
        with torch.no_grad():
            o = rasterize(t(gt["gt_at"](f["time"])), scales, quats, opac,
                          cam, bg, width=width, height=height, sh_degree=3,
                          config=rcfg, shs=shs)
        if o.num_dropped:
            raise RuntimeError(f"{o.num_dropped} instances dropped at time "
                               f"{f['time']}")
        alpha = 1.0 - o.final_t
        rgb = torch.where(alpha > 0, o.color / torch.clamp_min(alpha, 1e-12),
                          torch.zeros_like(o.color))
        rgba = torch.cat([rgb, alpha[None]]).permute(1, 2, 0)
        out.append((torch.clamp(rgba, 0.0, 1.0) * 255 + 0.5)
                   .to(torch.uint8).cpu().numpy())
    return out


def write_layout(root: str, sizes: Dict[str, int], device,
                 seed: int = SEED, png_level: int = 6,
                 threads: int = 8) -> Dict[str, List[str]]:
    """The layout of ``sizes`` (frames a split, width, height, stride,
    widen) under ``root``: the transforms files, then the RGBA PNGs,
    encoded on ``threads`` threads at zlib level ``png_level`` while the
    next frames render.  Returns the PNG paths by split."""
    from PIL import Image
    rng = np.random.RandomState(seed + 3)
    gt = dnerf_gt(sizes["stride"], sizes["widen"], seed)
    paths = {}
    with ThreadPoolExecutor(threads) as pool:
        jobs = []
        for split in ("train", "test", "val"):
            frames = split_frames(sizes[split], rng, split)
            os.makedirs(os.path.join(root, split), exist_ok=True)
            with open(os.path.join(root, f"transforms_{split}.json"),
                      "w") as f:
                json.dump({"camera_angle_x": CAMERA_ANGLE_X,
                           "frames": frames}, f, indent=1)
            paths[split] = [os.path.join(root, f["file_path"] + ".png")
                            for f in frames]
            for k in range(0, len(frames), 16):
                imgs = render_rgba(gt, frames[k:k + 16], sizes["width"],
                                   sizes["height"], device)
                for path, img in zip(paths[split][k:k + 16], imgs):
                    jobs.append(pool.submit(
                        lambda p, a: Image.fromarray(a, "RGBA").save(
                            p, compress_level=png_level), path, img))
                # at most two batches wait for the encoder
                while len(jobs) > 32:
                    jobs.pop(0).result()
        for job in jobs:
            job.result()
    return paths


def toy_scene(root: str) -> Dict[str, List[str]]:
    """The CPU tests' layout (``TOY``) under ``root``, rendered on the
    CPU."""
    return write_layout(root, TOY, "cpu", threads=2)


def write_dnerf_scene(root: str, device) -> dict:
    """The card's scene (``FULL``) under ``root``, reused where a finished
    one of the same settings is there (``scene.json``, written last; a
    ``points3d.ply`` a reader left is removed, so that the reader draws
    its init again).  PNGs at zlib level 1.  Returns the settings, the
    PNG paths and whether the scene was written."""
    settings = dict(FULL, seed=SEED, camera_angle_x=CAMERA_ANGLE_X,
                    radius=RADIUS)
    marker = os.path.join(root, "scene.json")
    ply_path = os.path.join(root, "points3d.ply")
    if os.path.exists(ply_path):
        os.remove(ply_path)
    if os.path.exists(marker):
        with open(marker) as f:
            done = json.load(f)
        if done["settings"] == settings:
            return dict(done, written=False)
    paths = write_layout(root, FULL, device, png_level=1)
    done = dict(settings=settings, paths=paths)
    with open(marker, "w") as f:
        json.dump(done, f)
    return dict(done, written=True)


def recount_random_init(n: int = INIT_POINTS, seed: int = INIT_SEED
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The blender reader's random init as ``points3d.ply`` holds it, by
    numpy alone: ``RandomState(seed)`` draws positions in [-1.3, 1.3]^3,
    SH DC terms in [0, 1/255) and times in [0, 1); the colours are
    sh2rgb of the float32 DC terms (float32), times 255, truncated to
    uint8; positions and times are stored as float32.  Returns (points,
    colours in [0, 1], times [n, 1]), float64, as the PLY reads back."""
    rng = np.random.RandomState(seed)
    xyz = rng.random((n, 3)) * 2.6 - 1.3
    shs = (rng.random((n, 3)) / 255.0).astype(np.float32)
    times = rng.random((n, 1))
    rgb = ((shs * np.float32(SH_C0) + np.float32(0.5)) * np.float32(255.0)
           ).astype(np.uint8)
    return (xyz.astype(np.float32).astype(np.float64),
            rgb.astype(np.float64) / 255.0,
            times.astype(np.float32).astype(np.float64))
