"""A HyperNeRF capture's on-disk layout, as its "vrig" captures have it,
written from the port's renders (test and smoke scaffolding; no JAX
import, so ``chip_smoke.py`` uses it too).

    <root>/dataset.json      {"count", "num_exemplars", "ids",
                              "train_ids": every left_<t>,
                              "val_ids": every right_<t>}
    <root>/metadata.json     {id: {"time_id": t, "camera_id": 0 | 1}}
    <root>/scene.json        {"scale": 1, "center": [0, 0, 0], "near",
                              "far"} (the readers read neither this file
                              nor principal_point)
    <root>/camera/<id>.json  {"orientation", "position", "focal_length",
                              "principal_point", "skew",
                              "pixel_aspect_ratio", "radial_distortion",
                              "tangential_distortion", "image_size"}
    <root>/rgb/2x/<id>.png   8-bit RGB
    <root>/points.npy        [P, 3] float64

The rig of HyperNeRF's vrig captures (google/hypernerf, its dataset's
``rgb/2x``): two cameras take each time step, the left one for training
and the right one for validation, in portrait.  Here the left camera
sweeps an arc of ``ARC_DEG`` degrees at ``RADIUS`` around the origin over
the capture, ``ELEVATION_DEG`` above the floor's plane, looking at the
origin; the right one has the same orientation, ``BASELINE`` along the
left camera's x axis.  ``orientation`` is the world-to-camera rotation
(rows: the camera's x right, y down and z forward axes in world
coordinates) and ``position`` the camera centre; ``image_size`` is
[width, height] at 1x, ``principal_point`` its centre, and the images are
written at 2x only.  Each image is the port's render of
``synth.build_gt``'s scene (floor included: a vrig capture is a full
scene) at time t / (steps - 1) on black at SH degree 3.  ``points.npy``
stands in for the capture's COLMAP points: ``POINTS`` splat centres at
time 0.5 plus N(0, 0.01), drawn from ``RandomState(seed + 5)``.

``toy_scene`` is the CPU tests' layout (``TOY``: 6 time steps, every 16th
splat widened, 144x256 at 1x, the focal length scaled with the width so
that the field of view is ``FULL``'s); ``write_hypernerf_scene`` the
card's (``FULL``: 100 time steps, 1072x1920 at 1x, 536x960 at 2x, focal
length 1,500 px at 1x).
"""
from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

RADIUS = 4.0
ARC_DEG = 60.0
ELEVATION_DEG = 15.0
BASELINE = 0.1
SEED = 7
FULL = dict(steps=100, width=1072, height=1920, focal=1500.0,
            points=20_000, stride=1, widen=1.0)
TOY = dict(steps=6, width=144, height=256, focal=1500.0 * 144 / 1072,
           points=500, stride=16, widen=2.5)
# the resolution the images are written at (rgb/2x)
RATIO = 2
CAMERA_IDS = {"left": 0, "right": 1}


def image_id(camera: str, t: int) -> str:
    return f"{camera}_{t:06d}"


def rig(sizes: Dict) -> List[dict]:
    """Every image of the capture, time step by time step, left then
    right: its id, time_id, camera_id and camera JSON."""
    n = sizes["steps"]
    w, h = sizes["width"], sizes["height"]
    el = math.radians(ELEVATION_DEG)
    out = []
    for t in range(n):
        az = math.radians(-90.0 - ARC_DEG / 2 + ARC_DEG * t / max(n - 1, 1))
        left = RADIUS * np.array([math.cos(el) * math.cos(az),
                                  math.cos(el) * math.sin(az), math.sin(el)])
        fwd = -left / np.linalg.norm(left)
        right = np.cross(fwd, [0.0, 0.0, 1.0])
        right /= np.linalg.norm(right)
        orientation = np.stack([right, np.cross(fwd, right), fwd])
        for camera, pos in (("left", left),
                            ("right", left + BASELINE * orientation[0])):
            out.append({
                "id": image_id(camera, t), "time_id": t,
                "camera_id": CAMERA_IDS[camera],
                "camera": {
                    "orientation": orientation.tolist(),
                    "position": pos.tolist(),
                    "focal_length": sizes["focal"],
                    "principal_point": [w / 2, h / 2], "skew": 0.0,
                    "pixel_aspect_ratio": 1.0,
                    "radial_distortion": [0.0, 0.0, 0.0],
                    "tangential_distortion": [0.0, 0.0],
                    "image_size": [w, h]}})
    return out


def subject(sizes: Dict, seed: int = SEED) -> dict:
    """synth.build_gt(seed), every ``stride``-th splat kept and its scales
    times ``widen``; ``gt_at(t)`` the kept splats' positions at t."""
    from saro_gs_torch.data import synth
    gt = synth.build_gt(seed)
    keep = np.arange(0, gt["base"].shape[0], sizes["stride"])
    out = {k: gt[k][keep] for k in ("base", "quats", "opac", "shs")}
    out["scales"] = (gt["scales"][keep] * sizes["widen"]).astype(np.float32)
    out["gt_at"] = lambda t: gt["gt_at"](t)[keep]
    return out


def render_rgb(gt: dict, images: List[dict], steps: int, device
               ) -> List[np.ndarray]:
    """Each image's render [h, w, 3] uint8 at 2x: the port's render of
    ``gt`` at time time_id / (steps - 1) on black (SH degree 3, 32x32
    tiles, tight rects), rounded as uint8(255 x + 0.5)."""
    import torch
    from saro_gs_torch.data.cameras import Camera
    from saro_gs_torch.ops.rasterize import RasterConfig, rasterize
    rcfg = RasterConfig(tile_x=32, tile_y=32, chunk=128,
                        max_instances=1 << 22, tight_rect=True,
                        need_aux=False)
    out = []
    for im in images:
        c = im["camera"]
        rot = np.asarray(c["orientation"])
        f = c["focal_length"] / RATIO
        w, h = (round(x / RATIO) for x in c["image_size"])
        time = im["time_id"] / max(steps - 1, 1)
        cam = Camera(uid=0, R=rot.T, T=-rot @ np.asarray(c["position"]),
                     fovx=2 * math.atan(w / (2 * f)),
                     fovy=2 * math.atan(h / (2 * f)), width=w, height=h,
                     timestamp=time).raster_params(device)
        dev = cam.viewmat.device

        def t(x):
            return torch.as_tensor(x, device=dev)
        with torch.no_grad():
            o = rasterize(t(gt["gt_at"](time)), t(gt["scales"]),
                          t(gt["quats"]), t(gt["opac"]), cam,
                          torch.zeros(3, device=dev), width=w, height=h,
                          sh_degree=3, config=rcfg, shs=t(gt["shs"]))
        if o.num_dropped:
            raise RuntimeError(f"{o.num_dropped} instances dropped in "
                               f"{im['id']}")
        out.append((torch.clamp(o.color.permute(1, 2, 0), 0.0, 1.0) * 255
                    + 0.5).to(torch.uint8).cpu().numpy())
    return out


def write_layout(root: str, sizes: Dict, device, seed: int = SEED,
                 png_level: int = 6, threads: int = 8) -> List[str]:
    """The layout of ``sizes`` under ``root``: the JSON files and
    ``points.npy``, then the PNGs, encoded on ``threads`` threads at zlib
    level ``png_level`` while the next images render.  Returns the PNG
    paths."""
    from PIL import Image
    images = rig(sizes)
    for d in ("camera", os.path.join("rgb", f"{RATIO}x")):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    ids = [im["id"] for im in images]
    with open(os.path.join(root, "dataset.json"), "w") as f:
        json.dump({"count": len(ids), "num_exemplars": sizes["steps"],
                   "ids": ids,
                   "train_ids": [i for i in ids if i.startswith("left_")],
                   "val_ids": [i for i in ids if i.startswith("right_")]},
                  f, indent=1)
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({im["id"]: {"time_id": im["time_id"],
                              "camera_id": im["camera_id"]}
                   for im in images}, f, indent=1)
    with open(os.path.join(root, "scene.json"), "w") as f:
        json.dump({"scale": 1.0, "center": [0.0, 0.0, 0.0], "near": 0.5,
                   "far": 10.0}, f, indent=1)
    for im in images:
        with open(os.path.join(root, "camera", f"{im['id']}.json"),
                  "w") as f:
            json.dump(im["camera"], f, indent=1)
    gt = subject(sizes, seed)
    rng = np.random.RandomState(seed + 5)
    idx = rng.choice(gt["base"].shape[0], sizes["points"], replace=False)
    pts = gt["gt_at"](0.5)[idx].astype(np.float64) \
        + rng.normal(0.0, 0.01, (sizes["points"], 3))
    np.save(os.path.join(root, "points.npy"), pts)

    paths = [os.path.join(root, "rgb", f"{RATIO}x", f"{i}.png") for i in ids]
    with ThreadPoolExecutor(threads) as pool:
        jobs = []
        for k in range(0, len(images), 16):
            imgs = render_rgb(gt, images[k:k + 16], sizes["steps"], device)
            for path, img in zip(paths[k:k + 16], imgs):
                jobs.append(pool.submit(
                    lambda p, a: Image.fromarray(a, "RGB").save(
                        p, compress_level=png_level), path, img))
            # at most two batches wait for the encoder
            while len(jobs) > 32:
                jobs.pop(0).result()
        for job in jobs:
            job.result()
    return paths


def toy_scene(root: str) -> List[str]:
    """The CPU tests' layout (``TOY``) under ``root``, rendered on the
    CPU."""
    return write_layout(root, TOY, "cpu", threads=2)


def write_hypernerf_scene(root: str, device) -> dict:
    """The card's layout (``FULL``) under ``root``, reused where a finished
    one of the same settings is there (``layout.json``, written last; a
    ``points3d_init.ply`` a reader left is removed, so that the reader
    makes it from ``points.npy`` again).  PNGs at zlib level 1.  Returns
    the settings, the PNG paths and whether the layout was written."""
    settings = dict(FULL, seed=SEED, radius=RADIUS, arc_deg=ARC_DEG,
                    elevation_deg=ELEVATION_DEG, baseline=BASELINE)
    marker = os.path.join(root, "layout.json")
    ply_path = os.path.join(root, "points3d_init.ply")
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


def recount_cameras(root: str, resolution: int = RATIO) -> Dict[str, list]:
    """The cameras the layout's JSON files give at ``resolution``, by numpy
    alone: per image, in dataset.json's order, its id, R (the transpose of
    the world-to-camera rotation), T (-orientation @ position), the centre,
    fovx and fovy from the focal length at that resolution, the size, and
    time_id / max(time_id); "train" the images of camera 0, "test" those
    of camera 1 (metadata.json)."""
    with open(os.path.join(root, "dataset.json")) as f:
        ids = json.load(f)["ids"]
    with open(os.path.join(root, "metadata.json")) as f:
        meta = json.load(f)
    tmax = max(max(meta[i]["time_id"] for i in ids), 1)
    out = {"train": [], "test": []}
    for i in ids:
        with open(os.path.join(root, "camera", f"{i}.json")) as f:
            c = json.load(f)
        rot = np.asarray(c["orientation"], np.float64)
        pos = np.asarray(c["position"], np.float64)
        focal = c["focal_length"] / resolution
        w, h = np.round(np.asarray(c["image_size"]) / resolution).astype(int)
        out["train" if meta[i]["camera_id"] == 0 else "test"].append({
            "id": i, "R": rot.T, "T": -rot @ pos, "centre": pos,
            "fovx": 2 * np.arctan(w / (2 * focal)),
            "fovy": 2 * np.arctan(h / (2 * focal * c["pixel_aspect_ratio"])),
            "width": int(w), "height": int(h),
            "timestamp": meta[i]["time_id"] / tmax})
    return out


def recount_init_cloud(root: str):
    """The init cloud the readers make from ``points.npy``, as
    ``points3d_init.ply`` holds it, by numpy alone: the positions stored
    as float32, time 0.5, the grey 0.5 stored as uint8(127.5) = 127.
    Returns (points, colours in [0, 1], times [P, 1]), float64."""
    pts = np.load(os.path.join(root, "points.npy"))
    n = pts.shape[0]
    return (pts.astype(np.float32).astype(np.float64),
            np.full((n, 3), np.uint8(127.5) / 255.0),
            np.full((n, 1), 0.5))
