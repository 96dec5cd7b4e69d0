"""COLMAP preprocessing of Neural3D-style multi-view video (counterpart of
data/preprocess.py; the reference's helper3dg.py:147-208
``getcolmapsinglen3d`` and the COLMAP sqlite schema of
utils/pre_colmap.py).  For each first-frame directory ``colmap_<i>``:

  1. extract one frame per camera video (ffmpeg),
  2. write a COLMAP ``input.db`` with known intrinsics and prior poses from
     ``poses_bounds.npy``,
  3. write the known-pose "manual" sparse model (cameras/images/points3D
     text files),
  4. run ``colmap feature_extractor / exhaustive_matcher /
     point_triangulator / image_undistorter`` and move the undistorted
     model into ``sparse/0``.

ffmpeg and colmap are looked up on PATH when a step needs them; a missing
one raises a RuntimeError that names it.  The steps that only write files
(the database, the manual model) need neither.  Host-side numpy and
sqlite only.
"""
from __future__ import annotations

import os
import shutil
import sqlite3
import struct
import subprocess
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import colmap as colmap_mod

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = [
    """CREATE TABLE IF NOT EXISTS cameras (
        camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
        model INTEGER NOT NULL, width INTEGER NOT NULL,
        height INTEGER NOT NULL, params BLOB,
        prior_focal_length INTEGER NOT NULL)""",
    """CREATE TABLE IF NOT EXISTS images (
        image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
        name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
        prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
        prior_tx REAL, prior_ty REAL, prior_tz REAL,
        CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < {}),
        FOREIGN KEY(camera_id) REFERENCES cameras(camera_id))""".format(
        MAX_IMAGE_ID),
    """CREATE TABLE IF NOT EXISTS keypoints (
        image_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB,
        FOREIGN KEY(image_id) REFERENCES images(image_id)
        ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS descriptors (
        image_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB,
        FOREIGN KEY(image_id) REFERENCES images(image_id)
        ON DELETE CASCADE)""",
    """CREATE TABLE IF NOT EXISTS matches (
        pair_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB)""",
    """CREATE TABLE IF NOT EXISTS two_view_geometries (
        pair_id INTEGER PRIMARY KEY NOT NULL, rows INTEGER NOT NULL,
        cols INTEGER NOT NULL, data BLOB, config INTEGER NOT NULL,
        F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB)""",
    "CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name)",
]


class ColmapDB:
    """A small COLMAP sqlite database writer (the schema of colmap's
    scripts/python/database.py, as vendored in utils/pre_colmap.py).
    ``close()`` commits and closes the connection."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        for stmt in _SCHEMA:
            self.conn.execute(stmt)

    def add_camera(self, model_id: int, width: int, height: int,
                   params: np.ndarray, prior_focal: bool = True,
                   camera_id: Optional[int] = None) -> int:
        blob = np.asarray(params, np.float64).tobytes()
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model_id, width, height, blob, int(prior_focal)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  prior_q: np.ndarray = np.array([np.nan] * 4),
                  prior_t: np.ndarray = np.array([np.nan] * 3),
                  image_id: Optional[int] = None) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *[float(x) for x in prior_q],
             *[float(x) for x in prior_t]))
        return cur.lastrowid

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()


def llff_poses_to_colmap(poses_bounds: np.ndarray
                         ) -> List[Tuple[np.ndarray, np.ndarray, float,
                                         int, int]]:
    """poses_bounds.npy rows -> (qvec, tvec, focal, h, w) in COLMAP
    convention (world-to-cam, [down right back] -> [right down forward],
    matching the axis shuffle in dataset_readers.py:92-101)."""
    out = []
    for row in poses_bounds:
        m = row[:15].reshape(3, 5)
        h, w, focal = m[:, 4]
        # LLFF stores [down, right, back]; to [right, down, forward]:
        c2w = np.concatenate([m[:, 1:2], m[:, 0:1], -m[:, 2:3], m[:, 3:4]],
                             axis=1)
        bottom = np.array([[0, 0, 0, 1.0]])
        c2w4 = np.concatenate([c2w, bottom], axis=0)
        w2c = np.linalg.inv(c2w4)
        q = colmap_mod.rotmat2qvec(w2c[:3, :3])
        t = w2c[:3, 3]
        out.append((q, t, float(focal), int(h), int(w)))
    return out


def write_frame_model(frame_dir: str, poses_bounds: np.ndarray,
                      image_names: List[str]):
    """Write ``input.db`` + the known-pose ``manual`` text model for one
    colmap_<i> frame directory."""
    os.makedirs(frame_dir, exist_ok=True)
    manual = os.path.join(frame_dir, "manual")
    os.makedirs(manual, exist_ok=True)
    db_path = os.path.join(frame_dir, "input.db")
    if os.path.exists(db_path):
        os.remove(db_path)
    cams = llff_poses_to_colmap(poses_bounds)
    if len(cams) != len(image_names):
        raise ValueError(f"{len(cams)} poses for {len(image_names)} images")
    db = ColmapDB(db_path)
    cam_lines, img_lines = [], []
    for i, ((q, t, focal, h, w), name) in enumerate(zip(cams, image_names)):
        cid = db.add_camera(1, w, h,
                            np.array([focal, focal, w / 2.0, h / 2.0]))
        db.add_image(name, cid, q, t, image_id=i + 1)
        cam_lines.append(
            f"{cid} PINHOLE {w} {h} {focal} {focal} {w / 2.0} {h / 2.0}")
        img_lines.append(
            f"{i + 1} " + " ".join(f"{v:.10f}" for v in (*q, *t))
            + f" {cid} {name}\n\n")  # second (points2D) line left empty
    db.close()
    with open(os.path.join(manual, "cameras.txt"), "w") as f:
        f.write("\n".join(cam_lines) + "\n")
    with open(os.path.join(manual, "images.txt"), "w") as f:
        f.write("".join(img_lines))
    open(os.path.join(manual, "points3D.txt"), "w").close()
    return db_path, manual


def _require(binary: str):
    if shutil.which(binary) is None:
        raise RuntimeError(
            f"'{binary}' binary not found on PATH: install it or run this "
            "preprocessing step on a machine that has it")


def _run(cmd: List[str]):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-2000:]}")


def extract_frames(video_path: str, out_dir: str, start: int, count: int):
    """ffmpeg frame extraction (one png per frame index)."""
    _require("ffmpeg")
    os.makedirs(out_dir, exist_ok=True)
    _run(["ffmpeg", "-y", "-i", video_path, "-vf",
          f"select=gte(n\\,{start})", "-vframes", str(count), "-start_number",
          str(start), os.path.join(out_dir, "%d.png")])


def run_colmap_frame(scene_dir: str, offset: int, mode: str = "n3d",
                     max_image_size: int = 0):
    """Per-frame COLMAP invocation sequences.

    ``mode``: "n3d" = known-pose triangulation + undistort
    (helper3dg.getcolmapsinglen3d:147-208); "undistort" adds a
    SiftExtraction.max_image_size cap (getcolmapsingleimundistort:210-275);
    "distort" skips the undistortion step (getcolmapsingleimdistort:276)."""
    _require("colmap")
    folder = os.path.join(scene_dir, f"colmap_{offset}")
    db = os.path.join(folder, "input.db")
    inp = os.path.join(folder, "input")
    manual = os.path.join(folder, "manual")
    distorted = os.path.join(folder, "distorted", "sparse")
    os.makedirs(distorted, exist_ok=True)
    extract = ["colmap", "feature_extractor", "--database_path", db,
               "--image_path", inp]
    if mode == "undistort" or max_image_size:
        extract += ["--SiftExtraction.max_image_size",
                    str(max_image_size or 6000)]
    _run(extract)
    _run(["colmap", "exhaustive_matcher", "--database_path", db])
    _run(["colmap", "point_triangulator", "--database_path", db,
          "--image_path", inp, "--output_path", distorted,
          "--input_path", manual,
          "--Mapper.ba_global_function_tolerance=0.000001"])
    if mode == "distort":
        sparse0 = os.path.join(folder, "sparse", "0")
        os.makedirs(sparse0, exist_ok=True)
        for f in os.listdir(distorted):
            shutil.copy(os.path.join(distorted, f), os.path.join(sparse0, f))
        return
    _run(["colmap", "image_undistorter", "--image_path", inp,
          "--input_path", distorted, "--output_path", folder,
          "--output_type", "COLMAP"])
    shutil.rmtree(inp)
    sparse = os.path.join(folder, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f),
                        os.path.join(sparse, "0", f))


def prepare_neural3d(scene_dir: str, duration: int = 300,
                     start: int = 0, run_colmap: bool = True):
    """Full Neural3D preprocessing: videos ``cam<k>.mp4`` and
    ``poses_bounds.npy`` -> per-frame ``colmap_<i>`` directories with
    sparse models (the reference's documented workflow)."""
    pb = np.load(os.path.join(scene_dir, "poses_bounds.npy"))
    videos = sorted(f for f in os.listdir(scene_dir) if f.endswith(".mp4"))
    if len(videos) != pb.shape[0]:
        raise ValueError(f"{len(videos)} videos for {pb.shape[0]} poses in "
                         f"{scene_dir}")
    names = [os.path.splitext(v)[0] + ".png" for v in videos]
    for k, v in enumerate(videos):
        extract_frames(os.path.join(scene_dir, v),
                       os.path.join(scene_dir, "_frames", f"cam{k:02d}"),
                       start, duration)
    for i in range(start, start + duration):
        fdir = os.path.join(scene_dir, f"colmap_{i}")
        inp = os.path.join(fdir, "input")
        os.makedirs(inp, exist_ok=True)
        for k in range(len(videos)):
            src = os.path.join(scene_dir, "_frames", f"cam{k:02d}",
                               f"{i}.png")
            shutil.copy(src, os.path.join(inp, names[k]))
        write_frame_model(fdir, pb, names)
        if run_colmap:
            run_colmap_frame(scene_dir, i)
