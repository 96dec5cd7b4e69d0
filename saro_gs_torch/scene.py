"""Scene assembly: dataset -> model state, cameras and checkpoints
(counterpart of scene.py; the reference's scene/__init__.py).

Reader dispatch, the field's aabb from the point cloud, the cameras'
extent, point-cloud preprocessing, a new model from the point cloud or a
checkpoint's, and the checkpoint layout: ``point_cloud.ply`` (per-point
parameters) plus a sibling ``point_cloud.npz`` (field planes and MLP heads
as ``leaf_<i>`` in the JAX package's treedef order, the field aabb and
the duration), under ``point_cloud/iteration_<n>/``.  Either package
loads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device
from .convert import jax_to_torch, net_leaves_to_jax
from .data import ply
from .data.cameras import Camera, camera_to_json
from .data.dataset import BatchLoader
from .data.pointcloud import preprocess_points
from .data.readers import SCENE_READERS, SceneInfo
from .models import field as field_mod
from .models import gaussians as gm
from .parallel import runtime


def _next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c <<= 1
    return c


def load_gaussian_checkpoint(path: str, cfg: gm.ModelConfig,
                             device=DEFAULT_DEVICE, capacity=None):
    """point_cloud.ply + sibling .npz -> (params, nets, alive, fstatic, n)
    on ``device``.  ``capacity``: None keeps the exact point count (the
    eval render: its sort scales with the rows), an int pads with dead
    rows, a callable maps the count to the capacity (the JAX package's
    padding: scaling and opacity -10, temporal_pos 0.5, the rest 0)."""
    dev = resolve_device(device)
    d = ply.load_gaussian_ply(path)
    n = d["xyz"].shape[0]
    cap = n if capacity is None else (
        capacity(n) if callable(capacity) else capacity)

    def pad(x, fill=0.0):
        padding = [(0, cap - n)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, padding, constant_values=fill)

    params_np = dict(xyz=pad(d["xyz"]), f_dc=pad(d["f_dc"]),
                     f_rest=pad(d["f_rest"]),
                     scaling=pad(d["scaling"], fill=-10.0),
                     rotation=pad(d["rotation"]),
                     opacity=pad(d["opacity"], fill=-10.0),
                     temporal_pos=pad(d["temporal_pos"], fill=0.5))
    with np.load(path.replace(".ply", ".npz")) as npz:
        leaves = [npz[f"leaf_{i}"] for i in range(int(npz["num_leaves"]))]
        fstatic_np = {k: npz[k] for k in ("aabb_min", "aabb_max",
                                          "duration")}
    params, nets, fstatic = jax_to_torch(params_np, leaves, fstatic_np, cfg,
                                         device=dev)
    alive = (torch.arange(cap, device=dev) < n).to(torch.float32)
    return params, nets, alive, fstatic, n


class Scene:
    """The dataset, the model state on ``device`` and the checkpoints of
    one run.  ``generator`` (a CPU ``torch.Generator`` seeded from
    ``cfg.seed``) makes the new model's draws; the trainer goes on
    drawing from it.  In a process group every rank builds the same
    scene, and only rank 0 writes under ``model_path`` (``writes``):
    cameras.json, exp_log.txt and the checkpoints."""

    def __init__(self, cfg, load_iteration: Optional[str] = None,
                 device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model_path = cfg.model_path
        self.writes = runtime.group_rank() == 0
        self.mcfg = cfg.model_config()

        reader = SCENE_READERS[cfg.loader]
        if cfg.loader == "colmap":
            self.info: SceneInfo = reader(cfg.source_path,
                                          duration=cfg.duration,
                                          resolution=cfg.resolution,
                                          eval_split=cfg.eval,
                                          images_dir=cfg.images)
        else:
            self.info = reader(cfg.source_path, duration=cfg.duration,
                               resolution=cfg.resolution,
                               eval_split=cfg.eval,
                               white_background=cfg.white_background)

        pcd = self.info.point_cloud

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)
        self.fstatic = field_mod.FieldStatic(
            aabb_min=f32(pcd.points.min(axis=0)),
            aabb_max=f32(pcd.points.max(axis=0)), duration=f32(cfg.duration))
        self.cameras_extent = float(self.info.nerf_radius)
        self.generator = torch.Generator().manual_seed(cfg.seed)

        if load_iteration is not None:
            self.load_checkpoint(os.path.join(
                self.model_path, "point_cloud", f"iteration_{load_iteration}",
                "point_cloud.ply"))
            return
        self.nets = gm.init_nets(self.mcfg, self.generator, self.device)
        pcd = preprocess_points(pcd, cfg.preprocesspoints, self.device)
        capacity = max(cfg.capacity, _next_pow2(pcd.points.shape[0]))
        self.params, self.alive = gm.create_from_pcd(
            pcd, capacity, self.mcfg, self.generator, self.device)
        if cfg.model_path and self.writes:
            os.makedirs(cfg.model_path, exist_ok=True)
            cams = list(self.info.test_cameras) + \
                list(self.info.train_cameras)
            with open(os.path.join(cfg.model_path, "cameras.json"),
                      "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)],
                          f, indent=2)

    # ---- cameras (scene/__init__.py:139-163) -------------------------------
    def train_loader(self, batch_size: int, num_workers: int = 4,
                     seed: int = 666, process_index: int = 0,
                     process_count: int = 1) -> BatchLoader:
        """Batches of ``batch_size`` views; on a mesh, data rank
        ``process_index`` of ``process_count`` gets its share of each
        (BatchLoader's ``shard``).  Unlike the JAX package's per-host
        camera shards with seeds of their own, every rank draws the
        batches one process draws, so a run on a mesh trains on the same
        views as one on a single process; tile peers (same data index)
        get the same share."""
        return BatchLoader(self.info.train_cameras, batch_size,
                           white_background=self.cfg.white_background,
                           num_workers=num_workers, seed=seed,
                           shard=(process_index, process_count))

    def test_cameras(self) -> List[Camera]:
        return self.info.test_cameras

    def val_cameras(self) -> List[Camera]:
        return self.info.val_cameras

    # ---- checkpoints --------------------------------------------------------
    def save(self, iteration, params: gm.GaussianParams,
             nets: gm.DeformNets, alive: torch.Tensor,
             best_ckpt: bool = False) -> Optional[str]:
        """The live rows and the nets -> point_cloud/iteration_<tag>/;
        the PLY's path, or None on a rank that does not write."""
        if not self.writes:
            return None
        tag = "best" if best_ckpt else str(iteration)
        out_dir = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{tag}")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "point_cloud.ply")
        keep = alive.cpu().numpy() > 0

        def rows(x):
            return x.detach().cpu().numpy()[keep]
        ply.save_gaussian_ply(
            path, rows(params.xyz), rows(params.features_dc),
            rows(params.features_rest), rows(params.opacity),
            rows(params.scaling), rows(params.rotation),
            rows(params.temporal_pos))
        leaves = net_leaves_to_jax(nets)
        np.savez(path.replace(".ply", ".npz"),
                 aabb_min=self.fstatic.aabb_min.cpu().numpy(),
                 aabb_max=self.fstatic.aabb_max.cpu().numpy(),
                 duration=self.fstatic.duration.cpu().numpy(),
                 num_leaves=len(leaves),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        return path

    def load_checkpoint(self, path: str):
        """Params padded to max(cfg.capacity, next power of two), nets and
        fstatic from a checkpoint."""
        (self.params, self.nets, self.alive, self.fstatic,
         _) = load_gaussian_checkpoint(
            path, self.mcfg, self.device,
            capacity=lambda n: max(self.cfg.capacity, _next_pow2(n)))

    def record_points(self, iteration, note: str, n_points: int):
        """exp_log.txt journal (helper_train.recordpointshelper:189-194)."""
        if not (self.model_path and self.writes):
            return
        with open(os.path.join(self.model_path, "exp_log.txt"), "a") as f:
            f.write(f"iteration at {iteration}\n")
            f.write(f"{note} pointsnumber {n_points}\n")
