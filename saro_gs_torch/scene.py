"""Checkpoint loading (counterpart of scene.load_gaussian_checkpoint).

A checkpoint is ``point_cloud.ply`` (per-point parameters) plus a sibling
``point_cloud.npz`` (field planes and MLP heads as ``leaf_<i>`` in the JAX
package's treedef order, the field aabb and the duration).
"""
from __future__ import annotations

import numpy as np
import torch

from . import DEFAULT_DEVICE, resolve_device
from .convert import jax_to_torch
from .data import ply
from .models import gaussians as gm


def load_gaussian_checkpoint(path: str, cfg: gm.ModelConfig,
                             device=DEFAULT_DEVICE):
    """point_cloud.ply + sibling .npz -> (params, nets, alive, fstatic, n)
    on ``device``, with the exact point count (no capacity padding)."""
    dev = resolve_device(device)
    d = ply.load_gaussian_ply(path)
    n = d["xyz"].shape[0]
    with np.load(path.replace(".ply", ".npz")) as npz:
        leaves = [npz[f"leaf_{i}"] for i in range(int(npz["num_leaves"]))]
        fstatic_np = {k: npz[k] for k in ("aabb_min", "aabb_max",
                                          "duration")}
    params, nets, fstatic = jax_to_torch(d, leaves, fstatic_np, cfg,
                                         device=dev)
    alive = torch.ones(n, dtype=torch.float32, device=dev)
    return params, nets, alive, fstatic, n
