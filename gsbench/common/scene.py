"""The inputs of a run, made from ``--seed`` on the device: the point
cloud in its capacity rows, the field's planes and the heads' weights,
the cameras, and (for training) the ground-truth pool.  Both sides, the
program and the reference, are handed these same tensors.

The draws are a few large calls of one ``torch.Generator`` on the run's
device, in a fixed order.  The cameras are the configuration's: a
capture is one fixed layout, whatever the seed.  A configuration's ``bench``
group says what to draw:

  ``cloud``: ``points`` live rows uniform in [-half_extent, half_extent]^3
  padded to ``capacity`` rows; ``scales`` either ``log_uniform`` (log of
  U(low, high), as the port's bench scene draws them) or ``knn3`` (log of
  the root-mean-square distance to the 3 nearest other points, clamped
  to [-10, 1], as a new model from a point cloud gets them); ``colors``
  either ``uniform`` (RGB U(0, 1)) or ``dnerf_random`` (D-NeRF's random
  init: SH DC U(0, 1) / 255, its RGB); opacity logit of ``opacity``;
  temporal centres U(0, 1); identity rotations, zero higher SH bands.
  Dead rows take a new model's fill: xyz 0, scaling -10, opacity -10,
  temporal centre 0.5.
  Each head's weights and biases are U(+-1/sqrt(fan_in)), as a new
  model's nets start.  The planes are a new model's zeros, or with a
  ``planes`` group ``{"std": s}`` N(0, s^2) in every cell, drawn after
  the heads: the scale of a trained model's planes, so that the field's
  features reach the heads.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import cameras
from ..reference import model

SH_C0 = 0.28209479177387814


class Inputs(NamedTuple):
    leaves: dict          # model.leaf_names -> tensor
    alive: torch.Tensor   # [capacity] float32
    live: int
    aabb_min: torch.Tensor
    aabb_max: torch.Tensor
    duration: torch.Tensor
    cams: dict            # cameras.FIELDS -> stacked tensors
    centers: np.ndarray   # [count, 3] rig or capture camera centres
    extent: float
    width: int
    height: int
    bg: torch.Tensor      # [3]


def frame_size(cfg: dict):
    w, h = cfg["bench"]["source_size"]
    r = int(cfg.get("resolution", 1))
    return w // r, h // r


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        int(seed) % (1 << 63))


def knn3_log_scale(xyz: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """log sqrt of the mean squared distance to the 3 nearest other
    points, clamped to [-10, 1] (blockwise, exact differences)."""
    n = xyz.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=xyz.device)
    for i in range(0, n, block):
        q = xyz[i:i + block]
        d2 = sum((q[:, None, k] - xyz[None, :, k]) ** 2 for k in range(3))
        rows = torch.arange(q.shape[0], device=xyz.device)
        d2[rows, rows + i] = float("inf")
        out[i:i + block] = d2.topk(3, dim=1, largest=False).values.mean(1)
    return torch.clamp(torch.log(torch.sqrt(torch.clamp_min(out, 1e-7))),
                       -10.0, 1.0)


def make_cloud(cfg: dict, g: torch.Generator, device):
    c = cfg["bench"]["cloud"]
    n, cap = int(c["points"]), int(c["capacity"])
    u = torch.rand((n, 10), generator=g, device=device)
    xyz = (u[:, 0:3] * 2.0 - 1.0) * float(c["half_extent"])
    if c["colors"] == "uniform":
        dc = (u[:, 3:6] - 0.5) / SH_C0
    elif c["colors"] == "dnerf_random":
        dc = ((u[:, 3:6] / 255.0 * SH_C0 + 0.5) - 0.5) / SH_C0
    else:
        raise ValueError(f"colors {c['colors']!r}")
    times = u[:, 6:7]
    sc = c["scales"]
    if sc["kind"] == "log_uniform":
        lo, hi = float(sc["low"]), float(sc["high"])
        scaling = torch.log(lo + (hi - lo) * u[:, 7:10])
    elif sc["kind"] == "knn3":
        scaling = knn3_log_scale(xyz)[:, None].expand(n, 3).contiguous()
    else:
        raise ValueError(f"scales {sc['kind']!r}")
    logit = math.log(float(c["opacity"]) / (1.0 - float(c["opacity"])))

    def pad(x, fill):
        out = torch.full((cap,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=device)
        out[:n] = x
        return out
    rot = torch.zeros((cap, 4), device=device)
    rot[:, 0] = 1.0
    points = {
        "xyz": pad(xyz, 0.0), "features_dc": pad(dc[:, None, :], 0.0),
        "features_rest": torch.zeros((cap, 15, 3), device=device),
        "scaling": pad(scaling, -10.0), "rotation": rot,
        "opacity": pad(torch.full((n, 1), logit, device=device), -10.0),
        "temporal_pos": pad(times, 0.5)}
    alive = (torch.arange(cap, device=device) < n).to(torch.float32)
    return points, alive, xyz


def make_nets(m: model.Model, g: torch.Generator, device,
              planes: dict = None) -> dict:
    out = {f"field.planes.{i}": torch.zeros(s, device=device)
           for i, s in enumerate(model.plane_shapes(m))}
    shapes = []
    for head, sizes in model.head_sizes(m).items():
        for j, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            shapes += [(f"{head}.layers.{j}.bias", (b,), a),
                       (f"{head}.layers.{j}.weight", (b, a), a)]
    total = sum(math.prod(s) for _, s, _ in shapes)
    u = torch.rand(total, generator=g, device=device) * 2.0 - 1.0
    at = 0
    for name, shape, fan_in in shapes:
        k = math.prod(shape)
        out[name] = (u[at:at + k] * model.init_std(fan_in)).reshape(shape)
        at += k
    if planes:
        keys = [k for k in out if k.startswith("field.planes.")]
        z = torch.randn(sum(out[k].numel() for k in keys), generator=g,
                        device=device) * float(planes["std"])
        at = 0
        for k in keys:
            n = out[k].numel()
            out[k] = z[at:at + n].reshape(out[k].shape)
            at += n
    return out


def camera_centers(cfg: dict) -> np.ndarray:
    cc = cfg["bench"]["cameras"]
    if cc["layout"] == "arc":
        return cameras.arc_centers(int(cc["count"]), float(cc["radius"]),
                                   float(cc["span_deg"]),
                                   float(cc["height_step"]))
    if cc["layout"] == "hemisphere":
        return cameras.hemisphere_centers(
            int(cc["count"]), float(cc["radius"]), cc["elevation_deg"],
            np.random.default_rng(int(cc["layout_seed"])))
    raise ValueError(f"camera layout {cc['layout']!r}")


def fovx(cfg: dict) -> float:
    cc = cfg["bench"]["cameras"]
    return (math.radians(cc["fovx_deg"]) if "fovx_deg" in cc
            else float(cc["camera_angle_x"]))


def make_inputs(cfg: dict, seed: int, device) -> Inputs:
    """Everything a run of this configuration needs, from ``seed``."""
    m = model.model_from_config(cfg)
    g = generator(seed, device)
    points, alive, xyz = make_cloud(cfg, g, device)
    leaves = dict(points)
    leaves.update(make_nets(m, g, device, cfg["bench"].get("planes")))
    width, height = frame_size(cfg)
    centers = camera_centers(cfg)
    cams = cameras.stack([cameras.look_at(c) for c in centers], fovx(cfg),
                         width, height, device)
    bg = torch.full((3,), 1.0 if cfg.get("white_background") else 0.0,
                    device=device)
    return Inputs(leaves=leaves, alive=alive, live=int(xyz.shape[0]),
                  aabb_min=xyz.min(dim=0).values,
                  aabb_max=xyz.max(dim=0).values,
                  duration=torch.tensor(float(cfg["duration"]),
                                        device=device),
                  cams=cams, centers=centers,
                  extent=cameras.extent(centers), width=width,
                  height=height, bg=bg)


def gt_pool(size: int, width: int, height: int, g: torch.Generator,
            device) -> torch.Tensor:
    """[size, 3, H, W] uint8 ground-truth images of uniform noise."""
    return torch.randint(0, 256, (size, 3, height, width), generator=g,
                         device=device, dtype=torch.uint8)
