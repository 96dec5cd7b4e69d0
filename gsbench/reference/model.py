"""The 4D Gaussian model, plain PyTorch on a dict of tensors: the mip
HexPlane field, the four MLP heads and the temporal deformation.  Part of
the benchmark's reference; it imports nothing of the program.

Written from the port's plain forward (saro_gs_torch/models/field.py,
models/gaussians.py, models/mlp.py, ops/mip.py's ``_sample_mip_impl``),
whose equations follow SaRO-GS (scene/hexplane.py, saro_gaussian.py:
779-847).  Autograd through the gathers here is the plain backward of the
field (what kernel K4 computes on the card).

Leaves are named as the port names them: the seven point fields, then
``field.planes.<i>`` and ``<head>.layers.<j>.bias`` / ``.weight``.
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

POINT_FIELDS = ("xyz", "features_dc", "features_rest", "scaling",
                "rotation", "opacity", "temporal_pos")
HEADS = ("motion_mlp", "rot_mlp", "opacity_mlp", "shs_mlp")
COMBS = tuple(itertools.combinations(range(4), 2))
SPATIAL_MAX_MIP = 7
TIME_ENCODE = 4
EVAL_STATE_CUTOFF = 1e-3


class Model(NamedTuple):
    """What the configuration fixes of the model (the source config's
    keys, with SaRO-GS's defaults)."""
    resolution: tuple
    out_dim: int
    multires: tuple
    hidden: int
    sh_degree: int
    min_interval: float
    dx: bool
    drot: bool
    dopacity: bool
    dsh: bool
    sigmoid_tcenter: bool
    scale_reg: bool
    shs_reg: bool
    motion_reg: bool


def model_from_config(cfg: dict) -> Model:
    kc = cfg["kplanes_config"]
    return Model(resolution=tuple(kc["resolution"]),
                 out_dim=int(kc["output_coordinate_dim"]),
                 multires=tuple(cfg.get("multires", [1, 2, 4, 8])),
                 hidden=int(cfg.get("deform_hidden_dim", 128)),
                 sh_degree=int(cfg.get("sh_degree", 3)),
                 min_interval=float(cfg.get("min_interval", 1.0)),
                 dx=cfg.get("dx", True), drot=cfg.get("drot", True),
                 dopacity=cfg.get("dopacity", True),
                 dsh=cfg.get("dsh", False),
                 sigmoid_tcenter=cfg.get("sigmoid_tcenter", False),
                 scale_reg=cfg.get("scale_reg", False),
                 shs_reg=cfg.get("shs_reg", False),
                 motion_reg=cfg.get("motion_reg", False))


def head_sizes(m: Model) -> dict:
    te = 1 + 2 * TIME_ENCODE
    fd = m.out_dim * len(m.multires)
    h = m.hidden
    return {"motion_mlp": [te + fd, h, h, 3], "rot_mlp": [te + fd, h, h, 7],
            "opacity_mlp": [fd, h, h // 2, 1],
            "shs_mlp": [te + fd, h, h, 48]}


def plane_shapes(m: Model) -> list:
    """[C, res_b, res_a] of each plane, in the port's order."""
    out = []
    for s in m.multires:
        r = (m.resolution[0] * s, m.resolution[1] * s, m.resolution[2] * s,
             m.resolution[3])
        out += [(m.out_dim, r[b], r[a]) for a, b in COMBS]
    return out


def leaf_names(m: Model) -> list:
    names = list(POINT_FIELDS)
    names += [f"field.planes.{i}" for i in range(len(plane_shapes(m)))]
    for head, sizes in head_sizes(m).items():
        n = len(sizes) - 1
        names += [f"{head}.layers.{j}.bias" for j in range(n)]
        names += [f"{head}.layers.{j}.weight" for j in range(n)]
    return names


# ---- mip sampling (ops/mip.py:_sample_mip_impl) ----------------------------

def _at_most(x, bound):
    if isinstance(bound, int):
        return torch.clamp(x, max=bound)
    return torch.minimum(x, bound)


def max_mip_levels(h: int, w: int, cap: int) -> int:
    n = 0
    while n < cap and (h >> (n + 1)) >= 1 and (w >> (n + 1)) >= 1 \
            and (h >> n) % 2 == 0 and (w >> n) % 2 == 0:
        n += 1
    return n


def _bilinear(flat, u, v, w_l, h_l, base):
    x = u * w_l - 0.5
    y = v * h_l - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = torch.clamp(x - x0, 0, 1)
    fy = torch.clamp(y - y0, 0, 1)
    x0i = _at_most(torch.clamp(x0.to(torch.int64), min=0), w_l - 1)
    x1i = _at_most(x0i + 1, w_l - 1)
    y0i = _at_most(torch.clamp(y0.to(torch.int64), min=0), h_l - 1)
    y1i = _at_most(y0i + 1, h_l - 1)
    v00 = flat[base + y0i * w_l + x0i]
    v01 = flat[base + y0i * w_l + x1i]
    v10 = flat[base + y1i * w_l + x0i]
    v11 = flat[base + y1i * w_l + x1i]
    top = v00 * (1 - fx)[:, None] + v01 * fx[:, None]
    bot = v10 * (1 - fx)[:, None] + v11 * fx[:, None]
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def sample_mip(grid, coords, level, max_level: int):
    """Trilinear mip sample of ``grid`` [C, H, W] at ``coords`` [N, 2] in
    [0, 1], fractional ``level`` [N], clamp boundary; [N, C]."""
    u, v = coords[:, 0], coords[:, 1]
    c, h, w = grid.shape
    n_levels = max_mip_levels(h, w, max_level)
    if n_levels == 0:
        return _bilinear(grid.reshape(c, -1).T, u, v, w, h, 0)
    level = torch.clamp(level.to(torch.float32), 0.0, float(n_levels))
    pyr = [grid]
    for _ in range(n_levels):
        cc, hh, ww = pyr[-1].shape
        pyr.append(pyr[-1].reshape(cc, hh // 2, 2, ww // 2, 2)
                   .mean(dim=(2, 4)))
    flat = torch.cat([p.reshape(c, -1) for p in pyr], dim=1).T
    offs = np.cumsum([0] + [int(p.shape[1] * p.shape[2]) for p in pyr])
    offs = torch.as_tensor(offs[:-1], dtype=torch.int64, device=grid.device)
    l0 = torch.clamp(torch.floor(level).to(torch.int64), 0, n_levels)
    l1 = torch.clamp(l0 + 1, 0, n_levels)
    frac = level - l0

    def samp(lv):
        w_l = torch.bitwise_right_shift(torch.full_like(lv, w), lv)
        h_l = torch.bitwise_right_shift(torch.full_like(lv, h), lv)
        return _bilinear(flat, u, v, w_l, h_l, offs[lv])
    return samp(l0) * (1 - frac)[:, None] + samp(l1) * frac[:, None]


# ---- the field (models/field.py:HexPlaneField) ------------------------------

def field(m: Model, planes, aabb_min, aabb_max, duration, pts, t,
          scales_lin):
    """Features [N, out_dim * len(multires)] at points, times and linear
    scales."""
    norm = (pts - aabb_min) / (aabb_max - aabb_min)
    tn = t * duration / (duration - 1.0)
    coords4 = torch.cat([norm, tn.reshape(-1, 1)], dim=-1)
    reso0 = torch.as_tensor(np.asarray(m.resolution[:3], np.float32)
                            * m.multires[0], device=pts.device)
    base = (aabb_max - aabb_min) / reso0
    min_s = base / 2.0
    max_s = min_s * reso0
    s = torch.minimum(torch.maximum(scales_lin, min_s), max_s)
    lvl = torch.log2(2.0 * s / base)
    levels4 = torch.cat([lvl, torch.zeros_like(lvl[:, :1])], dim=-1)
    outs = []
    for mi in range(len(m.multires)):
        acc = None
        for ci, (a, b) in enumerate(COMBS):
            spatial = 3 not in (a, b)
            feat = sample_mip(planes[mi * len(COMBS) + ci],
                              coords4[:, [a, b]],
                              torch.minimum(levels4[:, a], levels4[:, b]),
                              SPATIAL_MAX_MIP if spatial else 0)
            acc = feat if acc is None else acc + feat
        outs.append(acc)
    return torch.cat(outs, dim=-1)


# ---- heads and deformation (models/gaussians.py) ---------------------------

def mlp(leaves: dict, head: str, x, n_layers: int, final=None):
    for j in range(n_layers):
        x = F.linear(x, leaves[f"{head}.layers.{j}.weight"],
                     leaves[f"{head}.layers.{j}.bias"])
        if j < n_layers - 1:
            x = torch.relu(x)
    return final(x) if final is not None else x


def quat_normalize(q, eps: float = 1e-12):
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps * eps)


def time_embed(x):
    outs = [x]
    for i in range(TIME_ENCODE):
        f = 2.0 ** i
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def temporal_pos(m: Model, leaves: dict):
    t = leaves["temporal_pos"]
    return torch.sigmoid(t) if m.sigmoid_tcenter else t


def field_feat(m: Model, leaves: dict, aabb_min, aabb_max, duration):
    """The field at the Gaussians' (xyz, t_center, scale), inputs
    detached; differentiable in the planes."""
    planes = [leaves[f"field.planes.{i}"]
              for i in range(len(plane_shapes(m)))]
    return field(m, planes, aabb_min, aabb_max, duration,
                 leaves["xyz"].detach(), temporal_pos(m, leaves).detach(),
                 torch.exp(leaves["scaling"]).detach())


class Deformed(NamedTuple):
    xyz: torch.Tensor
    rotation: torch.Tensor
    scaling: torch.Tensor
    opacity: torch.Tensor
    shs: torch.Tensor
    state: torch.Tensor
    scale_residual: Optional[torch.Tensor]
    shs_residual: Optional[torch.Tensor]
    motion_residual: Optional[torch.Tensor]


def deform(m: Model, leaves: dict, feat, duration, timestamp,
           with_residuals: bool = False) -> Deformed:
    """The Gaussians at ``timestamp`` (saro_gaussian.py:779-847)."""
    n = {h: len(s) - 1 for h, s in head_sizes(m).items()}
    raw = 1.0 - mlp(leaves, "opacity_mlp", feat, n["opacity_mlp"],
                    torch.sigmoid)
    min_scale = duration.new_tensor(m.min_interval) / duration
    lifespan = (1.0 - min_scale) * raw + min_scale
    distance = timestamp - temporal_pos(m, leaves)
    q = distance / lifespan
    state = torch.exp(-4.0 * (q * q))
    df = torch.cat([feat, time_embed(distance).detach()], dim=-1)
    scale_res = shs_res = motion_res = None
    if with_residuals:
        base_df = torch.cat([feat, time_embed(torch.zeros_like(distance))],
                            dim=-1)
        m_base = mlp(leaves, "motion_mlp", base_df, n["motion_mlp"])
        if m.scale_reg:
            scale_res = mlp(leaves, "rot_mlp", base_df, n["rot_mlp"])[:, 4:]
        if m.shs_reg:
            shs_res = mlp(leaves, "shs_mlp", base_df,
                          n["shs_mlp"]).reshape(-1, 16, 3)
        if m.motion_reg:
            motion_res = m_base
    xyz = leaves["xyz"]
    if m.dx:
        xyz = xyz + mlp(leaves, "motion_mlp", df, n["motion_mlp"])
    if m.drot:
        rr = mlp(leaves, "rot_mlp", df, n["rot_mlp"])
        rot = quat_normalize(leaves["rotation"] + rr[:, :4])
        scaling = torch.exp(torch.clamp_max(leaves["scaling"] + rr[:, 4:],
                                            30.0))
    else:
        rot = quat_normalize(leaves["rotation"])
        scaling = torch.exp(leaves["scaling"])
    opacity = torch.sigmoid(leaves["opacity"])
    if m.dopacity:
        opacity = opacity * state
    shs = torch.cat([leaves["features_dc"], leaves["features_rest"]], dim=1)
    if m.dsh:
        shs = shs + mlp(leaves, "shs_mlp", df,
                        n["shs_mlp"]).reshape(-1, 16, 3)
    return Deformed(xyz=xyz, rotation=rot, scaling=scaling, opacity=opacity,
                    shs=shs, state=state, scale_residual=scale_res,
                    shs_residual=shs_res, motion_residual=motion_res)


def head_flops_per_row(m: Model) -> dict:
    """Multiply-adds x 2 of one row through each head."""
    return {h: 2 * sum(a * b for a, b in zip(s[:-1], s[1:]))
            for h, s in head_sizes(m).items()}


def init_std(fan_in: int) -> float:
    return 1.0 / math.sqrt(fan_in)
