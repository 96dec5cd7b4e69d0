"""Scale-aware residual field: mip-sampled HexPlane 4D feature grids
(counterpart of models/field.py; the reference's ScaleAwareResField).

Six coordinate-pair planes per multires scale over (x, y, z, t), sampled
at a per-Gaussian mip level proportional to its spatial scale, summed over
planes and concatenated over scales.  Plane order is
itertools.combinations(range(4), 2):
  0:(x,y)  1:(x,z)  2:(x,t)  3:(y,z)  4:(y,t)  5:(z,t)
and plane (a, b) is stored [C, res[b], res[a]].
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import mip

COMBS: Tuple[Tuple[int, int], ...] = tuple(
    itertools.combinations(range(4), 2))
SPATIAL_MAX_MIP = 7      # hexplane.py:55 (planes without time)
TV_PLANES = (0, 1, 3)    # hexplane.py:311-318
# the reference's index set, kept as it is: [1, 4, 5] takes the (x,z)
# spatial plane where (x,t) was meant (hexplane.py:320-326)
TIMESMOOTH_PLANES = (1, 4, 5)


class FieldConfig(NamedTuple):
    resolution: Tuple[int, int, int, int] = (64, 64, 64, 25)
    out_dim: int = 32
    multires: Tuple[int, ...] = (1,)

    @property
    def feat_dim(self) -> int:
        return self.out_dim * len(self.multires)

    def reso(self, scale_mult: int) -> Tuple[int, int, int, int]:
        r = self.resolution
        return (r[0] * scale_mult, r[1] * scale_mult, r[2] * scale_mult,
                r[3])


class FieldStatic(NamedTuple):
    """Scene-derived field inputs: aabb and duration (frame count)."""
    aabb_min: torch.Tensor   # [3]
    aabb_max: torch.Tensor   # [3]
    duration: torch.Tensor   # 0-d


def get_levels(cfg: FieldConfig, static: FieldStatic,
               scales_lin: torch.Tensor) -> torch.Tensor:
    """Per-axis mip level [N, 4] (hexplane.py:231-242): the base cell comes
    from the first multires resolution, level = log2(2 clamp(s) / cell),
    and the time axis is 0."""
    reso0 = torch.as_tensor(np.asarray(cfg.reso(cfg.multires[0])[:3],
                                       np.float32),
                            device=scales_lin.device)
    base = (static.aabb_max - static.aabb_min) / reso0
    min_s = base / 2.0
    max_s = min_s * reso0
    s = torch.minimum(torch.maximum(scales_lin, min_s), max_s)
    lvl = torch.log2(2.0 * s / base)
    return torch.cat([lvl, torch.zeros_like(lvl[:, :1])], dim=-1)


class HexPlaneField(nn.Module):
    """The planes as parameters: ``planes[m * 6 + i]`` is plane COMBS[i]
    of multires scale m (the JAX package's ``grids[m][i]``)."""

    def __init__(self, cfg: FieldConfig):
        super().__init__()
        self.cfg = cfg
        planes = []
        for m in cfg.multires:
            reso = cfg.reso(m)
            for (a, b) in COMBS:
                planes.append(nn.Parameter(
                    torch.zeros(cfg.out_dim, reso[b], reso[a])))
        self.planes = nn.ParameterList(planes)

    def forward(self, static: FieldStatic, pts: torch.Tensor,
                t: torch.Tensor, scales_lin: torch.Tensor) -> torch.Tensor:
        """pts [N,3], t [N,1] in [0,(d-1)/d], linear scales [N,3] ->
        features [N, feat_dim]."""
        norm = (pts - static.aabb_min) / (static.aabb_max - static.aabb_min)
        tn = t * static.duration / (static.duration - 1.0)
        coords4 = torch.cat([norm, tn.reshape(-1, 1)], dim=-1)
        levels4 = get_levels(self.cfg, static, scales_lin)

        outs = []
        for mi in range(len(self.cfg.multires)):
            acc = None
            for ci, (a, b) in enumerate(COMBS):
                spatio_only = 3 not in (a, b)
                lvl = torch.minimum(levels4[:, a], levels4[:, b])
                feat = mip.sample_mip(
                    self.planes[mi * len(COMBS) + ci], coords4[:, [a, b]],
                    lvl, SPATIAL_MAX_MIP if spatio_only else 0)
                acc = feat if acc is None else acc + feat
            outs.append(acc)
        return torch.cat(outs, dim=-1)


def _scales(planes):
    """The flat plane list as one group of len(COMBS) planes per multires
    scale."""
    k = len(COMBS)
    return [planes[i:i + k] for i in range(0, len(planes), k)]


def plane_tv(planes) -> torch.Tensor:
    """Total variation over the spatial planes (hexplane.py:147-153,
    311-318); ``planes`` is ``HexPlaneField.planes``."""
    total = 0.0
    for group in _scales(planes):
        for idx in TV_PLANES:
            t = group[idx]                       # [C, H, W]
            c, h, w = t.shape
            count_h = c * (h - 1) * w
            count_w = c * h * (w - 1)
            h_tv = torch.square(t[:, 1:, :] - t[:, :h - 1, :]).sum()
            w_tv = torch.square(t[:, :, 1:] - t[:, :, :w - 1]).sum()
            total = total + 2 * (h_tv / count_h + w_tv / count_w)
    return total


def time_smoothness(planes) -> torch.Tensor:
    """Second-difference smoothness along rows (hexplane.py:139-145,
    320-326), over the reference's plane index set as it is."""
    total = 0.0
    for group in _scales(planes):
        for idx in TIMESMOOTH_PLANES:
            t = group[idx]
            h = t.shape[1]
            first = t[:, 1:, :] - t[:, :h - 1, :]
            second = first[:, 1:, :] - first[:, :h - 2, :]
            total = total + torch.square(second).mean()
    return total
