"""Eval render of a trained model (counterpart of render.test_render).

Reuses cached field features and drops dying Gaussians through an
``active`` mask (state > 1e-3, the reference's pre-filter at
saro_gaussian.py:878-881; they contribute alpha < 1/255 anyway, so the
image is unchanged).
"""
from __future__ import annotations

from typing import Optional

import torch

from .models import gaussians as gm
from .models.field import FieldStatic
from .ops.projection import CameraParams
from .ops.rasterize import RasterConfig, RenderOutput, rasterize

EVAL_STATE_CUTOFF = 1e-3


@torch.no_grad()
def test_render(cam: CameraParams, timestamp,
                params: gm.GaussianParams, nets: gm.DeformNets,
                alive: torch.Tensor, mcfg: gm.ModelConfig,
                fstatic: FieldStatic, bg: torch.Tensor, *,
                width: int, height: int, sh_degree: int,
                rcfg: RasterConfig,
                feat: Optional[torch.Tensor] = None,
                require_segment: bool = False):
    """Eval-path render at ``timestamp``; ``feat`` is the field feature
    tensor cached per checkpoint (gm.field_feat).  Returns
    (RenderOutput, segment RenderOutput or None); the segment render
    shows each Gaussian's lifespan as its colour."""
    d = gm.deform(params, nets, mcfg, fstatic, timestamp, feat=feat)
    active = alive * (d.state[:, 0] > EVAL_STATE_CUTOFF)
    # forward-only render: skip n_contrib
    rcfg = rcfg._replace(need_aux=False)
    out = rasterize(d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1),
                    cam, bg, width=width, height=height,
                    sh_degree=sh_degree, config=rcfg, shs=d.shs,
                    active=active)
    seg: Optional[RenderOutput] = None
    if require_segment:
        lifespan_rgb = d.lifespan.expand(-1, 3)
        seg = rasterize(d.xyz, d.scaling, d.rotation,
                        d.opacity.reshape(-1), cam, bg, width=width,
                        height=height, sh_degree=sh_degree, config=rcfg,
                        colors_precomp=lifespan_rgb, active=active)
    return out, seg
