"""Renderer glue: camera + model state -> rasterized images (counterpart
of render.py).

``train_render`` dispatches on the stage (the static stage renders the
canonical activations, the dynamic stage runs the deformation) and is
differentiable.  ``test_render`` is the eval render: it reuses cached
field features and drops dying Gaussians through an
``active`` mask (state > 1e-3, the reference's pre-filter at
saro_gaussian.py:878-881; they contribute alpha < 1/255 anyway, so the
image is unchanged).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import timing
from .models import gaussians as gm
from .models.field import FieldStatic
from .ops.projection import CameraParams
from .ops.rasterize import RasterConfig, RenderOutput, rasterize

EVAL_STATE_CUTOFF = 1e-3


class RenderPackage(NamedTuple):
    out: RenderOutput
    deform: Optional[gm.DeformOut]   # None in the static stage


def train_render(cam: CameraParams, timestamp,
                 params: gm.GaussianParams, nets: gm.DeformNets,
                 alive: torch.Tensor, mcfg: gm.ModelConfig,
                 fstatic: FieldStatic, bg: torch.Tensor, *,
                 width: int, height: int, stage: str, sh_degree: int,
                 rcfg: RasterConfig,
                 mean2d_dummy: Optional[torch.Tensor] = None,
                 feat: Optional[torch.Tensor] = None,
                 sh_mask: Optional[torch.Tensor] = None,
                 row0: int = 0) -> RenderPackage:
    """Training render of one view (renderer/__init__.py:35-138).

    ``stage`` "dynamatic" deforms the points at ``timestamp`` (``feat``:
    the field features, sampled once per step and shared by the views);
    any other stage renders the canonical activations.  ``sh_mask``
    ([16, 1] float) zeroes the SH coefficients above the active degree:
    the same colours and gradients as the degree-truncated sum.  ``row0``:
    the strip's first tile row, with ``rcfg.strip_rows`` (strip mode)."""
    def msk(shs):
        return shs if sh_mask is None else shs * sh_mask
    if stage == "dynamatic":
        d = gm.deform(params, nets, mcfg, fstatic, timestamp, feat=feat,
                      with_residuals=True)
        timing.mark("deform")
        out = rasterize(d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1),
                        cam, bg, width=width, height=height,
                        sh_degree=sh_degree, config=rcfg, shs=msk(d.shs),
                        mean2d_dummy=mean2d_dummy, active=alive, row0=row0)
        return RenderPackage(out=out, deform=d)
    out = rasterize(params.xyz, gm.get_scaling(params),
                    gm.get_rotation(params),
                    gm.get_opacity(params).reshape(-1), cam, bg,
                    width=width, height=height, sh_degree=sh_degree,
                    config=rcfg, shs=msk(gm.get_features(params)),
                    mean2d_dummy=mean2d_dummy, active=alive, row0=row0)
    return RenderPackage(out=out, deform=None)


@torch.no_grad()
def test_render(cam: CameraParams, timestamp,
                params: gm.GaussianParams, nets: gm.DeformNets,
                alive: torch.Tensor, mcfg: gm.ModelConfig,
                fstatic: FieldStatic, bg: torch.Tensor, *,
                width: int, height: int, sh_degree: int,
                rcfg: RasterConfig,
                feat: Optional[torch.Tensor] = None,
                require_segment: bool = False, row0: int = 0):
    """Eval-path render at ``timestamp``; ``feat`` is the field feature
    tensor cached per checkpoint (gm.field_feat).  Returns
    (RenderOutput, segment RenderOutput or None); the segment render
    shows each Gaussian's lifespan as its colour.  ``row0`` as in
    ``train_render``."""
    with timing.unit("test_render"):
        with timing.span("deform"):
            d = gm.deform(params, nets, mcfg, fstatic, timestamp, feat=feat)
            active = alive * (d.state[:, 0] > EVAL_STATE_CUTOFF)
        # forward-only render: skip n_contrib
        rcfg = rcfg._replace(need_aux=False)
        out = rasterize(d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1),
                        cam, bg, width=width, height=height,
                        sh_degree=sh_degree, config=rcfg, shs=d.shs,
                        active=active, row0=row0)
        seg: Optional[RenderOutput] = None
        if require_segment:
            lifespan_rgb = d.lifespan.expand(-1, 3)
            seg = rasterize(d.xyz, d.scaling, d.rotation,
                            d.opacity.reshape(-1), cam, bg, width=width,
                            height=height, sh_degree=sh_degree, config=rcfg,
                            colors_precomp=lifespan_rgb, active=active,
                            row0=row0)
    return out, seg
