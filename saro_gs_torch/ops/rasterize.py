"""Tile-based Gaussian rasterizer, forward only (counterpart of
ops/rasterize.py).

preprocess -> staged binning (kernel K2 + sort) -> forward compositor
(kernel K1), with the reference rasterizer's forward numerics: w-epsilon
1e-7, +0.3 cov2d low-pass and 1.3*tanfov clamp, radius =
ceil(3 sqrt(max lambda)) with the 0.1 floor, alpha clamp 0.99, 1/255
cutoff, T < 1e-4 termination latch, median depth with 15.0 default,
un-normalized quaternion covariance.

The backward (a ``torch.autograd.Function`` with the backward compositor
kernel) comes with the training half of the port; until then ``rasterize``
refuses inputs that require gradients.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import binning, projection, tile_kernels
from .projection import CameraParams


class RasterConfig(NamedTuple):
    """Static rasterizer configuration."""
    tile_x: int = 16
    tile_y: int = 16
    # instances staged in the compositor's shared memory per batch
    chunk: int = 64
    max_instances: int = 1 << 18
    # opacity-aware per-axis tile rects and the corner cull: a subset of
    # the reference's 3-sigma tiles with identical rendered output.  False
    # reproduces the reference's instance sets (and n_contrib) exactly.
    tight_rect: bool = True
    # False skips the n_contrib output (only the backward replay needs it)
    need_aux: bool = True


class RenderOutput(NamedTuple):
    color: torch.Tensor       # [3, H, W]
    depth: torch.Tensor       # [H, W]
    radii: torch.Tensor       # [N] int32
    final_t: torch.Tensor     # [H, W]
    n_contrib: torch.Tensor   # [H, W] int32
    num_dropped: int          # instances beyond capacity
    num_instances: int        # instances emitted


def rasterize(means3d: torch.Tensor,
              scales: torch.Tensor,
              quats: torch.Tensor,
              opacities: torch.Tensor,
              cam: CameraParams,
              bg: torch.Tensor,
              *,
              width: int,
              height: int,
              sh_degree: int = 0,
              config: RasterConfig = RasterConfig(),
              shs: Optional[torch.Tensor] = None,
              colors_precomp: Optional[torch.Tensor] = None,
              active: Optional[torch.Tensor] = None) -> RenderOutput:
    """Render N Gaussians to one image on their device (forward only)."""
    for t in (means3d, scales, quats, opacities, shs, colors_precomp):
        if t is not None and t.requires_grad:
            raise RuntimeError(
                "rasterize is forward-only in this port: call it under "
                "torch.no_grad() or on detached tensors")
    cfg = config
    pre = projection.preprocess(
        means3d, scales, quats, opacities, cam, width, height,
        cfg.tile_x, cfg.tile_y, sh_degree=sh_degree, shs=shs,
        colors_precomp=colors_precomp, active=active,
        tight_rect=cfg.tight_rect)
    grid_x = (width + cfg.tile_x - 1) // cfg.tile_x
    grid_y = (height + cfg.tile_y - 1) // cfg.tile_y
    bins = binning.bin_gaussians_staged(
        pre, opacities.reshape(-1), grid_x, grid_y, cfg.max_instances,
        cfg.tile_x, cfg.tile_y, corner_cull=cfg.tight_rect)
    fwd = tile_kernels.forward_tiles(
        bins.attr, bins.tile_start, bins.tile_count,
        bg.to(torch.float32).contiguous(), width, height, cfg.tile_x,
        cfg.tile_y, cfg.chunk, need_aux=cfg.need_aux)
    return RenderOutput(color=fwd.color, depth=fwd.depth, radii=pre.radii,
                        final_t=fwd.final_t, n_contrib=fwd.n_contrib,
                        num_dropped=bins.num_dropped,
                        num_instances=bins.num_instances)
