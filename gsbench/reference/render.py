"""The reference renderer: preprocess, binning and tile compositing of one
view, plain PyTorch; part of the benchmark's reference (no import of the
program).

``render`` is the eval render (forward only).  ``render_train`` is
differentiable: autograd runs through the preprocess (projection, 2D
covariance, conic, SH colour), and the compositor is a
``torch.autograd.Function`` whose backward is the plain backward
compositor (``compositing.backward_tiles``) with each instance's
gradient summed into its Gaussian by ``index_add_``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import binning, compositing, projection


class Camera(NamedTuple):
    viewmat: torch.Tensor
    projmat: torch.Tensor
    campos: torch.Tensor
    tanfovx: torch.Tensor
    tanfovy: torch.Tensor


class Frame(NamedTuple):
    color: torch.Tensor      # [3, H, W]
    n_contrib: torch.Tensor  # [H, W] int32
    n_walked: torch.Tensor   # [H, W] int32: pairs each pixel evaluated
    instances: int           # emitted before the corner cull
    valid: int               # kept by the corner cull
    bins: binning.Bins
    final_t: torch.Tensor


def _preprocess(d, cam: Camera, active, width, height, tile, sh_degree):
    return projection.preprocess(
        d.xyz, d.scaling, d.rotation, d.opacity.reshape(-1), cam, width,
        height, tile, tile, sh_degree=sh_degree, shs=d.shs, active=active,
        tight_rect=True)


def _composite(bins, bg, width, height, tile):
    return compositing.forward_tiles(bins.attr, bins.tile_start,
                                     bins.tile_count, bg, width, height,
                                     tile, tile, need_aux=True)


@torch.no_grad()
def render(d, cam: Camera, active, bg, width: int, height: int, tile: int,
           sh_degree: int) -> Frame:
    """Forward render of the deformed Gaussians ``d`` (model.Deformed)."""
    pre = _preprocess(d, cam, active, width, height, tile, sh_degree)
    grid_x = (width + tile - 1) // tile
    grid_y = (height + tile - 1) // tile
    bins = binning.bin_gaussians(pre, binning.payload(pre, d.opacity),
                                 grid_x, grid_y, tile, tile)
    out = _composite(bins, bg.to(torch.float32), width, height, tile)
    return Frame(color=out.color, n_contrib=out.n_contrib,
                 n_walked=out.n_walked, instances=bins.total,
                 valid=int(bins.tile_count.sum()), bins=bins,
                 final_t=out.final_t)


class _Compositor(torch.autograd.Function):
    """gattr [10, N] (x, y, conic a/b/c, opacity, rgb, depth) ->
    colour [3, H, W]."""

    @staticmethod
    def forward(ctx, gattr, pre, bg, width, height, tile):
        grid_x = (width + tile - 1) // tile
        grid_y = (height + tile - 1) // tile
        bins = binning.bin_gaussians(pre, gattr.detach(), grid_x, grid_y,
                                     tile, tile)
        out = _composite(bins, bg, width, height, tile)
        ctx.geom = (width, height, tile, gattr.shape[1])
        ctx.save_for_backward(bins.attr, bins.gid, bins.tile_start,
                              bins.tile_count, bg, out.n_contrib, out.color,
                              out.final_t)
        return out.color

    @staticmethod
    def backward(ctx, d_color):
        (attr, gid, start, count, bg, n_contrib, color,
         final_t) = ctx.saved_tensors
        width, height, tile, n = ctx.geom
        g9 = compositing.backward_tiles(
            attr, start, count, bg, n_contrib, color, final_t,
            d_color.to(torch.float32).contiguous(), width, height, tile,
            tile)
        ok = gid >= 0
        # d_mean2d rows are in NDC units (pixel gradient x half the size)
        rows = torch.stack([g9[3] / (0.5 * width), g9[4] / (0.5 * height),
                            g9[5], g9[6], g9[7], g9[8], g9[0], g9[1],
                            g9[2], torch.zeros_like(g9[0])])
        d_gattr = torch.zeros((10, n), dtype=torch.float32,
                              device=attr.device)
        d_gattr.index_add_(1, gid[ok], rows[:, ok])
        return d_gattr, None, None, None, None, None


def render_train(d, cam: Camera, alive, bg, width: int, height: int,
                 tile: int, sh_degree: int):
    """Differentiable render -> colour [3, H, W]."""
    pre = _preprocess(d, cam, alive, width, height, tile, sh_degree)
    gattr = binning.payload(pre, d.opacity)
    return _Compositor.apply(gattr, pre, bg.to(torch.float32), width,
                             height, tile)
