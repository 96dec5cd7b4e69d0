"""Differentiable tile-based Gaussian rasterizer (counterpart of
ops/rasterize.py).

preprocess -> staged binning (kernel K2 + sort) -> forward compositor
(kernel K1), with the reference rasterizer's forward numerics: w-epsilon
1e-7, +0.3 cov2d low-pass and 1.3*tanfov clamp, radius =
ceil(3 sqrt(max lambda)) with the 0.1 floor, alpha clamp 0.99, 1/255
cutoff, T < 1e-4 termination latch, median depth with 15.0 default,
un-normalized quaternion covariance.

The whole pipeline is one ``torch.autograd.Function``.  Its backward is
the reference's chain (backward.cu), not the derivative of the port's
preprocess, which autograd never sees:

  * the backward compositor (kernel K3) gives per-instance gradients,
    summed per Gaussian in a fixed order (``binning.reduce_instances``);
  * conic -> cov2d with the reference's eps'd denominator
    1 / (det^2 + 1e-7) (backward.cu:201-212);
  * cov2d -> (mean, scale, quaternion), the projection and the SH colour
    are differentiated as small pure functions at ``means_safe`` (culled
    points are moved one unit in front of the camera so nothing divides
    by ~0), the SH clamp gated by the mask saved in the forward;
  * the 0.99 alpha clamp is not gated, quaternion gradients pass through
    un-normalized, the depth output has no backward;
  * every output is zero for culled points (by select, so an overflowed
    primal of a culled point cannot leak a NaN);
  * ``mean2d_dummy`` receives the NDC screen-space gradients that
    densification reads, like the reference's retained screenspace points.

Strip mode (``RasterConfig.strip_rows`` and ``row0``, for the tile-axis
sharding of parallel/shard.py): the render covers ``strip_rows`` tile rows
from global tile row ``row0``.  The preprocess is the full frame's; the
rects are clipped to the strip and rebased (``_clip_to_strip``), the
binning is strip-local, the outputs are the strip's
``strip_rows * tile_y`` rows, uncropped, while pixel coordinates, the
radii and the NDC scale of the screen-space gradients stay the full
frame's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import timing
from . import binning, math3d, projection, sh, tile_kernels
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
    # False skips the n_contrib output (only the backward replay needs it);
    # such a render is forward-only
    need_aux: bool = True
    # strip mode: render only this many tile rows, from the ``row0`` given
    # to ``rasterize``; 0 renders the whole frame
    strip_rows: int = 0


class RenderOutput(NamedTuple):
    color: torch.Tensor       # [3, H, W] (a strip: [3, strip_rows*tile_y, W])
    depth: torch.Tensor       # [H, W]
    radii: torch.Tensor       # [N] int32, the full frame's
    final_t: torch.Tensor     # [H, W]
    n_contrib: torch.Tensor   # [H, W] int32
    num_dropped: int          # instances beyond capacity
    num_instances: int        # instances emitted


def _conic_to_cov2d_grads(a, b, c, ga, gb, gc):
    """dL/dconic -> dL/dcov2d with the reference's eps'd denominator
    (backward.cu:201-212); ``gb`` is the true b-gradient, so the
    reference's compensating factors of 2 become the exact coefficients."""
    denom = a * c - b * b
    denom2inv = 1.0 / (denom * denom + 1e-7)
    d_a = denom2inv * (-c * c * ga + b * c * gb + (denom - a * c) * gc)
    d_c = denom2inv * (-a * a * gc + a * b * gb + (denom - a * c) * ga)
    d_b = denom2inv * (2 * b * c * ga - (denom + 2 * b * b) * gb
                       + 2 * a * b * gc)
    return d_a, d_b, d_c


def _clip_to_strip(pre: projection.PreprocessOut, row0: int,
                   rows_local: int) -> projection.PreprocessOut:
    """A full-frame preprocess restricted to tile rows [row0, row0 +
    rows_local), its rect rows rebased to the strip; a Gaussian with no
    tile in the strip is masked out (saro_gs_tpu/ops/rasterize.py:93-106).
    """
    rmin_y = torch.clamp(pre.rmin_y - row0, 0, rows_local)
    rmax_y = torch.clamp(pre.rmax_y - row0, 0, rows_local)
    tiles = ((rmax_y - rmin_y) * (pre.rmax_x - pre.rmin_x)).to(torch.int32)
    mask = pre.mask & (tiles > 0)
    return pre._replace(rmin_y=rmin_y, rmax_y=rmax_y,
                        tiles_touched=torch.where(mask, tiles,
                                                  torch.zeros_like(tiles)),
                        mask=mask)


class _Rasterize(torch.autograd.Function):
    """forward(means3d, scales, quats, opacities, shs, colors_precomp,
    mean2d_dummy, cam, bg, active, statics, info) ->
    (color, depth, radii, final_t, n_contrib); statics = (width, height,
    sh_degree, config, row0); ``info`` (a dict) receives num_dropped and
    num_instances."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, opacities, shs, colors_precomp,
                mean2d_dummy, cam, bg, active, statics, info):
        width, height, sh_degree, cfg, row0 = statics
        pre = projection.preprocess(
            means3d, scales, quats, opacities, cam, width, height,
            cfg.tile_x, cfg.tile_y, sh_degree=sh_degree, shs=shs,
            colors_precomp=colors_precomp, active=active,
            tight_rect=cfg.tight_rect)
        timing.mark("preprocess")
        grid_x = (width + cfg.tile_x - 1) // cfg.tile_x
        if cfg.strip_rows > 0:
            pre = _clip_to_strip(pre, row0, cfg.strip_rows)
            grid_y = cfg.strip_rows
        else:
            grid_y = (height + cfg.tile_y - 1) // cfg.tile_y
        bins = binning.bin_gaussians_staged(
            pre, opacities.reshape(-1), grid_x, grid_y, cfg.max_instances,
            cfg.tile_x, cfg.tile_y, corner_cull=cfg.tight_rect,
            y0_tiles=row0)
        timing.mark("binning")
        timing.count("instances", bins.num_instances)
        bg = bg.to(torch.float32).contiguous()
        fwd = tile_kernels.forward_tiles(
            bins.attr, bins.tile_start, bins.tile_count, bg, width, height,
            cfg.tile_x, cfg.tile_y, cfg.chunk, need_aux=cfg.need_aux,
            tile_order=bins.tile_order, grid_y_local=cfg.strip_rows,
            y0_tiles=row0)
        timing.mark("K1_forward")
        info["num_dropped"] = bins.num_dropped
        info["num_instances"] = bins.num_instances
        ctx.statics = statics
        ctx.cam = cam
        ctx.bg = bg
        ctx.has_shs = colors_precomp is None
        ctx.save_for_backward(
            means3d, scales, quats, opacities,
            shs if colors_precomp is None else colors_precomp,
            pre.mask, pre.clamped, bins.attr, bins.tile_start,
            bins.tile_count, bins.perm, bins.tiles, bins.tile_order,
            fwd.color, fwd.final_t, fwd.n_contrib)
        ctx.mark_non_differentiable(fwd.depth, pre.radii, fwd.final_t,
                                    fwd.n_contrib)
        return fwd.color, fwd.depth, pre.radii, fwd.final_t, fwd.n_contrib

    @staticmethod
    def backward(ctx, d_color, *_):
        width, height, sh_degree, cfg, row0 = ctx.statics
        cam = ctx.cam
        (means3d, scales, quats, opacities, colour_in, mask, clamped, attr,
         tile_start, tile_count, perm, tiles, tile_order, color, final_t,
         n_contrib) = ctx.saved_tensors
        dt = means3d.dtype
        timing.mark("loss_backward")

        g9 = tile_kernels.backward_tiles(
            attr, tile_start, tile_count, ctx.bg, n_contrib, color, final_t,
            d_color.to(torch.float32).contiguous(), width, height,
            cfg.tile_x, cfg.tile_y, tile_order=tile_order,
            grid_y_local=cfg.strip_rows, y0_tiles=row0)           # [9, L]
        timing.mark("K3_backward")
        summed = binning.reduce_instances(g9, perm, tiles).to(dt)  # [N, 9]

        def gate(x):
            m = mask.reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.where(m, x, torch.zeros_like(x))

        d_rgb = gate(summed[:, 0:3])
        d_mean2d = gate(summed[:, 3:5])           # NDC-space gradients
        d_conic = summed[:, 5:8]
        d_opac = gate(summed[:, 8])

        # safe primal for culled points: one unit in front of the camera,
        # so the recomputation below never divides by ~0 view-z
        safe_mean = cam.campos + cam.viewmat[:3, 2]
        means_safe = torch.where(mask[:, None], means3d, safe_mean.to(dt))
        focal_x = cam.tanfovx.new_tensor(float(width)) / (2.0 * cam.tanfovx)
        focal_y = cam.tanfovy.new_tensor(float(height)) / (2.0 * cam.tanfovy)

        with torch.enable_grad():
            m = means_safe.detach().requires_grad_()
            s = scales.detach().to(dt).requires_grad_()
            q = quats.detach().to(dt).requires_grad_()
            px, py, pz = m[:, 0], m[:, 1], m[:, 2]
            cov6 = math3d.build_cov3d_cols(s[:, 0], s[:, 1], s[:, 2], 1.0,
                                           q[:, 0], q[:, 1], q[:, 2],
                                           q[:, 3])
            a, b, c = math3d.compute_cov2d_cols(
                px, py, pz, focal_x, focal_y, cam.tanfovx, cam.tanfovy,
                cov6, cam.viewmat)
            ndc_x, ndc_y, _ = math3d.project_points_cols(px, py, pz,
                                                         cam.projmat)
            outs = [a, b, c, ndc_x, ndc_y]
            inputs = [m, s, q]
            with torch.no_grad():
                d_cov = _conic_to_cov2d_grads(a, b, c, d_conic[:, 0],
                                              d_conic[:, 1], d_conic[:, 2])
                cots = [gate(g) for g in d_cov] + [d_mean2d[:, 0],
                                                   d_mean2d[:, 1]]
            if ctx.has_shs:
                sh_leaf = colour_in.detach().to(dt).requires_grad_()
                raw = sh.sh_raw_cols(sh_degree, sh_leaf, px, py, pz,
                                     cam.campos)
                # the clamp's gradient gate, from the forward's mask
                outs.append(torch.where(clamped, torch.zeros_like(raw),
                                        raw))
                cots.append(d_rgb)
                inputs.append(sh_leaf)
            grads = torch.autograd.grad(outs, inputs, cots,
                                        allow_unused=True)

        def take(g, like):
            if g is None:
                return torch.zeros_like(like)
            return gate(g).to(like.dtype)

        d_means = take(grads[0], means3d)
        d_scales = take(grads[1], scales)
        d_quats = take(grads[2], quats)
        d_shs = d_precomp = None
        if ctx.has_shs:
            d_shs = take(grads[3], colour_in)
        else:
            d_precomp = d_rgb.to(colour_in.dtype)
        timing.mark("reduce_preprocess_backward")
        return (d_means, d_scales, d_quats,
                d_opac.reshape(opacities.shape).to(opacities.dtype), d_shs,
                d_precomp, d_mean2d, None, None, None, None, None)


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
              mean2d_dummy: Optional[torch.Tensor] = None,
              active: Optional[torch.Tensor] = None,
              row0: int = 0) -> RenderOutput:
    """Render N Gaussians to one image on their device.

    Differentiable in means3d, scales, quats, opacities and shs or
    colors_precomp; ``mean2d_dummy`` ([N, 2] zeros) receives the NDC
    screen-space gradients.  With ``config.need_aux=False`` the render is
    forward-only: call it under ``torch.no_grad()`` or on detached
    tensors.  With ``config.strip_rows`` > 0 it renders that many tile
    rows from global tile row ``row0`` (module docstring)."""
    if row0 and config.strip_rows <= 0:
        raise ValueError(f"row0 {row0} needs RasterConfig.strip_rows > 0")
    diff = (means3d, scales, quats, opacities, shs, colors_precomp,
            mean2d_dummy)
    if torch.is_grad_enabled() and not config.need_aux and any(
            t is not None and t.requires_grad for t in diff):
        raise RuntimeError(
            "RasterConfig(need_aux=False) renders are forward-only (the "
            "backward replay needs n_contrib): call rasterize under "
            "torch.no_grad() or on detached tensors")
    if mean2d_dummy is None:
        mean2d_dummy = torch.zeros((means3d.shape[0], 2),
                                   dtype=torch.float32,
                                   device=means3d.device)
    statics = (int(width), int(height), int(sh_degree), config, int(row0))
    info = {}
    color, depth, radii, final_t, n_contrib = _Rasterize.apply(
        means3d, scales, quats, opacities, shs, colors_precomp,
        mean2d_dummy, cam, bg, active, statics, info)
    return RenderOutput(color=color, depth=depth, radii=radii,
                        final_t=final_t, n_contrib=n_contrib,
                        num_dropped=info["num_dropped"],
                        num_instances=info["num_instances"])
