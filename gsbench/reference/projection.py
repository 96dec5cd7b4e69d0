"""The benchmark's frozen copy of saro_gs_torch/ops/projection.py, plain
PyTorch, part of the reference that decides `correct`; it imports
nothing of the program.  The original's docstring follows.

Per-Gaussian rasterization preprocess (counterpart of ops/projection.py).

Frustum cull, projection, 3D->2D covariance, conic, screen radius, tile
rects and SH colour for N Gaussians and one camera (``preprocessCUDA``,
forward.cu:155-256), as elementwise passes over 1-D [N] columns.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import math3d, sh


class CameraParams(NamedTuple):
    """Per-view parameters as tensors on the render device."""
    viewmat: torch.Tensor   # [4,4] row-vector world->view
    projmat: torch.Tensor   # [4,4] row-vector world->NDC (full view-proj)
    campos: torch.Tensor    # [3]
    tanfovx: torch.Tensor   # 0-d
    tanfovy: torch.Tensor   # 0-d


class PreprocessOut(NamedTuple):
    depth: torch.Tensor       # [N] view-space z
    radii: torch.Tensor       # [N] int32, 0 for culled
    mean_x: torch.Tensor      # [N] pixel coordinates
    mean_y: torch.Tensor
    conic_a: torch.Tensor     # [N] inverse 2D covariance (a, b, c)
    conic_b: torch.Tensor
    conic_c: torch.Tensor
    rgb: torch.Tensor         # [N, 3]
    clamped: torch.Tensor     # [N, 3] bool, SH colour clamp mask
    rmin_x: torch.Tensor      # [N] int32 tile rect, max exclusive
    rmin_y: torch.Tensor
    rmax_x: torch.Tensor
    rmax_y: torch.Tensor
    tiles_touched: torch.Tensor  # [N] int32, 0 for culled
    mask: torch.Tensor        # [N] bool: survives culling


def mark_visible(means3d: torch.Tensor, cam: CameraParams) -> torch.Tensor:
    """Whether each point is in front of the near cull, view-space
    z > 0.2 (``markVisible``, rasterize_points.cu:196-215)."""
    p_view = math3d.transform_point_4x3(means3d, cam.viewmat)
    return p_view[..., 2] > math3d.NEAR_CULL_Z


def get_rect_cols(p_x, p_y, radius, grid_x: int, grid_y: int,
                  tile_x: int, tile_y: int, radius_y=None):
    """Tile rectangle (min_x, min_y, max_x, max_y) int32 columns covered by
    a splat (auxiliary.h:46-56), optionally with distinct per-axis radii."""
    r = radius.to(p_x.dtype)
    ry = r if radius_y is None else radius_y.to(p_x.dtype)
    if radius_y is None:
        # the reference formula verbatim: its `(p+r+B-1)/B` ceiling can
        # exclude a boundary tile for fractional p
        max_x = torch.floor((p_x + r + tile_x - 1) / tile_x)
        max_y = torch.floor((p_y + ry + tile_y - 1) / tile_y)
    else:
        # exact coverage: the last tile holding a pixel <= p + r
        max_x = torch.floor((p_x + r) / tile_x) + 1
        max_y = torch.floor((p_y + ry) / tile_y) + 1
    i32 = torch.int32
    min_x = torch.clamp(torch.floor((p_x - r) / tile_x), 0, grid_x).to(i32)
    min_y = torch.clamp(torch.floor((p_y - ry) / tile_y), 0, grid_y).to(i32)
    max_x = torch.clamp(max_x, 0, grid_x).to(i32)
    max_y = torch.clamp(max_y, 0, grid_y).to(i32)
    return min_x, min_y, max_x, max_y


def preprocess(means3d: torch.Tensor,
               scales: torch.Tensor,
               quats: torch.Tensor,
               opacities: torch.Tensor,
               cam: CameraParams,
               width: int,
               height: int,
               tile_x: int,
               tile_y: int,
               sh_degree: int = 0,
               shs: Optional[torch.Tensor] = None,
               colors_precomp: Optional[torch.Tensor] = None,
               scale_modifier: float = 1.0,
               active: Optional[torch.Tensor] = None,
               tight_rect: bool = False) -> PreprocessOut:
    """Preprocess N Gaussians for one camera; ``active`` masks out slots
    (treated as culled)."""
    dt = means3d.dtype
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y

    mt = means3d.to(dt).T
    px, py, pz = mt[0], mt[1], mt[2]
    st = scales.to(dt).T
    qt = quats.to(dt).T

    vm = cam.viewmat
    depth = px * vm[0, 2] + py * vm[1, 2] + pz * vm[2, 2] + vm[3, 2]
    in_front = depth > math3d.NEAR_CULL_Z       # auxiliary.h:154 culls z<=0.2

    ndc_x, ndc_y, _ = math3d.project_points_cols(px, py, pz, cam.projmat)

    cov6 = math3d.build_cov3d_cols(st[0], st[1], st[2], scale_modifier,
                                   qt[0], qt[1], qt[2], qt[3])
    # a true division, as in the JAX package (`int / tensor` would compute
    # reciprocal * int and round differently)
    focal_x = cam.tanfovx.new_tensor(float(width)) / (2.0 * cam.tanfovx)
    focal_y = cam.tanfovy.new_tensor(float(height)) / (2.0 * cam.tanfovy)
    a, b, c = math3d.compute_cov2d_cols(px, py, pz, focal_x, focal_y,
                                        cam.tanfovx, cam.tanfovy, cov6,
                                        cam.viewmat)
    det = a * c - b * b
    det_ok = det != 0.0
    one = torch.ones_like(det)
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, one),
                          torch.zeros_like(det))
    conic_a = c * det_inv
    conic_b = -b * det_inv
    conic_c = a * det_inv

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam_max = torch.maximum(mid + disc, mid - disc)
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

    mean_x = math3d.ndc2pix(ndc_x, width)
    mean_y = math3d.ndc2pix(ndc_y, height)
    if tight_rect:
        # per-axis extents of the alpha >= 1/255 level set (the
        # compositor's cutoff), |x| <= sqrt(2 ln(255 o) Sigma_xx),
        # intersected with the reference's 3-sigma rect: a subset of its
        # tiles with identical rendered output
        s = 2.0 * torch.log(torch.clamp_min(opacities.reshape(-1), 1e-30)
                            * 255.0)
        s = torch.clamp_min(s, 0.0)
        rx = torch.minimum(radius_f, torch.ceil(
            torch.sqrt(s * torch.clamp_min(a, 0.0))))
        ry = torch.minimum(radius_f, torch.ceil(
            torch.sqrt(s * torch.clamp_min(c, 0.0))))
        tmin_x, tmin_y, tmax_x, tmax_y = get_rect_cols(
            mean_x, mean_y, rx, grid_x, grid_y, tile_x, tile_y, radius_y=ry)
        rmin_x_, rmin_y_, rmax_x_, rmax_y_ = get_rect_cols(
            mean_x, mean_y, radius_f, grid_x, grid_y, tile_x, tile_y)
        rmin_x = torch.maximum(tmin_x, rmin_x_)
        rmin_y = torch.maximum(tmin_y, rmin_y_)
        rmax_x = torch.maximum(torch.minimum(tmax_x, rmax_x_), rmin_x)
        rmax_y = torch.maximum(torch.minimum(tmax_y, rmax_y_), rmin_y)
    else:
        rmin_x, rmin_y, rmax_x, rmax_y = get_rect_cols(
            mean_x, mean_y, radius_f, grid_x, grid_y, tile_x, tile_y)
    tiles = ((rmax_y - rmin_y) * (rmax_x - rmin_x)).to(torch.int32)

    # a non-finite covariance or position culls like a frustum cull: int
    # casts of NaN rects would give garbage tile ids
    finite = (torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
              & torch.isfinite(mean_x) & torch.isfinite(mean_y))
    mask = in_front & det_ok & finite & (tiles > 0)
    if active is not None:
        mask = mask & (active > 0)

    if colors_precomp is not None:
        rgb = colors_precomp.to(dt)
        clamped = torch.zeros(rgb.shape, dtype=torch.bool, device=rgb.device)
    else:
        if shs is None:
            raise ValueError("preprocess needs shs or colors_precomp")
        rgb, clamped = sh.eval_sh_color_cols(sh_degree, shs.to(dt), px, py,
                                             pz, cam.campos)

    # degenerate-payload cull: a splat whose composited attributes (colour,
    # opacity, depth) are non-finite would poison every pixel it touches
    op_col = opacities.to(dt).reshape(-1)
    mask = (mask & torch.isfinite(depth) & torch.isfinite(op_col)
            & torch.isfinite(rgb).all(dim=1))

    radii = torch.where(mask, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    tiles = torch.where(mask, tiles, torch.zeros_like(tiles))
    return PreprocessOut(
        depth=depth, radii=radii, mean_x=mean_x, mean_y=mean_y,
        conic_a=conic_a, conic_b=conic_b, conic_c=conic_c,
        rgb=rgb, clamped=clamped,
        rmin_x=rmin_x, rmin_y=rmin_y, rmax_x=rmax_x, rmax_y=rmax_y,
        tiles_touched=tiles, mask=mask)
