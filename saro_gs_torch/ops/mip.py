"""Mip-pyramid 2D texture sampling (counterpart of ops/mip.py).

Replaces the reference's nvdiffrast ``texture(..., mip_level_bias=levels,
boundary_mode="clamp")`` call (scene/hexplane.py:49-56):

  * texture coordinates in [0, 1], texel centres at (i + 0.5) / res,
  * clamp boundary mode,
  * trilinear filtering (bilinear within a level, linear between levels),
  * levels built by 2x2 box downsampling of the base, rebuilt every call.

The pyramid is flattened into one [total, C] table so each sample gathers
4 texels at each of its 2 bracketing levels.

``sample_mip`` is a ``torch.autograd.Function``.  Its backward gives the
grid gradient only: each bracketing level's taps are scattered into the
flattened pyramid by ``grid_scatter.scatter_mip_taps`` (kernel K4 on the
card, both brackets in one call, deterministic), and the pyramid's
cotangent is carried down the 2x2 mean-pool chain to the base.
``coords`` and ``level`` get no gradient: the reference detaches every
field input before sampling (saro_gaussian.py:780).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from . import grid_scatter

# the clamp of the gathers, shared with the backward's taps
_at_most = grid_scatter._at_most


def max_mip_levels(h: int, w: int, cap: int) -> int:
    """Number of levels above the base that can be built (level n has
    resolution res >> n), at most ``cap``."""
    n = 0
    while n < cap and (h >> (n + 1)) >= 1 and (w >> (n + 1)) >= 1 \
            and (h >> n) % 2 == 0 and (w >> n) % 2 == 0:
        n += 1
    return n


def build_pyramid(grid: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """[C, H, W] -> list of num_levels+1 grids (level 0 = input)."""
    levels = [grid]
    g = grid
    for _ in range(num_levels):
        c, h, w = g.shape
        g = g.reshape(c, h // 2, 2, w // 2, 2).mean(dim=(2, 4))
        levels.append(g)
    return levels


def _bilinear_taps(flat, u, v, w_l, h_l, base):
    """Bilinear sample of one level of the flattened [total, C] pyramid.
    ``w_l``/``h_l``/``base`` are python ints or per-point int tensors."""
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


def _sample_mip_impl(grid: torch.Tensor, coords: torch.Tensor,
                     level: torch.Tensor, max_level: int) -> torch.Tensor:
    """The gathers of ``sample_mip``; autograd through them is the oracle
    of its custom backward."""
    u, v = coords[:, 0], coords[:, 1]
    c, h, w = grid.shape
    n_levels = max_mip_levels(h, w, max_level)
    if n_levels == 0:
        return _bilinear_taps(grid.reshape(c, -1).T, u, v, w, h, 0)
    level = torch.clamp(level.to(torch.float32), 0.0, float(n_levels))
    pyr = build_pyramid(grid, n_levels)
    flat = torch.cat([p.reshape(c, -1) for p in pyr], dim=1).T
    offs = np.cumsum([0] + [int(p.shape[1] * p.shape[2]) for p in pyr])
    offs = torch.as_tensor(offs[:-1], dtype=torch.int64, device=grid.device)

    l0 = torch.clamp(torch.floor(level).to(torch.int64), 0, n_levels)
    l1 = torch.clamp(l0 + 1, 0, n_levels)
    frac = level - l0

    def samp(l):
        w_l = torch.bitwise_right_shift(torch.full_like(l, w), l)
        h_l = torch.bitwise_right_shift(torch.full_like(l, h), l)
        return _bilinear_taps(flat, u, v, w_l, h_l, offs[l])

    s0 = samp(l0)
    s1 = samp(l1)
    return s0 * (1 - frac)[:, None] + s1 * frac[:, None]


def _grid_grad(shape, coords, level, max_level: int,
               dfeat: torch.Tensor) -> torch.Tensor:
    """dL/dgrid [C, H, W] from dL/dsample [N, C]
    (saro_gs_tpu/ops/mip.py:_sample_mip_bwd)."""
    c, h, w = shape
    n_levels = max_mip_levels(h, w, max_level)
    # both brackets' taps in one call (kernel K4 on the card)
    d_flat = grid_scatter.scatter_mip_taps(
        coords.contiguous(),
        level.to(torch.float32).contiguous() if n_levels else None,
        dfeat.to(torch.float32), h, w, n_levels)            # [C, total]
    if n_levels == 0:
        return d_flat.reshape(c, h, w)
    sizes, offs_np = grid_scatter.level_sizes(h, w, n_levels)
    # transpose of flatten(build_pyramid): carry each level's cotangent
    # down the 2x2 mean-pool chain (a factor 1/4 per level)
    d = None
    for l in reversed(range(n_levels + 1)):
        hl, wl = sizes[l]
        seg = d_flat[:, int(offs_np[l]):int(offs_np[l]) + hl * wl].reshape(
            c, hl, wl)
        if d is None:
            d = seg
        else:
            d = seg + 0.25 * d.repeat_interleave(2, dim=1).repeat_interleave(
                2, dim=2)
    return d


class _SampleMip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, coords, level, max_level):
        ctx.save_for_backward(coords, level)
        ctx.grid_shape = tuple(grid.shape)
        ctx.grid_dtype = grid.dtype
        ctx.max_level = max_level
        return _sample_mip_impl(grid, coords, level, max_level)

    @staticmethod
    def backward(ctx, dfeat):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        coords, level = ctx.saved_tensors
        d = _grid_grad(ctx.grid_shape, coords, level, ctx.max_level, dfeat)
        return d.to(ctx.grid_dtype), None, None, None


def sample_mip(grid: torch.Tensor, coords: torch.Tensor, level: torch.Tensor,
               max_level: int) -> torch.Tensor:
    """Mip-biased trilinear sample.

    grid [C, H, W]; coords [N, 2] in [0, 1] with coords[:, 0] along W;
    level [N] fractional mip level (clamped to the levels built);
    max_level caps the pyramid depth (0 = plain bilinear, the time planes).
    Returns [N, C].  Only ``grid`` receives a gradient (see the module
    docstring)."""
    return _SampleMip.apply(grid, coords, level, max_level)
